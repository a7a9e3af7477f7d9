"""
Smoke run of the PyTorch/CUDA port on one CUDA card:

1. environment: torch, CUDA, and the card's name and power limit;
2. build: the integrator kernel (``magicsoup_tpu_torch/csrc/integrate.cu``,
   nvcc) and the genome engine (g++) from the checkout's sources, started
   together;
3. kernel check on seeded inputs: the kernel against its plain PyTorch
   version at the workload's shapes (q = 10240 live rows, s = 28 signals,
   the world's real protein count p) on inputs drawn as
   ``performance/pallas_bisect.py`` draws them, plus the edge cases, under
   the fast contract (finite and >= 0; 99th-percentile relative error
   < 1e-4; maximum < 0.15); then the kernel's median time over 25
   launches (CUDA events), the plain version's, and the byte bound;
4. kernel check on the world's state: the same comparison on the signals
   and parameters that the first workload step hands the integrator, under
   the real-state contract (finite and >= 0; at least 85% of cells within
   1e-4 relative, 98% within 0.01 of their largest value, all within
   0.25): the negative guard drains a signal to 0 up to rounding, and
   the equilibrium correction's quotient takes another branch at 0 than
   at 5e-7, so which cells do follows summation order;
5. workload: ``World(chemistry=Wood-Ljungdahl, map_size=128, seed=42)`` on
   the card, 10,000 random 500-bp genomes, 3 warm-up steps, 120 timed
   steps of the canonical workload step
   (``magicsoup_tpu_torch.workload.sim_step``) with no barrier but one at
   the end of each block of 40 (steps/s), then 10 steps with each phase
   synchronized and timed (seconds per phase); the kernel's launch count
   is set to 0 just before and must show one launch per step; the state
   must stay finite and >= 0.

It prints a ``{"workload": ...}`` line, a ``{"kernels": [...]}`` line, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises, and the run exits
non-zero without that last line.  It needs one card.

    python3 chip_smoke.py
"""
import json
import random
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA's data sheet: HBM rate and the f32 rate outside the
# tensor cores (the kernel's arithmetic is f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

N_CELLS = 10_000
MAP_SIZE = 128
GENOME_SIZE = 500
SEED = 42
WARMUP_STEPS = 3
TIMED_BLOCKS = 3
BLOCK_STEPS = 40
PHASE_STEPS = 10
KERNEL_REPS = 25
PLAIN_REPS = 5


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _environment():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "magicsoup_tpu_torch" / "__init__.py").exists():
        sys.exit(f"chip_smoke: no magicsoup_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(ROOT))
    print(f"torch {torch.__version__}  python {sys.version.split()[0]}")
    print(f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    print(f"card {_card_line()}")
    return torch


def _build():
    from magicsoup_tpu_torch.native import engine
    from magicsoup_tpu_torch.ops import cuda_integrate

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        kernel = pool.submit(cuda_integrate.build)
        genome = pool.submit(engine.get_lib)
        lib_path = kernel.result()
        if genome.result() is None:
            raise RuntimeError("the genome engine did not build")
    print(f"build {time.perf_counter() - t0:.3f} s  ({lib_path.name})")
    print(Path(f"{lib_path}.log").read_text().strip())


def _bisect_inputs(torch, c: int, p: int, s: int, seed: int):
    """Seeded inputs drawn as performance/pallas_bisect.py draws them,
    with the edge cases written into the first tiles."""
    import numpy as np

    from magicsoup_tpu_torch.interop import params_from_numpy

    rng = np.random.default_rng(seed)
    d = dict(
        Ke=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmf=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmb=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmr=rng.uniform(0.1, 10, (c, p, s)).astype(np.float32),
        Vmax=rng.uniform(0, 2, (c, p)).astype(np.float32),
        N=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
        Nf=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        Nb=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        A=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
    )
    X = rng.uniform(0, 4, (c, s)).astype(np.float32)
    X[0] = 0.0  # all-zero signals
    d["A"][1] = 0
    d["A"][1, :, 0] = -2  # absent inhibitor
    X[1, 0] = 0.0
    d["A"][2] = 0
    d["A"][2, :, 0] = 2  # absent activator
    X[2, 0] = 0.0
    for k in d:  # dead rows
        d[k][8:16] = 0
    d["N"][16:24, :, 3] = np.abs(d["N"][16:24, :, 3])  # nothing removed
    return torch.from_numpy(X).cuda(), params_from_numpy(d, "cuda")


def _median_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_check(torch, q: int, p: int, s: int) -> dict:
    import numpy as np

    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    X, params = _bisect_inputs(torch, q, p, s, seed=0)
    out = ci.integrate_signals_cuda(X, params)
    torch.cuda.synchronize()
    ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)
    out_np, ref_np = out.cpu().numpy(), ref.cpu().numpy()
    if not (np.isfinite(out_np).all() and (out_np >= 0).all()):
        raise AssertionError("kernel output is not finite and >= 0")
    rel = np.abs(out_np - ref_np) / (np.abs(ref_np) + 1e-6)
    q99, rel_max = float(np.quantile(rel, 0.99)), float(rel.max())
    if not (q99 < 1e-4 and rel_max < 0.15):
        raise AssertionError(f"kernel vs plain: q99 {q99}, max {rel_max}")
    if not np.array_equal(out_np[8:16], X[8:16].cpu().numpy()):
        raise AssertionError("dead rows changed")

    ms = _median_ms(torch, lambda: ci.integrate_signals_cuda(X, params), KERNEL_REPS)
    plain_ms = _median_ms(
        torch, lambda: ci.integrate_signals_tiled(X, params, ci.TILE_C), PLAIN_REPS
    )
    # least bytes: read X and the nine parameter tensors once, write X1
    n_bytes = q * (16 * p + 12 * p * s + 8 * s)
    # least operations: per trim pass and (cell, protein, signal) the
    # always-run part of the body (the two log-space products, the
    # regulation sum, the negative guard's sum and min, the first signal
    # update) is >= 13 f32 operations; the correction steps come on top
    n_ops = 3 * 13 * q * p * s
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    return {
        "name": "integrate_signals",
        "route": "cuda",
        "source": "magicsoup_tpu_torch/csrc/integrate.cu",
        "replaces": "magicsoup_tpu/ops/pallas_integrate.py:266",
        "shape": {"q": q, "p": p, "s": s},
        "seeded_max_abs_err": float(np.abs(out_np - ref_np).max()),
        "seeded_max_rel_err": rel_max,
        "seeded_q99_rel_err": q99,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "bytes": n_bytes,
    }


def _world_kernel_check(torch, world) -> dict:
    """The kernel against its plain version on the signals and parameters
    that the world's next workload step hands the integrator."""
    import numpy as np

    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    X, params = world.integrator_inputs()
    out = ci.integrate_signals_cuda(X, params)
    ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)
    n = world.n_cells  # rows past n are dead and inert
    out_np, ref_np = out[:n].cpu().numpy(), ref[:n].cpu().numpy()
    if not (np.isfinite(out_np).all() and (out_np >= 0).all()):
        raise AssertionError("kernel output on the world's state is not finite and >= 0")
    rel = np.abs(out_np - ref_np) / (np.abs(ref_np) + 1e-6)
    within = float((rel.max(axis=1) < 1e-4).mean())
    scale = np.maximum(np.abs(ref_np).max(axis=1), 1e-6)
    norm = np.abs(out_np - ref_np).max(axis=1) / scale
    within_1e2 = float((norm < 0.01).mean())
    if not (within >= 0.85 and within_1e2 >= 0.98 and norm.max() < 0.25):
        raise AssertionError(
            f"kernel vs plain on the world: {within} of cells within 1e-4,"
            f" {within_1e2} within 0.01 of their largest value, worst {norm.max()}"
        )
    if not torch.equal(out[n:], X[n:]):
        raise AssertionError("dead rows changed")
    return {
        "world_shape": {"q": X.shape[0], "n_cells": n, "p": params.Ke.shape[1]},
        "world_max_abs_err": float(np.abs(out_np - ref_np).max()),
        "world_cells_within_1e-4": within,
        "world_cells_within_0.01": within_1e2,
        "world_max_cell_err": float(norm.max()),
        "world_q99_rel_err": float(np.quantile(rel, 0.99)),
    }


def _workload(torch):
    """The world of the main path, with its cells spawned."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY

    rng = random.Random(SEED)
    t0 = time.perf_counter()
    world = mt.World(chemistry=CHEMISTRY, map_size=MAP_SIZE, seed=SEED)
    world.spawn_cells(
        [mt.random_genome(s=GENOME_SIZE, rng=rng) for _ in range(N_CELLS)]
    )
    torch.cuda.synchronize()
    spawn_s = time.perf_counter() - t0
    if world.integrator != "cuda" or world.device.type != "cuda":
        raise AssertionError(f"world runs {world.integrator} on {world.device}")
    return world, spawn_s


def _run_steps(torch, world) -> dict:
    """The main path: warm-up, timed and phase-timed workload steps, with
    the kernel's launch count set to 0 just before and read right after."""
    import numpy as np

    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.workload import sim_step

    atp = world.chemistry.molname_2_idx["ATP"]
    rng = random.Random(SEED + 1)
    phases: dict[str, float] = {}

    class _Timer:
        def __init__(self, label):
            self.label = label

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            dt = time.perf_counter() - self.t0
            phases[self.label] = phases.get(self.label, 0.0) + dt

    def step(**kw):
        sim_step(
            world, rng, n_cells=N_CELLS, genome_size=GENOME_SIZE, atp_idx=atp, **kw
        )

    ci.launches = 0
    for _ in range(WARMUP_STEPS):
        step(sync=False)
    torch.cuda.synchronize()
    # steps/s: no barrier inside a block (the next step's ATP fetch is the
    # only wait, as in bench.py), one at its end
    block_s = []
    for _ in range(TIMED_BLOCKS):
        t0 = time.perf_counter()
        for _ in range(BLOCK_STEPS):
            step(sync=False)
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - t0)
    # seconds per phase: a separate pass with every phase synchronized
    for _ in range(PHASE_STEPS):
        step(timeit=_Timer)
    launches = ci.launches

    n_steps = WARMUP_STEPS + TIMED_BLOCKS * BLOCK_STEPS + PHASE_STEPS
    if launches != n_steps:
        raise AssertionError(f"{launches} kernel launches in {n_steps} steps")
    cm = world.cell_molecules
    mm = world.molecule_map.cpu().numpy()
    for name, arr in (("cell_molecules", cm), ("molecule_map", mm)):
        if not (np.isfinite(arr).all() and (arr >= 0).all()):
            raise AssertionError(f"{name} is not finite and >= 0")
    if world.n_cells <= 0:
        raise AssertionError("no cells left")
    timed = TIMED_BLOCKS * BLOCK_STEPS
    return {
        "steps": n_steps,
        "launches": launches,
        "timed_steps": timed,
        "steps_per_s": timed / sum(block_s),
        "block_steps_per_s": [BLOCK_STEPS / t for t in block_s],
        "phase_steps": PHASE_STEPS,
        "phase_s_per_step": {k: v / PHASE_STEPS for k, v in phases.items()},
        "n_cells": world.n_cells,
        "capacity": world._capacity,
    }


def main() -> None:
    torch = _environment()
    _build()

    world, spawn_s = _workload(torch)
    p, s = world.kinetics.max_proteins, 2 * world.n_molecules
    print(f"world: {world.n_cells} cells, capacity {world._capacity}, p {p}, s {s},"
          f" spawn {spawn_s:.3f} s")
    kernel = _kernel_check(torch, q=10240, p=p, s=s)
    kernel.update(_world_kernel_check(torch, world))
    kernel["max_abs_err"] = max(kernel["seeded_max_abs_err"], kernel["world_max_abs_err"])
    work = _run_steps(torch, world)
    kernel["launches"] = work["launches"]
    kernel["ok"] = True
    work["spawn_s"] = spawn_s
    work["peak_mem_bytes"] = torch.cuda.max_memory_allocated()

    card = _card_line()
    print(json.dumps({"workload": work}))
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
