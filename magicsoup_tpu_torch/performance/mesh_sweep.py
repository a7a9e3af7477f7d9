"""
Mesh rank-count sweep: the pipelined stepper timed at several mesh sizes,
one JSON line per rank count.  The port of ``performance/mesh_sweep.py``.

``n_devices=1`` measures the plain single-device stepper in this process
(the scaling curve's baseline, not a one-rank mesh); a larger count
starts that many rank processes
(:class:`~magicsoup_tpu_torch.parallel.launch.RankPool`), which build
the world over a mesh (``World(mesh=)``) and step it in lockstep.  On
the card each rank takes a card of its own and NCCL where there are
enough cards; otherwise the ranks share the cards over gloo, and the
row's ``cards`` says how many served it.  The time per step is the
slowest rank's.

    python -m magicsoup_tpu_torch.performance.mesh_sweep [--devices 1,2,4,8] [--steps 32]
    python -m magicsoup_tpu_torch.performance.mesh_sweep --check --devices 2

``--check`` replaces the timing run with the deterministic-mode
bit-identity gate: this process runs the single-device trajectory, the
ranks the mesh trajectory of the same seeded world, and the run exits
non-zero on any byte difference of the final state
(:func:`~magicsoup_tpu_torch.check.differential.state_digest`: map,
live cell molecules, positions, occupancy, counters, genomes).  Each row
has the JAX script's keys (``backend`` is the port's device type) plus
``"device"`` and ``"cards"``.  Runs on the card unless ``--device cpu``.
"""
import argparse
import json
import os
import random
import sys
import time
from contextlib import contextmanager

import torch

from magicsoup_tpu_torch.performance import add_device_arg, device_name, driver_device

_DET = "MAGICSOUP_TPU_DETERMINISTIC"


@contextmanager
def _numeric_mode(det: bool):
    """Worlds built inside take ``det``'s numeric mode (read from the
    environment when a World is built)."""
    old = os.environ.get(_DET)
    os.environ[_DET] = "1" if det else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(_DET, None)
        else:
            os.environ[_DET] = old


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stepper(mesh, *, device, det: bool, n_cells: int, map_size: int, genome_size: int,
             megastep: int, seed: int):
    """The sweep's seeded Wood-Ljungdahl world (on ``mesh``, or on
    ``device`` without one) under the headline's selection, ``lag=2``."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY

    with _numeric_mode(det):
        world = mt.World(chemistry=CHEMISTRY, map_size=map_size, seed=seed, mesh=mesh,
                         device=None if mesh is not None else device)
    rng = random.Random(seed)
    world.spawn_cells([mt.random_genome(s=genome_size, rng=rng) for _ in range(n_cells)])
    st = mt.PipelinedStepper(world, mol_name="ATP", kill_below=1.0, divide_above=5.0,
                             divide_cost=4.0, target_cells=n_cells, genome_size=genome_size,
                             lag=2, megastep=megastep)
    return world, st


def measure(mesh, *, device=None, warmup: int, steps: int, **kw) -> dict:
    """Time the stepper (on every rank of ``mesh``, or alone on
    ``device``): seconds per simulated step and the final cell count."""
    device = mesh.device if mesh is not None else torch.device(device)
    world, st = _stepper(mesh, device=device, det=False, **kw)
    for _ in range(max(warmup, 2)):
        st.step()
    st.drain()
    st.wait_warm()
    _sync(device)
    n_disp = max(1, -(-steps // st.megastep))
    t0 = time.perf_counter()
    for _ in range(n_disp):
        st.step()
    st.drain()
    _sync(device)
    dt = (time.perf_counter() - t0) / (n_disp * st.megastep)
    st.flush()
    return {"s_per_step": dt, "final_n_cells": world.n_cells}


def det_digest(mesh, *, device=None, steps: int, **kw) -> dict:
    """The deterministic trajectory: ``steps`` dispatches, flushed and
    checked; its final cell count and state digest."""
    from magicsoup_tpu_torch.check.differential import state_digest

    device = mesh.device if mesh is not None else torch.device(device)
    world, st = _stepper(mesh, device=device, det=True, **kw)
    for _ in range(steps):
        st.step()
    st.flush()
    st.check_consistency()
    return {"final_n_cells": world.n_cells, "digest": state_digest(world)}


def _on_ranks(n: int, device: torch.device, fn: str, **kw) -> tuple[list, int]:
    """``fn`` of this module on ``n`` ranks: a card each over NCCL where
    there are enough cards, else sharing them over gloo; returns the
    ranks' results and the cards that served them."""
    from magicsoup_tpu_torch.parallel.launch import RankPool

    if device.type == "cuda":
        cards = torch.cuda.device_count()
        pool = RankPool(n, backend="nccl" if cards >= n else "gloo", device="cuda")
        cards = min(n, cards)
    else:
        pool, cards = RankPool(n, backend="gloo", device="cpu"), 0
    with pool:
        return pool.run(f"magicsoup_tpu_torch.performance.mesh_sweep:{fn}", **kw), cards


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="1,2,4,8",
                    help="comma-separated rank counts to sweep")
    ap.add_argument("--n-cells", type=int, default=2048)
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--genome-size", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=4, help="warmup dispatches")
    ap.add_argument("--steps", type=int, default=32, help="measured SIM steps")
    ap.add_argument("--megastep", type=int, default=1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--check", action="store_true",
                    help="det-mode bit-identity gate instead of a timing run")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = driver_device(args.device, "mesh_sweep")

    from magicsoup_tpu_torch.cache import ensure_compile_cache

    ensure_compile_cache(device)
    kw = dict(n_cells=args.n_cells, map_size=args.map_size, genome_size=args.genome_size,
              megastep=args.megastep, seed=args.seed)
    backend = device.type
    name = device_name(device)
    rc = 0
    for n in sorted({int(d) for d in args.devices.split(",")}):
        if args.check:
            one = det_digest(None, device=device, steps=args.steps, **kw)
            if n > 1:
                ranks, cards = _on_ranks(n, device, "det_digest", steps=args.steps, **kw)
            else:
                ranks, cards = [one], int(device.type == "cuda")
            ok = all(r == one for r in ranks)
            print(json.dumps({
                "metric": f"mesh det bit-identity check (n_devices={n})",
                "ok": ok,
                "n_devices": n,
                "steps": args.steps,
                "final_n_cells": one["final_n_cells"],
                "cards": cards,
                "device": name,
            }), flush=True)
            if not ok:
                print(f"mesh det bit-identity check FAILED: one device {one}, ranks {ranks}",
                      file=sys.stderr, flush=True)
                rc = 1
            continue
        if n > 1:
            ranks, cards = _on_ranks(n, device, "measure", warmup=args.warmup,
                                     steps=args.steps, **kw)
        else:
            ranks = [measure(None, device=device, warmup=args.warmup, steps=args.steps, **kw)]
            cards = int(device.type == "cuda")
        dt = max(r["s_per_step"] for r in ranks)
        print(json.dumps({
            "metric": (f"mesh sweep steps/sec (n_devices={n}, {args.n_cells} cells, "
                       f"{args.map_size}x{args.map_size} map, {backend})"),
            "value": round(1.0 / dt, 4),
            "unit": "steps/s",
            "n_devices": n,
            "megastep": args.megastep,
            "ms_per_step": round(dt * 1e3, 2),
            "final_n_cells": ranks[0]["final_n_cells"],
            "driver": "mesh" if n > 1 else "single",
            "backend": backend,
            "cards": cards,
            "device": name,
        }), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
