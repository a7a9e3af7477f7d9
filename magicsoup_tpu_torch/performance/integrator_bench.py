"""
Device-time microbenchmark of the signal integrator by backend and world
count: the port of ``performance/integrator_bench.py``.

Inputs are drawn as the JAX bench draws them: ``--occupancy`` of the cell
rows live, dead rows' parameters zeroed, ``A = 0`` and ``Kmr = 0``, Nf
and Nb taken from N.  Each point is one registry backend
(:mod:`magicsoup_tpu_torch.ops.backends`) at one world count B: B = 1 runs
X ``(c, s)``, B > 1 a leading world axis (world w's X scaled by
``1 + 1e-3 w``, the parameters materialized per world, since ``cuda``
takes whole rows per world).  ``cuda`` runs one kernel launch per step
for all B worlds (the batched grid); ``torch-fast`` its plain body per
world.

Timing: CUDA events around a chain of ``--chain`` steps, the median of
``--reps`` chains, milliseconds per step (events sit on the stream, so
nothing is subtracted; the card spins before each chain, so the host's
time to launch the first step is not counted); with ``--device cpu`` the
host clock.  The
``cuda`` points must show one kernel launch per chained step.  Output:
the byte-model line (the bytes one step must read and write once), the
max |cuda - torch-fast| after the chain at B = 1, and one JSON row per
(backend, B) point in the JAX bench's schema plus ``"device"``.  A point
that raises is printed and fails the run (exit 1).

    python -m magicsoup_tpu_torch.performance.integrator_bench
    python -m magicsoup_tpu_torch.performance.integrator_bench --backend cuda --fleet-b 1,4
"""
import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from magicsoup_tpu_torch.interop import params_from_numpy
from magicsoup_tpu_torch.ops import backends
from magicsoup_tpu_torch.ops import cuda_integrate as ci
from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.util import fetch_host, to_device
from magicsoup_tpu_torch.performance import (
    HBM_BYTES_PER_S,
    card_line,
    cuda_median_ms,
    device_name,
)


def draw_inputs(c: int, p: int, s: int, occupancy: float):
    """The JAX bench's inputs (``performance/integrator_bench.py:73-95``):
    ``default_rng(0)``; live rows, N, then Ke, Kmf, Kmb and Vmax with the
    dead rows zeroed, then X."""
    rng = np.random.default_rng(0)
    live = rng.random(c) < occupancy

    def cp(lo, hi):
        a = rng.uniform(lo, hi, (c, p)).astype(np.float32)
        a[~live] = 0.0
        return a

    N = rng.integers(-2, 3, (c, p, s)).astype(np.int16)
    N[~live] = 0
    d = dict(
        Ke=cp(0.1, 10.0),
        Kmf=cp(0.5, 5.0),
        Kmb=cp(0.5, 5.0),
        Kmr=np.zeros((c, p, s), dtype=np.float32),
        Vmax=cp(0.0, 10.0),
        N=N,
        Nf=np.where(N < 0, -N, 0).astype(np.int16),
        Nb=np.where(N > 0, N, 0).astype(np.int16),
        A=np.zeros((c, p, s), dtype=np.int16),
    )
    X = rng.uniform(0.0, 5.0, (c, s)).astype(np.float32)
    return X, d


def min_bytes(c: int, p: int, s: int) -> int:
    """One step's bytes, each read or written once: the four i16 and the
    f32 (c, p, s) tensors, the four (c, p) tensors, X and X1."""
    return 4 * c * p * s * 2 + c * p * s * 4 + 4 * c * p * 4 + 2 * c * s * 4


def _inputs(X: torch.Tensor, params: CellParams, b: int):
    if b == 1:
        return X, params
    scale = 1.0 + 1e-3 * torch.arange(b, dtype=torch.float32, device=X.device)
    Pb = CellParams(*(t[None].expand((b,) + t.shape).contiguous() for t in params))
    return X[None] * scale[:, None, None], Pb


def _chain(name: str, X, params, n: int):
    for _ in range(n):
        X = backends.integrate(name, X, params)
    return X


def _time_point(name: str, X, params, chain: int, reps: int, dev) -> tuple[float, torch.Tensor]:
    """Median ms per step over ``reps`` chains (after one warm-up chain,
    whose output is returned); the ``cuda`` backend must launch once per
    step."""
    before = ci.launches
    out = _chain(name, X, params, chain)
    if name == "cuda" and dev.type == "cuda" and ci.launches - before != chain:
        raise AssertionError(f"{ci.launches - before} kernel launches in {chain} chained steps")
    if dev.type == "cuda":
        return cuda_median_ms(lambda: _chain(name, X, params, chain), reps) / chain, out
    vals = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _chain(name, X, params, chain)
        vals.append((time.perf_counter() - t0) * 1e3 / chain)
    return statistics.median(vals), out


def bench(c, p, s, occupancy, chain, reps, points, device, log=print) -> tuple[list[dict], bool]:
    """Time each ``(backend, B)`` of ``points``; the JSON rows and whether
    every point ran."""
    dev = torch.device(device)
    X_np, d = draw_inputs(c, p, s, occupancy)
    X = to_device(X_np, dev)
    params = params_from_numpy(d, dev)
    name = device_name(dev)
    n_bytes = min_bytes(c, p, s)
    log(f"param bytes/step (1x read): {n_bytes / 1e6:.1f} MB"
        f" ({n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s)")
    metric = f"integrator_ms_per_step[c={c},p={p},s={s},chain={chain}]"
    rows, ok, after = [], True, {}
    for backend, b in points:
        point = f"{backend}.B{b}"
        try:
            Xb, Pb = _inputs(X, params, b)
            ms, out = _time_point(backend, Xb, Pb, chain, reps, dev)
        except Exception as e:  # noqa: BLE001 - report the point and go on
            ok = False
            log(f"grid {point}: FAILED {type(e).__name__}: {str(e)[:200]}")
            continue
        if b == 1:
            after[backend] = out
        log(f"grid {point:20s} {ms:8.4f} ms/step,"
            f" {b * n_bytes / (ms * 1e-3) / 1e9:.1f} GB/s if each byte moved once")
        rows.append({
            "integrator_point": point,
            "backend_name": backend,
            "fleet_b": b,
            "metric": metric,
            "unit": "ms",
            "value": ms,
            "ms_per_step": ms,
            "shape": [c, p, s],
            "backend": dev.type,
            "device": name,
        })
    if "cuda" in after and "torch-fast" in after:
        diff = float(fetch_host((after["cuda"] - after["torch-fast"]).abs().max()))
        log(f"max |cuda - torch-fast| after {chain} steps: {diff:.3e}")
    return rows, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=16384)
    ap.add_argument("--proteins", type=int, default=32)
    ap.add_argument("--signals", type=int, default=28)
    ap.add_argument("--occupancy", type=float, default=0.75,
                    help="fraction of cell slots with live parameters")
    ap.add_argument("--chain", type=int, default=10, help="integrator steps per timed chain")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--backend", default="cuda,torch-fast",
                    help="comma list of registry backend names")
    ap.add_argument("--fleet-b", default="1,4", help="comma list of world counts B")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.backend.split(",") if n.strip()]
    for n in names:
        backends.get_backend(n)
    fleet_bs = [int(v) for v in args.fleet_b.split(",") if v.strip()]
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("integrator_bench: no CUDA device; pass --device cpu", file=sys.stderr)
            return 1
        print(f"card {card_line()}", flush=True)
    rows, ok = bench(args.cells, args.proteins, args.signals, args.occupancy, args.chain,
                     args.reps, [(n, b) for n in names for b in fleet_bs], args.device,
                     log=lambda line: print(line, flush=True))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
