"""
Megastep K-sweep: the canonical pipelined workload (the headline shape by
default: 10k cells, 128x128 map, Wood-Ljungdahl) timed at several
``megastep`` settings, one JSON line per K.  The port of
``performance/megastep_sweep.py``.

    python -m magicsoup_tpu_torch.performance.megastep_sweep [--ks 1,2,4,8]

``K`` runs K device steps per dispatch, so the dispatches (and their
host cost) drop Kx, at the cost of selection decisions replaying at
K-step granularity and the host view trailing by ``lag * K`` steps.
Steps/s are SIMULATION steps (dispatches x K), comparable across Ks.
Each row has the JAX script's keys (``backend`` is the port's device
type) plus ``"device"``.  Runs on the card unless ``--device cpu``.
"""
import argparse
import json
import random
import statistics
import sys
import time

from magicsoup_tpu_torch.performance import add_device_arg, device_name, driver_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="1,2,4,8", help="comma-separated K values")
    ap.add_argument("--n-cells", type=int, default=10_000)
    ap.add_argument("--map-size", type=int, default=128)
    ap.add_argument("--genome-size", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=6, help="warmup dispatches")
    ap.add_argument("--steps", type=int, default=48, help="measured SIM steps per K")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument(
        "--pin-population", action="store_true",
        help="disable kills/divisions/spawns so every K times the IDENTICAL trajectory",
    )
    add_device_arg(ap)
    args = ap.parse_args(argv)
    ks = sorted({int(k) for k in args.ks.split(",")})
    device = driver_device(args.device, "megastep_sweep")

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.cache import ensure_compile_cache
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY

    ensure_compile_cache(device)
    backend = device.type
    for k in ks:
        # a fresh world per K: each K replays selections at its own
        # granularity, so an earlier K's population would bias a later one
        rng = random.Random(args.seed)
        world = mt.World(chemistry=CHEMISTRY, map_size=args.map_size, seed=args.seed,
                         device=device)
        world.spawn_cells(
            [mt.random_genome(s=args.genome_size, rng=rng) for _ in range(args.n_cells)])
        if args.pin_population:
            sel = dict(kill_below=0.0, divide_above=1e30, target_cells=None)
        else:
            sel = dict(kill_below=1.0, divide_above=5.0, target_cells=args.n_cells)
        st = mt.PipelinedStepper(world, mol_name="ATP", divide_cost=4.0,
                                 genome_size=args.genome_size, megastep=k, **sel)
        for _ in range(max(args.warmup, 3)):
            st.step()
        st.drain()
        st.wait_warm()
        st.trace.clear()
        n_disp = max(1, -(-args.steps // k))
        t0 = time.perf_counter()
        for _ in range(n_disp):
            st.step()
        st.drain()
        dt = (time.perf_counter() - t0) / (n_disp * k)
        trace = list(st.trace)
        disp_ms = (statistics.median(t["dispatch"] for t in trace) * 1e3
                   if trace else float("nan"))
        st.flush()
        print(json.dumps({
            "metric": (f"megastep K={k} steps/sec ({args.n_cells} cells, "
                       f"{args.map_size}x{args.map_size} map, {backend})"),
            "value": round(1.0 / dt, 4),
            "unit": "steps/s",
            "megastep": k,
            "dispatches": n_disp,
            "ms_per_step": round(dt * 1e3, 2),
            "dispatch_ms_median": round(disp_ms, 2),
            "final_n_cells": world.n_cells,
            "pinned_population": args.pin_population,
            "backend": backend,
            "device": device_name(device),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
