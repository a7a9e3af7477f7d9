"""
Steady-state per-phase profile of the canonical workload step: the port
of ``performance/profile_step.py``.

Unlike :mod:`~magicsoup_tpu_torch.performance.run_simulation` (which
averages from step 0, the population's ramp included), this warms the
world up to its steady state first, then times each phase over N further
steps, and optionally captures a ``torch.profiler`` trace of them
(``--trace-dir``, through :func:`magicsoup_tpu_torch.telemetry.trace_window`).

    python -m magicsoup_tpu_torch.performance.profile_step --n-cells 10000 --map-size 128

Prints one JSON line (``device``, ``rtt_ms``, ``n_cells_end``,
``s_per_step``, ``steps_per_s``), then one line per phase from the
recorder's :meth:`~magicsoup_tpu_torch.telemetry.TelemetryRecorder.phase_stats`,
the implementation the in-loop telemetry uses; ``--telemetry PATH`` also
streams one JSONL ``dispatch`` row per timed step for
``python -m magicsoup_tpu_torch.telemetry summarize``.  The round trip
``rtt_ms`` is the median of 20 tiny fetches.  Runs on the card unless
``--device cpu``.
"""
import contextlib
import json
import random
import statistics
import sys
import time
from argparse import ArgumentParser

import torch

from magicsoup_tpu_torch.performance import add_device_arg, device_name, driver_device


def main(argv=None) -> int:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-cells", type=int, default=10_000)
    ap.add_argument("--map-size", type=int, default=128)
    ap.add_argument("--genome-size", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--trace-dir", type=str, default=None,
                    help="capture a torch.profiler trace of the timed steps")
    ap.add_argument("--telemetry", type=str, default=None,
                    help="also emit the recorder's JSONL rows to this path")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = driver_device(args.device, "profile_step")

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.cache import ensure_compile_cache
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu_torch.telemetry import TelemetryRecorder, trace_window
    from magicsoup_tpu_torch.util import fetch_host
    from magicsoup_tpu_torch.workload import sim_step

    ensure_compile_cache(device)
    # device round trip: median of 20 tiny fetches
    x = torch.zeros(4, dtype=torch.float32, device=device)
    fetch_host(x)
    rtts = []
    for _ in range(20):
        t0 = time.perf_counter()
        fetch_host(x + 1.0)
        rtts.append(time.perf_counter() - t0)
    rtt = statistics.median(rtts)

    rng = random.Random(args.seed)
    world = mt.World(chemistry=CHEMISTRY, map_size=args.map_size, seed=args.seed, device=device)
    world.spawn_cells([mt.random_genome(s=args.genome_size, rng=rng) for _ in range(args.n_cells)])
    atp = CHEMISTRY.molname_2_idx["ATP"]

    # one timing implementation for the harness and the in-loop telemetry:
    # the recorder's span() is sim_step's timeit hook
    rec = TelemetryRecorder(path=args.telemetry)

    def step(record: bool) -> None:
        kwargs = {"timeit": rec.span} if record else {}
        sim_step(world, rng, n_cells=args.n_cells, genome_size=args.genome_size, atp_idx=atp,
                 sync=True, **kwargs)
        if record and rec.attached:
            # one JSONL row per timed step, its phases attributed to it
            rec.emit({"type": "dispatch", "phases": rec.take_dispatch()})

    for _ in range(args.warmup):
        step(record=False)

    tracer = trace_window(args.trace_dir) if args.trace_dir else contextlib.nullcontext()
    t0 = time.perf_counter()
    with tracer:
        for _ in range(args.steps):
            step(record=True)
    total = time.perf_counter() - t0

    per_step = total / args.steps
    print(json.dumps({
        "device": device_name(device),
        "rtt_ms": round(rtt * 1e3, 3),
        "n_cells_end": world.n_cells,
        "s_per_step": round(per_step, 4),
        "steps_per_s": round(1.0 / per_step, 3),
    }), flush=True)
    stats = rec.phase_stats()
    for label, st in sorted(stats.items(), key=lambda kv: -kv[1]["total_ms"]):
        print(f"  {label:20s} mean {st['mean_ms']:8.1f} ms"
              f"  p50 {st['p50_ms']:8.1f} ms  p95 {st['p95_ms']:8.1f} ms"
              f"  max {st['max_ms']:8.1f} ms  n={st['n']}", flush=True)
    if args.telemetry:
        rec.detach()
    return 0


if __name__ == "__main__":
    sys.exit(main())
