"""
Runs one cell of the benchmark once and prints its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything about the cell is found by name: the cell in ``BENCHMARK.json``,
its workload file ``benchmark/workloads/<name>.json``, the configuration
file ``benchmark/configs/<config>.json`` that names, the driver
``benchmark/drivers/<driver>.py`` and, with ``--trace 1``, each per-layer
metric's reader ``benchmark/metrics/<metric>.py``.

The process's host threads are pinned (``HOST_THREADS`` for OpenMP, the
genome engine's pool, and for torch's), so a run's host load does not
follow the machine's core count.

A run sets up the cell (building the program's kernels on the first run
in a checkout), measures for ``--seconds`` with tracing off, and with
``--trace 1`` then profiles ``trace_steps`` steps.  After the window it
steps each world once more and holds that step to the reference
(:mod:`benchmark.reference.judge`).  The last line on stdout is one JSON
object: ``correct``, ``attempted`` (simulated steps in the window), ``failed``
(worlds whose checked step missed a limit), ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines on stderr).  It exits 2 without
printing a result when there is no card or too few, and 3 when the
process has loaded JAX or the JAX package.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "magicsoup_tpu")
#: host threads for OpenMP (the genome engine's) and torch, fixed so that a
#: run's host load does not follow the machine's core count (8 on the card's).
#: One: the card's host shares its cores, and a parallel region waits for
#: its slowest thread; with four, the engine's phases ran up to twice as
#: long in some runs, and the loop ran slower than with one
HOST_THREADS = 1


class Run(NamedTuple):
    """What a run hands the per-layer metric readers."""

    stats: dict  # the driver's counters, deltas over the measured window
    step_gaps: list  # seconds between consecutive returns of the entry in the window
    trace: object  # benchmark.trace.Trace of the traced window, or None
    trace_steps: int  # simulated steps per world in the traced window
    activity_range: str  # profiler range holding the integrator's launches
    live: list  # (live cells, their proteins) per world after the traced window
    signals: int  # integrator signals per cell


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"benchmark: no {what} named {name!r} in BENCHMARK.json")


def cell_files(name: str, root: Path = ROOT):
    """The manifest, the cell's entry, its workload and its configuration."""
    manifest = load_json(root / "BENCHMARK.json")
    cell = find(manifest["workloads"], name, "workload")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    return manifest, cell, workload, config


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pin_host_threads() -> None:
    """OpenMP's threads (the genome engine's) and torch's, fixed before
    either starts its pool."""
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    import torch

    torch.set_num_threads(HOST_THREADS)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    build = root / "build"
    os.environ["MAGICSOUP_COMPILE_CACHE_DIR"] = str(build / "magicsoup_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(driver, seconds: float):
    """Call the entry until ``seconds`` have passed, then end the window
    with every dispatched step done.  Returns the simulated steps per
    world, the window's seconds and the time between consecutive returns
    of the entry."""
    steps, gaps = 0, []
    t0 = last = time.perf_counter()
    while True:
        steps += driver.step()
        now = time.perf_counter()
        gaps.append(now - last)
        last = now
        if now - t0 >= seconds:
            break
    driver.finish()
    return steps, time.perf_counter() - t0, gaps


def p95(values: list[float]) -> float:
    """The 95th percentile, linearly interpolated between order statistics."""
    v = sorted(values)
    x = 0.95 * (len(v) - 1)
    i = int(math.floor(x))
    j = min(i + 1, len(v) - 1)
    return v[i] + (v[j] - v[i]) * (x - i)


def judged(states, config: dict, seed: int, device, control: bool = False) -> list[dict]:
    """The judge's readings of each world's checked step (world ``i`` has
    the seed ``seed + i``); with ``control``, also the control's."""
    from benchmark import worlds
    from benchmark.reference import judge

    return [judge.judge(s0, s1, counts, plan, worlds.setting(config, seed + i), device,
                        control=control)
            for i, (s0, s1, counts, plan) in enumerate(states)]


def check(readings: list[dict], limits: dict) -> tuple[dict, int]:
    """The compared numbers, each the worst over the cell's worlds, and
    how many worlds' steps read beyond a limit."""
    worst: dict = {}
    failed = 0
    for res in readings:
        failed += any(not float(res[k]) <= v for k, v in limits.items())
        for key in limits:
            worst[key] = max(worst.get(key, -math.inf), float(res[key]))
    return worst, failed


def run_cell(manifest: dict, cell: dict, workload: dict, config: dict, *, seed: int,
             seconds: float, trace: bool, device, t0: float = T0) -> dict:
    """One run of a cell on ``device``; returns the result object."""
    import torch

    from benchmark import worlds

    driver_mod = importlib.import_module(f"benchmark.drivers.{workload['driver']}")
    driver = driver_mod.Driver(config, workload, seed, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    stats0 = driver.stats()
    steps, window_s, gaps = measure(driver, seconds)
    stats = {k: v - stats0.get(k, 0) for k, v in driver.stats().items()}

    traced, trace_steps, live_genomes = None, 0, []
    if trace:
        from benchmark import trace as tr

        counter = [0]

        def window():
            for _ in range(workload["trace_steps"]):
                counter[0] += driver.step()
            driver.finish()

        traced = tr.record(window, ROOT / "build" / "benchmark" / "trace.json")
        trace_steps = counter[0]
        live_genomes = driver.live_genomes()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    states = driver.check_states(check_seed=seed)
    driver.close()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = workload["limits"]
    readings = judged(states, config, seed, device)
    numbers, failed = check(readings, limits)

    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    values = {
        "steps_per_s": steps / window_s,
        "setup_s": setup_s,
    }
    metrics = {}
    if not trace:
        for name, m in e2e.items():
            if name in values and cell["name"] in m.get("workloads", [cell["name"]]):
                metrics[name] = {"value": values[name], "unit": m["unit"]}
    else:
        from benchmark import roofline

        chem = worlds.chemistry_data(config["chemistry"])
        live = [roofline.live_work(genomes, world_seed) for world_seed, genomes in live_genomes]
        run = Run(stats=stats, step_gaps=gaps, trace=traced, trace_steps=trace_steps,
                  activity_range=driver_mod.Driver.activity_range, live=live,
                  signals=2 * len(chem["molecules"]))
        for m in manifest["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": failed == 0,
        "attempted": steps,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.device_ops, "idle_gaps": traced.idle_gaps}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    # the program's counters over the window, and each translated cell
    # whose parameters the check found wrong, for whoever reads a run's log
    sys.stderr.write(f"window {json.dumps({'steps': steps, 'seconds': window_s, **stats})}\n")
    for i, res in enumerate(readings):
        for row, kind, n, n_prog, _ in res.get("params_mismatches", []):
            sys.stderr.write(f"mismatch world {i} row {row} {kind}: the reference translates"
                             f" {n} proteins, the program's row holds {n_prog}\n")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest, cell, workload, config = cell_files(args.workload)
    set_cache_dirs()
    pin_host_threads()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        sys.stderr.write(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s);"
                         f" found {torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 2
    result = run_cell(manifest, cell, workload, config, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda")
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"benchmark: the process loaded {', '.join(found)}\n")
        return 3
    for k, c in result["checks"].items():
        sys.stderr.write(f"check {k} {c['value']!r} limit {c['limit']!r}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
