"""
Readings of the correctness check over many seeds in one process: for
each seed, the cell's set-up, a window of ``--seconds``, one more step
and the judge's readings of the program and of the control (the
reference in bfloat16 put in the program's place).  The limits in the
workload files are set from these readings; the benchmark's own runs do
not run the control.

    python3 -m benchmark.readings --workload <name> --seeds 1,2,3 --seconds 5

Prints one JSON line per seed; needs the card unless ``--device cpu``.
"""
import argparse
import gc
import importlib
import json
import sys
import time

from benchmark import run


def readings(name: str, seed: int, seconds: float, device: str, overrides=None) -> list[dict]:
    """The judge's readings of each world of one seed's run."""
    import torch

    _, _, workload, config = run.cell_files(name)
    config = dict(config, **(overrides or {}))
    driver = importlib.import_module(f"benchmark.drivers.{workload['driver']}").Driver(
        config, workload, seed, device)
    run.measure(driver, seconds)
    states = driver.check_states(check_seed=seed)
    driver.close()
    del driver
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = run.judged(states, config, seed, device, control=True)
    judge_s = (time.perf_counter() - t0) / len(out)
    for i, (res, (_, _, counts, _)) in enumerate(zip(out, states)):
        res.update(seed=seed, world=i, counts=counts, judge_s=judge_s)
    return out


def control_readings(readings_: list[dict]) -> list[dict]:
    """The control's readings under the program's names, for ``run.check``."""
    return [{k[len("control."):]: v for k, v in r.items() if k.startswith("control.")}
            for r in readings_]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    run.pin_host_threads()
    for seed in (int(s) for s in args.seeds.split(",")):
        for res in readings(args.workload, seed, args.seconds, args.device):
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
