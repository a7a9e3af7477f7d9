"""
Realistic-environment simulation run with per-phase timers, mirroring the
reference harness: maintain a population on a torus map under the
Wood-Ljungdahl chemistry; each step is spawn top-up, enzymatic_activity,
ATP-threshold kill and divide, recombinate, mutate,
degrade+diffuse+lifetimes.  The port of ``performance/run_simulation.py``.

    python -m magicsoup_tpu_torch.performance.run_simulation --map-size 256 --n-steps 200

Writes per-phase timings (``Time[s]/<phase>``), ``Cells/total`` and the
mean concentration of each molecule (``Molecules/<name>``) to
TensorBoard when it is importable, else to ``scalars.jsonl``, under
``--logdir`` (default ``build/runs/<date>`` in the repository).  Every
100 steps it saves the world's state (``step=<i>/``) and, with
``--pipelined``, a verified run checkpoint; at the end, or at the first
SIGTERM/SIGINT, it drains and writes one final verified checkpoint
(``checkpoints/``).  Prints the final cell count and a per-phase
seconds-per-step summary.  Runs on the card unless ``--device cpu``.
"""
import datetime as dt
import json
import random
import sys
import time
from argparse import ArgumentParser
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

from magicsoup_tpu_torch.performance import add_device_arg, device_name, driver_device

_ROOT = Path(__file__).resolve().parents[2]


class _Writer:
    """TensorBoard writer when it is importable, else JSONL."""

    def __init__(self, logdir: Path):
        self._tb = None
        self._fh = None
        logdir.mkdir(parents=True, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=logdir)
        except ImportError:
            # graftlint: disable=GL018 a scalar log streamed row by row, not run state
            self._fh = open(logdir / "scalars.jsonl", "w")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._fh.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._fh.close()


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--map-size", default=256, type=int)
    ap.add_argument("--n-cells", default=1000, type=int)
    ap.add_argument("--n-steps", default=200, type=int)
    ap.add_argument("--init-genome-size", default=500, type=int)
    ap.add_argument("--init-molmap", default="randn", type=str)
    ap.add_argument("--log-every", default=5, type=int)
    ap.add_argument("--seed", default=42, type=int)
    ap.add_argument("--pipelined", action="store_true",
                    help="drive the run with the PipelinedStepper (per-phase timers"
                    " then only show perStep; a flush syncs at every checkpoint)")
    ap.add_argument("--logdir", type=Path, default=None,
                    help="run directory (default build/runs/<date> in the repository)")
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = driver_device(args.device, "run_simulation")

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import guard
    from magicsoup_tpu_torch.cache import ensure_compile_cache
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu_torch.util import fetch_host
    from magicsoup_tpu_torch.workload import sim_step

    ensure_compile_cache(device)
    logdir = args.logdir or _ROOT / "build" / "runs" / dt.datetime.now().strftime("%Y-%m-%d_%H-%M")
    writer = _Writer(logdir)
    totals: dict[str, float] = defaultdict(float)

    @contextmanager
    def timeit(label: str, step: int):
        t0 = time.perf_counter()
        yield
        d = time.perf_counter() - t0
        totals[label] += d
        writer.add_scalar(f"Time[s]/{label}", d, step)

    rng = random.Random(args.seed)
    world = mt.World(chemistry=CHEMISTRY, map_size=args.map_size,
                     mol_map_init=args.init_molmap, seed=args.seed, device=device)
    world.save(rundir=logdir)
    atp = CHEMISTRY.molname_2_idx["ATP"]

    stepper = None
    if args.pipelined:
        stepper = mt.PipelinedStepper(world, mol_name="ATP", kill_below=1.0, divide_above=5.0,
                                      divide_cost=4.0, target_cells=args.n_cells,
                                      genome_size=args.init_genome_size)

    # retained verified checkpoints at the state dumps' cadence, and a
    # SIGTERM/SIGINT latch: a preemption drains the pipeline and writes
    # one final checkpoint instead of losing the interval
    ckpt_mgr = guard.CheckpointManager(logdir / "checkpoints", keep=3)

    with guard.GracefulShutdown() as stop:
        for step_i in range(args.n_steps):
            if stop:
                print(f"graceful shutdown (signal {stop.signum}) at step {step_i}:"
                      " draining + final checkpoint")
                break
            if step_i % 100 == 0:
                if stepper is not None:
                    guard.save_run(ckpt_mgr, world, stepper, step=step_i)
                world.save_state(statedir=logdir / f"step={step_i}")

            with timeit("perStep", step_i):
                if stepper is not None:
                    stepper.step()
                else:
                    sim_step(world, rng, n_cells=args.n_cells,
                             genome_size=args.init_genome_size, atp_idx=atp,
                             timeit=lambda label: timeit(label, step_i))

            # the stepper's population trails the dispatched step by the
            # pipeline depth; the scalar is tagged with the dispatch step
            n_now = stepper.population if stepper is not None else world.n_cells
            writer.add_scalar("Cells/total", n_now, step_i)

            if step_i % args.log_every == 0 and stepper is None:
                molmap = fetch_host(world.molecule_map)
                cellmols = world.cell_molecules
                n_pxls = world.map_size**2
                for mol_i, mol in enumerate(CHEMISTRY.molecules):
                    d = float(molmap[mol_i].sum())
                    n = n_pxls
                    if world.n_cells > 0:
                        d += float(cellmols[:, mol_i].sum())
                        n += world.n_cells
                    writer.add_scalar(f"Molecules/{mol.name}", d / n, step_i)

    # on completion and on a graceful shutdown alike: drain, one final
    # verified checkpoint, a durable telemetry flush
    if stepper is not None:
        guard.save_run(ckpt_mgr, world, stepper, meta={"final": True})
    else:
        guard.save_run(ckpt_mgr, world, meta={"final": True})
    world.telemetry.flush(sync=True)
    writer.close()
    n = max(args.n_steps, 1)
    print(f"{args.n_steps} steps, final n_cells={world.n_cells}")
    for label, total in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {label:20s} {total / n:.4f} s/step")
    print(f"device: {device_name(device)}; run directory: {logdir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
