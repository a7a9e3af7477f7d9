"""
Micro-benchmarks of the expensive World methods, mirroring the
reference's harness: spawn_cells, update_cells, divide_cells
(replicate), enzymatic_activity, and mutations+neighbors+recombinations,
at 10k cells with 1k-bp genomes.  The port of ``performance/check.py``
(a module of its own, apart from :mod:`magicsoup_tpu_torch.check`, the
audit and differential plane).

    python -m magicsoup_tpu_torch.performance.check [--n 10000] [--s 1000] [--r 5] [--json]

Each timed op ends in a value fetch of the world's state, which waits
for the device.  ``--json`` prints one JSON row per op (seconds, lower
is better) with the JAX script's keys (``backend`` is the port's device
type) plus ``"device"``.  Runs on the card unless ``--device cpu``.
"""
import json
import random
import statistics
import sys
import time
from argparse import ArgumentParser

from magicsoup_tpu_torch.performance import add_device_arg, device_name, driver_device

#: the ops, in the order they run and print
OPS = ("spawn_cells", "update_cells", "divide_cells", "enzymatic_activity", "mutations")


def _summary(tds: list[float]) -> str:
    mu = statistics.fmean(tds)
    sd = statistics.pstdev(tds)
    return f"({mu:.2f}+-{sd:.2f})s"


def result_row(op: str, tds: list[float], n_cells: int, genome_size: int,
               backend: str) -> dict:
    """The structured form of one op's measurement: seconds per op call,
    LOWER is better (``"unit": "s"``), as ``performance/check.py`` builds it."""
    return {
        "metric": f"check.{op} ({n_cells} cells, {genome_size} nt, {backend})",
        "op": op,
        "value": round(statistics.fmean(tds), 4),
        "unit": "s",
        "sd": round(statistics.pstdev(tds), 4),
        "repeats": len(tds),
        "n_cells": n_cells,
        "genome_size": genome_size,
        "backend": backend,
    }


def main(argv=None) -> int:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000, help="number of cells")
    ap.add_argument("--s", type=int, default=1_000, help="genome size")
    ap.add_argument("--r", type=int, default=5, help="repeats")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", help="also print one JSON result line per op")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = driver_device(args.device, "check")

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.cache import ensure_compile_cache
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu_torch.util import fetch_host

    ensure_compile_cache(device)
    rng = random.Random(args.seed)

    def gen_genomes(n: int, s: int, d: float = 0.1) -> list[str]:
        pop = [s - int(s * d), s, s + int(s * d)]
        return [mt.random_genome(s=rng.choice(pop), rng=rng) for _ in range(n)]

    def new_world(**kw):
        return mt.World(chemistry=CHEMISTRY, seed=rng.randrange(2**31), device=device, **kw)

    def sync(world) -> None:
        # value fetches wait for the device
        fetch_host(world._molecule_map[0, 0, 0])
        fetch_host(world._cell_molecules[0, 0])
        fetch_host(world.kinetics.params.Vmax[0, 0])

    backend = device.type
    print(f"Benchmarking spawn_cells, update_cells, divide_cells, "
          f"enzymatic_activity, mutations\n"
          f"{args.n:,} cells, {args.s:,} genome size, on {backend} ({device_name(device)})",
          flush=True)

    def emit(op: str, tds: list[float], label: str) -> None:
        print(f"{_summary(tds)} - {label}", flush=True)
        if args.json:
            row = dict(result_row(op, tds, args.n, args.s, backend), device=device_name(device))
            print(json.dumps(row), flush=True)

    # -- spawn
    tds = []
    for _ in range(args.r):
        world = new_world()
        genomes = gen_genomes(args.n, args.s)
        t0 = time.perf_counter()
        world.spawn_cells(genomes=genomes)
        sync(world)
        tds.append(time.perf_counter() - t0)
    emit("spawn_cells", tds, "spawn cells")

    # -- update
    tds = []
    for _ in range(args.r):
        world = new_world()
        world.spawn_cells(genomes=gen_genomes(args.n, args.s))
        pairs = list(zip(gen_genomes(args.n, args.s), range(world.n_cells)))
        sync(world)
        t0 = time.perf_counter()
        world.update_cells(genome_idx_pairs=pairs)
        sync(world)
        tds.append(time.perf_counter() - t0)
    emit("update_cells", tds, "update cells")

    # -- replicate (divide): a 256² map has room for all n children, so
    # this is a true n-division burst
    tds = []
    n_divided = 0
    for _ in range(args.r):
        world = new_world(map_size=256)
        world.spawn_cells(genomes=gen_genomes(args.n, args.s))
        sync(world)
        t0 = time.perf_counter()
        n_divided = len(world.divide_cells(cell_idxs=list(range(world.n_cells))))
        sync(world)
        tds.append(time.perf_counter() - t0)
    emit("divide_cells", tds, f"replicate cells ({n_divided:,} divided)")

    # -- enzymatic activity (steady state: the first call is untimed)
    world = new_world()
    world.spawn_cells(genomes=gen_genomes(args.n, args.s))
    world.enzymatic_activity()
    sync(world)
    tds = []
    for _ in range(args.r):
        t0 = time.perf_counter()
        world.enzymatic_activity()
        sync(world)
        tds.append(time.perf_counter() - t0)
    emit("enzymatic_activity", tds, "enzymatic activity")

    # -- mutations + neighbors + recombinations
    tds = []
    for _ in range(args.r):
        t0 = time.perf_counter()
        world.mutate_cells()
        nghbrs = world.get_neighbors(cell_idxs=list(range(world.n_cells)))
        pairs = [(world.cell_genomes[a], world.cell_genomes[b]) for a, b in nghbrs]
        mt.recombinations(seq_pairs=pairs)
        sync(world)
        tds.append(time.perf_counter() - t0)
    emit("mutations", tds, "mutations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
