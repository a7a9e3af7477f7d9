"""
Micro-benchmarks of the genome ops on both genome backends: the host
string engine (a C++ loop over strings) against the token programs on
the device (:mod:`magicsoup_tpu_torch.genomes`), at 1k / 8k / 40k cells
with 1k-bp genomes.  The port of ``performance/genome_ops.py``.

Three ops per (size, backend) point:

- ``mutate``: point mutations over the whole population
  (``mutations.point_mutations`` against ``genomes.point_mutations_tokens``);
- ``recombinate``: strand-break recombination over n/2 random pairs
  (``mutations.recombinations`` against ``genomes.recombinations_tokens``);
- ``translate``: the steady-state phenotype feed, a warm
  ``PhenotypeCache`` keyed by genome strings against token content hashes
  (``lookup`` against ``lookup_tokens``); misses are warmed untimed.

Rates are raised (``--p 1e-4``, ``--pb 1e-5``) so every repeat does real
work; both backends get the same rates.  Each token op is run once per
shape before timing; a timed token op ends in a value fetch, which waits
for the device, as in the JAX script.  Times are host seconds per op
(mean and spread over ``--r`` repeats), so on the card they include the
enqueue of every launch of a token program.  With ``--json`` one JSON
row per (op, size, backend) in the JAX script's schema, plus
``"device"``.

    python -m magicsoup_tpu_torch.performance.genome_ops [--sizes 1000,8000,40000]
        [--s 1000] [--r 5] [--json] [--device cuda|cpu]
"""
import argparse
import json
import random
import statistics
import sys
import time

import numpy as np
import torch


def _summary(tds: list[float]) -> str:
    return f"({statistics.fmean(tds):.4f}+-{statistics.pstdev(tds):.4f})s"


def result_row(op: str, tds: list[float], n_cells: int, genome_size: int, backend: str,
               device: str) -> dict:
    """One (op, size, backend) measurement: seconds per op call (lower is
    better), the JAX script's keys plus the device that ran it."""
    return {
        "metric": f"genome_ops.{op} ({n_cells} cells, {genome_size} nt, {backend})",
        "op": op,
        "value": round(statistics.fmean(tds), 4),
        "unit": "s",
        "sd": round(statistics.pstdev(tds), 4),
        "repeats": len(tds),
        "n_cells": n_cells,
        "genome_size": genome_size,
        "backend": backend,
        "device": device,
    }


def bench(sizes: list[int], s: int, r: int, p: float, pb: float, seed: int,
          device: str, log=print) -> list[dict]:
    """Every (op, size, backend) point; returns the rows."""
    from magicsoup_tpu_torch import mutations
    from magicsoup_tpu_torch.genetics import Genetics, PhenotypeCache
    from magicsoup_tpu_torch.genomes import (
        encode_genomes,
        length_capacity,
        point_mutations_tokens,
        recombinations_tokens,
    )
    from magicsoup_tpu_torch.performance import device_name
    from magicsoup_tpu_torch.util import random_genome, to_device

    dev = torch.device(device)
    name = device_name(dev)
    rng = random.Random(seed)
    genetics = Genetics(seed=seed)
    rows: list[dict] = []

    def emit(op: str, tds: list[float], n: int, backend: str) -> None:
        log(f"{_summary(tds)} - {op} ({n:,} cells, {backend})")
        rows.append(result_row(op, tds, n, s, backend, name))

    def timed(fn) -> list[float]:
        tds = []
        for k in range(r):
            t0 = time.perf_counter()
            fn(k)
            tds.append(time.perf_counter() - t0)
        return tds

    def fetched(out) -> None:
        # a value fetch waits for the device, as the JAX script's does
        out_t, out_l, _ = out
        int(out_l[0]), int(out_t[0, 0])

    for n in sizes:
        seqs = [random_genome(s=s, rng=rng) for _ in range(n)]
        tokens_np, lengths_np = encode_genomes(seqs, length_cap=length_capacity(s))
        tokens = to_device(tokens_np, dev)
        lengths = to_device(lengths_np, dev)
        pair_rows = list(range(n))
        rng.shuffle(pair_rows)
        pairs = np.asarray(pair_rows[: 2 * (n // 2)]).reshape(-1, 2)
        seq_pairs = [(seqs[a], seqs[b]) for a, b in pairs]

        emit("mutate", timed(lambda k: mutations.point_mutations(seqs, p=p, seed=seed + k)),
             n, "string")
        fetched(point_mutations_tokens(tokens, lengths, p=p, seed=0))
        emit("mutate", timed(lambda k: fetched(
            point_mutations_tokens(tokens, lengths, p=p, seed=seed + k))), n, "token")

        emit("recombinate", timed(lambda k: mutations.recombinations(
            seq_pairs, p=pb, seed=seed + k)), n, "string")
        fetched(recombinations_tokens(tokens, lengths, pairs, p=pb, seed=0))
        emit("recombinate", timed(lambda k: fetched(
            recombinations_tokens(tokens, lengths, pairs, p=pb, seed=seed + k))), n, "token")

        cache = PhenotypeCache(genetics, maxsize=max(2 * n, 16_384))
        cache.lookup(seqs)  # warm: misses translate once, untimed
        emit("translate", timed(lambda k: cache.lookup(seqs)), n, "string")
        cache = PhenotypeCache(genetics, maxsize=max(2 * n, 16_384))
        cache.lookup_tokens(tokens_np, lengths_np)
        emit("translate", timed(lambda k: cache.lookup_tokens(tokens_np, lengths_np)),
             n, "token")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=str, default="1000,8000,40000",
                    help="comma-separated cell counts")
    ap.add_argument("--s", type=int, default=1_000, help="genome size")
    ap.add_argument("--r", type=int, default=5, help="repeats")
    ap.add_argument("--p", type=float, default=1e-4, help="mutation rate")
    ap.add_argument("--pb", type=float, default=1e-5, help="strand-break rate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="also print one JSON row per (op, size, backend)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("genome_ops: no CUDA device; pass --device cpu", file=sys.stderr)
            return 1
        from magicsoup_tpu_torch.performance import card_line

        print(f"card {card_line()}", flush=True)
    sizes = [int(x) for x in args.sizes.split(",") if x.strip()]
    print(f"Benchmarking mutate, recombinate, translate: string vs token\n"
          f"{sizes} cells, {args.s:,} genome size, on {args.device}", flush=True)
    rows = bench(sizes, args.s, args.r, args.p, args.pb, args.seed, args.device,
                 log=lambda line: print(line, flush=True))
    if args.json:
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
