"""graftlint command line: `python -m magicsoup_tpu_torch.analysis [--check]`,\nthe counterpart of the JAX package's with the same flags and report schema."""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict
from pathlib import Path

from magicsoup_tpu_torch.analysis import engine
from magicsoup_tpu_torch.analysis.rules import RULE_INFO


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m magicsoup_tpu_torch.analysis",
        description="graftlint: PyTorch/CUDA hot-path static analyzer "
        "(host syncs, dtype drift, nondeterminism, unsanctioned "
        "transfers)",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files/dirs to lint (default: the magicsoup_tpu_torch package)",
    )
    parser.add_argument(
        "--check",
        action="store_true",
        help="exit nonzero when findings are not covered by the baseline "
        "(the gate tests/test_torch_graftlint.py runs)",
    )
    parser.add_argument(
        "--baseline",
        default=None,
        help="baseline JSON path (default: the shipped — empty — "
        "analysis/baseline.json)",
    )
    parser.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule codes to run (default: all)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="machine-readable report (stable `graftlint/1` schema: "
        "per-rule counts incl. zeros, fresh/baselined totals, finding "
        "rows) — what CI archives",
    )
    parser.add_argument(
        "--sarif",
        default=None,
        metavar="PATH",
        help="also write the (fresh) findings as a SARIF 2.1.0 log at "
        "PATH — the format CI code-scanning ingests",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule table"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for code, (name, desc) in RULE_INFO.items():
            print(f"{code}  {name:24s} {desc}")
        return 0

    paths = args.paths or [engine.default_target()]
    only = args.rules.split(",") if args.rules else None
    timings: dict = {}
    ctx = engine.build_context(paths, timings=timings)
    findings = engine.analyze(paths, rules=only, ctx=ctx, timings=timings)
    baseline = engine.load_baseline(
        Path(args.baseline) if args.baseline else None
    )
    fresh = engine.apply_baseline(findings, baseline)
    iterations = getattr(ctx.dataflow, "iterations", 0)

    if args.sarif:
        from magicsoup_tpu_torch.analysis import sarif

        sarif.write_sarif(args.sarif, fresh, RULE_INFO)

    if args.json:
        counts = {code: 0 for code in sorted(RULE_INFO)}
        for f in fresh:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        report = {
            "schema": "graftlint/1",
            "counts": counts,
            "fresh": len(fresh),
            "baselined": len(findings) - len(fresh),
            "files": len({f.path for f in fresh}),
            "findings": [asdict(f) for f in fresh],
            # full device->host crossing inventory (sanctioned and not):
            # the sync-point certificate downstream perf triage diffs
            # against — a new unsanctioned row is a regression even when
            # no rule fires (it may be waived or outside a hot path)
            "d2h": ctx.dataflow.d2h_inventory(),
            "dataflow_iterations": iterations,
            "timings": {k: round(v, 4) for k, v in timings.items()},
        }
        print(json.dumps(report, indent=2))
    else:
        for f in fresh:
            print(f.format())
        n_files = len({f.path for f in fresh})
        print(
            f"graftlint: {len(fresh)} finding(s) in {n_files} file(s) "
            f"({len(findings) - len(fresh)} baselined)"
        )
        if args.check:
            # --check is the CI gate: surface where the wall time goes
            # and that the taint fixpoint converged (vs hit its cap)
            passes = "  ".join(
                f"{k}={v:.2f}s" for k, v in timings.items()
            )
            print(
                f"graftlint: passes: {passes}  "
                f"(dataflow fixpoint: {iterations} iteration(s))"
            )
    return 1 if (args.check and fresh) else 0


if __name__ == "__main__":
    sys.exit(main())
