"""
Command line for recorder telemetry files::

    python -m magicsoup_tpu_torch.telemetry summarize run.jsonl [--json]
    python -m magicsoup_tpu_torch.telemetry validate run.jsonl
    python -m magicsoup_tpu_torch.telemetry trace run.jsonl run.trace.json

``summarize`` prints per-phase p50/p95 timings and counter deltas
(``--json`` for the machine-readable aggregate); ``validate`` exits
nonzero listing every schema problem; ``trace`` converts recorder span
rows to Chrome trace-event JSON (load in ``chrome://tracing`` or
Perfetto; the timeline is synthetic, see :mod:`.trace`).  All three run
the schema validation, so a smoke test can gate on exit codes alone.

Imports stay stdlib-only (``summary``/``trace``): processing a capture
never initializes a device.
"""
import argparse
import json
import sys

from magicsoup_tpu_torch.telemetry.summary import (
    format_summary,
    read_jsonl,
    summarize_rows,
    validate_rows,
)
from magicsoup_tpu_torch.telemetry.trace import rows_to_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m magicsoup_tpu_torch.telemetry")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize", help="per-phase p50/p95 + deltas")
    p_sum.add_argument("path")
    p_sum.add_argument("--json", action="store_true", dest="as_json")
    p_val = sub.add_parser("validate", help="schema-check a JSONL file")
    p_val.add_argument("path")
    p_tr = sub.add_parser(
        "trace", help="convert spans to Chrome trace-event JSON"
    )
    p_tr.add_argument("path")
    p_tr.add_argument("out")
    args = ap.parse_args(argv)

    try:
        rows = read_jsonl(args.path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    problems = validate_rows(rows)
    if problems:
        for p in problems:
            print(f"invalid: {p}", file=sys.stderr)
        return 1
    if args.cmd == "validate":
        print(f"{args.path}: {len(rows)} rows, schema OK")
        return 0
    if args.cmd == "trace":
        doc = rows_to_trace(rows)
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.write("\n")
        print(
            f"{args.out}: {len(doc['traceEvents'])} events from "
            f"{doc['otherData']['dispatches']} dispatches"
        )
        return 0
    summary = summarize_rows(rows)
    if args.as_json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(format_summary(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
