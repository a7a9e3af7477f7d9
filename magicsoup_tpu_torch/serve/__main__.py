"""CLI entry: ``python -m magicsoup_tpu_torch.serve --dir DIR [--port P]
[--device D]``.  Counterpart of :mod:`magicsoup_tpu.serve.__main__`.

Builds the native libraries the device runs (on the card: the CUDA
kernels and the genome engine, through
:func:`magicsoup_tpu_torch.cache.ensure_compile_cache`), binds the HTTP
front end, prints ONE machine-readable ready line
(``{"serve": "ready", "port": ..., "tenants": ...}``) to stdout, then runs
the scheduler loop on the main thread so SIGTERM/SIGINT take the graceful
drain-checkpoint-exit path.  A directory holding a previous life's
registry is recovered before the ready line prints; its ``tenants`` count
is the number of re-adopted worlds.  ``--device`` defaults to the card,
and without one the command fails naming ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m magicsoup_tpu_torch.serve")
    parser.add_argument("--dir", required=True, help="service directory")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--block", type=int, default=4)
    parser.add_argument(
        "--policy",
        default="warn",
        choices=("warn", "quarantine"),
        help="warden policy for tenant trips ('heal' is not served: "
        "roll tenants back via POST /tenants/<id>/restore)",
    )
    parser.add_argument("--keep", type=int, default=3)
    parser.add_argument(
        "--compile-budget",
        type=int,
        default=None,
        help="admission compile allowance (default: unlimited)",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="where the worlds live (default: the CUDA card; 'cpu' to run without one)",
    )
    args = parser.parse_args(argv)
    from magicsoup_tpu_torch.cache import ensure_compile_cache
    from magicsoup_tpu_torch.serve.service import FleetService

    try:
        ensure_compile_cache(args.device)
    except RuntimeError as exc:
        if args.device is None:
            parser.exit(2, f"{parser.prog}: {exc}; pass --device cpu to run on the CPU\n")
        raise
    service = FleetService(
        args.dir,
        host=args.host,
        port=args.port,
        block=args.block,
        policy=args.policy,
        keep=args.keep,
        compile_budget=args.compile_budget,
        device=args.device,
    )
    service.serve_http()
    print(
        json.dumps(
            {
                "serve": "ready",
                "port": service.port,
                "tenants": len(service._tenants),
            }
        ),
        flush=True,
    )
    service.run()
    print(json.dumps({"serve": "stopped"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
