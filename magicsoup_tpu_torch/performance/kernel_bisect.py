"""
The integrator's lowering ladder on the card: the port of
``performance/pallas_bisect.py``.

Rungs 1-11 are the kernels of ``csrc/bisect.cu`` (sub-expressions of the
integrator body, then the velocity body, one and three trim passes; see
:mod:`magicsoup_tpu_torch.ops.cuda_bisect`); rungs 12-13 are the
production entry :func:`~magicsoup_tpu_torch.ops.cuda_integrate.
integrate_signals_cuda`: 12 on B = 3 worlds (X scaled by 1 + 0.5 w, the
parameters materialized per world), 13 with the tile that the tile table
picks.  The inputs are drawn exactly as the JAX ladder draws them, so the
two ladders see the same numbers.

On the card each rung launches, synchronizes, and is held against its
plain version under its contract (rung 11 also bit-equal to the
integrator kernel, each world of rung 12 bit-equal to its own one-world
launch); then its median time over 25 launches (CUDA events), the plain
version's, the bytes it must move (its inputs read once and its output
written once), their time at 3.35 TB/s, for rungs 1, 7 and 8 the time of
the one PyTorch call that computes the same function, and for the kernel
rungs 1-11 the dynamic shared memory of a CTA, the CTAs one SM holds at
it (the CUDA occupancy calculator) and the waves of the grid.  A kernel
rung that stages parameter groups (2, 4-6, 9-11) also runs streamed,
with no group staged: its output must equal the staged launch's bit for
bit, and the two are timed in turns (staged, streamed, streamed, staged),
which prices the staging.  A rung that
fails prints FAIL with the first line of its error and the ladder goes on;
the run exits 1 if any rung failed.  With ``--device cpu`` it runs the
plain versions only (host clock).  One line per rung, then one JSON
summary line.

    python -m magicsoup_tpu_torch.performance.kernel_bisect [--rungs 1,2,9]
    python -m magicsoup_tpu_torch.performance.kernel_bisect --device cpu
"""
import argparse
import json
import statistics
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from magicsoup_tpu_torch.interop import params_from_numpy
from magicsoup_tpu_torch.ops import cuda_bisect as cb
from magicsoup_tpu_torch.ops import cuda_integrate as ci
from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.util import to_device
from magicsoup_tpu_torch.performance import (
    HBM_BYTES_PER_S,
    card_line,
    cuda_median_ms,
    device_name,
)

KERNEL_REPS = 25
PLAIN_REPS = 5
#: worlds of rung 12
BATCH = 3


def draw_inputs(c: int, p: int, s: int) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """The JAX ladder's inputs (``performance/pallas_bisect.py:75-88``):
    ``default_rng(0)``, X first, then Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb,
    A."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 4, (c, s)).astype(np.float32)
    d = {}
    for name in ("Ke", "Kmf", "Kmb"):
        d[name] = rng.uniform(0.1, 10, (c, p)).astype(np.float32)
    d["Kmr"] = rng.uniform(0.1, 10, (c, p, s)).astype(np.float32)
    d["Vmax"] = rng.uniform(0, 2, (c, p)).astype(np.float32)
    d["N"] = rng.integers(-2, 3, (c, p, s)).astype(np.int16)
    d["Nf"] = rng.integers(0, 3, (c, p, s)).astype(np.int16)
    d["Nb"] = rng.integers(0, 3, (c, p, s)).astype(np.int16)
    d["A"] = rng.integers(-2, 3, (c, p, s)).astype(np.int16)
    return X, d


def batched(X: torch.Tensor, params: CellParams) -> tuple[torch.Tensor, CellParams]:
    """Rung 12's inputs: ``BATCH`` worlds, world w's X scaled by
    ``1 + 0.5 w``, the parameters materialized per world (the kernel
    takes whole rows per world, not a stride-0 broadcast)."""
    scale = 1.0 + 0.5 * torch.arange(BATCH, dtype=torch.float32, device=X.device)
    Xb = X[None] * scale[:, None, None]
    pb = CellParams(*(t[None].expand((BATCH,) + t.shape).contiguous() for t in params))
    return Xb, pb


class Step(NamedTuple):
    """One rung as the ladder runs it."""

    title: str
    contract: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    denom: Callable[[torch.Tensor], torch.Tensor]
    n_bytes: int
    library: Callable[[], torch.Tensor] | None
    streamed: Callable[[], torch.Tensor] | None = None


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def steps(X: torch.Tensor, params: CellParams) -> dict[int, Step]:
    """Rungs 1-13 on ``X`` ``(c, s)`` and its parameters."""
    out = {}
    for r, rung in cb.RUNGS.items():
        shape = cb.out_shape(r, X, params)
        read = [getattr(params, n) for n in rung.reads]
        out[r] = Step(
            title=rung.title,
            contract=rung.contract,
            kernel=lambda r=r: cb.run_rung(r, X, params),
            plain=lambda r=r: cb.plain_rung(r, X, params),
            denom=lambda ref, r=r: cb.scale(r, X, params, ref),
            n_bytes=_nbytes(X, *read) + shape[0] * shape[1] * 4,
            library={
                1: lambda: X * 1.000001,
                7: lambda: torch.prod(X, -1, keepdim=True),
                8: lambda: torch.prod(X, -1, keepdim=True),
            }.get(r),
            streamed=(lambda r=r: cb.run_rung(r, X, params, streamed=True))
            if cb.group_bits(r) else None,
        )
    Xb, pb = batched(X, params)
    X1, p1 = X[None], CellParams(*(t[None] for t in params))
    out[12] = Step(
        title=f"batched grid (production entry, B={BATCH})",
        contract="fast",
        kernel=lambda: ci.integrate_signals_cuda(Xb, pb, tile_c=ci.TILE_C),
        plain=lambda: ci.integrate_signals_tiled(Xb, pb, ci.TILE_C),
        denom=torch.abs,
        n_bytes=2 * _nbytes(Xb) + _nbytes(*pb),
        library=None,
    )
    out[13] = Step(
        title="tile table default (production entry)",
        contract="fast",
        kernel=lambda: ci.integrate_signals_cuda(X1, p1)[0],
        plain=lambda: ci.integrate_signals_tiled(X1, p1, ci.select_tile_c(X.shape[0]))[0],
        denom=torch.abs,
        n_bytes=2 * _nbytes(X) + _nbytes(*params),
        library=None,
    )
    return out


def _bit_checks(r: int, got: torch.Tensor, X: torch.Tensor, params: CellParams) -> dict:
    """Rung 11 bit-equal to the integrator kernel on the same inputs;
    each world of rung 12 bit-equal to its own one-world launch."""
    if r == 11:
        k1 = ci.integrate_signals_cuda(X[None], CellParams(*(t[None] for t in params)))[0]
        return {"bit_equal_to_integrator": bool(torch.equal(got, k1))}
    if r == 12:
        Xb, pb = batched(X, params)
        solo = [
            ci.integrate_signals_cuda(Xb[w : w + 1], CellParams(*(t[w : w + 1] for t in pb)))[0]
            for w in range(BATCH)
        ]
        return {"worlds_bit_equal_to_solo": [bool(torch.equal(got[w], solo[w])) for w in range(BATCH)]}
    return {}


def _run_cuda(r: int, step: Step, X: torch.Tensor, params: CellParams) -> dict:
    got = step.kernel()
    torch.cuda.synchronize()
    ref = step.plain()
    ok, row = cb.holds(step.contract, got, ref, step.denom(ref))
    checks = _bit_checks(r, got, X, params)
    for v in checks.values():
        ok = ok and (all(v) if isinstance(v, list) else v)
    row.update(checks)
    if r in cb.RUNGS:
        row.update(cb.occupancy(r, X, params))
    if step.streamed is None:
        row["ms"] = cuda_median_ms(step.kernel, KERNEL_REPS)
    else:
        row["streamed_bit_equal"] = bool(torch.equal(step.streamed(), got))
        ok = ok and row["streamed_bit_equal"]
        times = [cuda_median_ms(f, KERNEL_REPS)
                 for f in (step.kernel, step.streamed, step.streamed, step.kernel)]
        row["ms"], row["streamed_ms"] = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
    row["plain_ms"] = cuda_median_ms(step.plain, PLAIN_REPS)
    row["library_ms"] = cuda_median_ms(step.library, KERNEL_REPS) if step.library else None
    if not ok:
        raise AssertionError(f"rung {r} does not hold its plain version ({step.contract}): {row}")
    return row


def _run_cpu(step: Step) -> dict:
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = step.plain()
        times.append((time.perf_counter() - t0) * 1e3)
    if got.dtype != torch.float32:
        raise AssertionError(f"plain version gave {got.dtype}")
    return {"plain_host_ms": statistics.median(times)}


def run_ladder(
    c: int, p: int, s: int, rungs=None, device: str = "cuda", log=print
) -> tuple[list[dict], bool]:
    """Run the ladder at ``(c, p, s)`` on ``device``; one row per rung
    and whether every rung passed."""
    dev = torch.device(device)
    X_np, d = draw_inputs(c, p, s)
    X = to_device(X_np, dev)
    params = params_from_numpy(d, dev)
    table = steps(X, params)
    rows = []
    for r in sorted(table) if rungs is None else rungs:
        step = table[r]
        row = {"rung": r, "name": cb.RUNGS[r].body if r in cb.RUNGS else f"production_{r}",
               "title": step.title, "contract": step.contract, "bytes": step.n_bytes,
               "bound_ms": step.n_bytes / HBM_BYTES_PER_S * 1e3}
        t0 = time.perf_counter()
        try:
            row.update(_run_cuda(r, step, X, params) if dev.type == "cuda" else _run_cpu(step))
            row["ok"] = True
        except Exception as e:  # noqa: BLE001 - report the rung and go on (the ladder's purpose)
            head = str(e).splitlines()[0][:200] if str(e) else repr(e)[:200]
            row.update(ok=False, error=head)
        wall = time.perf_counter() - t0
        if row["ok"] and dev.type == "cuda":
            occ = (f", {row['ctas_per_sm']} CTAs/SM, {row['waves']:.3f} waves"
                   if "waves" in row else "")
            occ += f", streamed {row['streamed_ms']:.4f} ms" if "streamed_ms" in row else ""
            log(f"rung {r:2d} OK    {wall:6.2f}s  {step.title}: {row['ms']:.4f} ms,"
                f" plain {row['plain_ms']:.4f} ms, {row['bytes']} B, bound {row['bound_ms']:.4f} ms,"
                f" library {row['library_ms']}{occ}")
        elif row["ok"]:
            log(f"rung {r:2d} OK    {wall:6.2f}s  {step.title}: plain version only,"
                f" {row['plain_host_ms']:.3f} ms on the host clock (cpu)")
        else:
            log(f"rung {r:2d} FAIL  {wall:6.2f}s  {step.title}\n        {row['error']}")
            if dev.type == "cuda":
                log("        (a CUDA fault is sticky: if this was one, every later rung fails with it)")
        rows.append(row)
    return rows, all(row["ok"] for row in rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=256)
    ap.add_argument("--proteins", type=int, default=8)
    ap.add_argument("--signals", type=int, default=12)
    ap.add_argument("--tile-c", type=int, default=ci.TILE_C)
    ap.add_argument("--rungs", type=str, default=None,
                    help="comma-separated rung numbers (default: all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.tile_c != ci.TILE_C:
        ap.error(f"the kernels run tiles of {ci.TILE_C} cells, not {args.tile_c}")
    rungs = sorted(int(r) for r in args.rungs.split(",")) if args.rungs else None
    if rungs and not set(rungs) <= set(range(1, 14)):
        ap.error(f"rungs are 1-13, got {args.rungs}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("kernel_bisect: no CUDA device; pass --device cpu for the plain versions",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"card {card_line()}", flush=True)
    else:
        print("device cpu: the plain versions only (no kernel runs without a card)")
    shape = {"c": args.cells, "p": args.proteins, "s": args.signals, "tile_c": args.tile_c}
    rows, ok = run_ladder(args.cells, args.proteins, args.signals, rungs, args.device,
                          log=lambda line: print(line, flush=True))
    print("summary:", " ".join(f"{row['rung']}:{'OK' if row['ok'] else 'FAIL'}" for row in rows))
    print(json.dumps({"kernel_bisect": {"device": device_name(dev), "shape": shape,
                                        "ok": ok, "rungs": rows}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
