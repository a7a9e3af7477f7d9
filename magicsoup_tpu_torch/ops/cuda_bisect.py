"""
The integrator's lowering ladder (``csrc/bisect.cu``): each rung one
sub-expression of the integrator's body as its own CUDA kernel, its
checked wrapper, its plain PyTorch version and its contract.

The ladder replaces the JAX package's Pallas bisection ladder
(``performance/pallas_bisect.py``, ``call()`` around ``pl.pallas_call``):
rungs 1-8 are sub-expressions of the body, 9-11 the velocity body, one
trim pass and three trim passes.  Every rung runs on one skeleton, the
integrator kernel's own (``csrc/integrate_body.cuh``: a tile of 8 cells
per CTA, a warp per cell, the rung's parameter groups staged into shared
memory under the integrator's launch plan restricted to them, lanes over
proteins for the sums over signals and over signals for the sums over
proteins), so a rung's time is what its sub-expression costs inside the
integrator.  Rungs 12-13 of the ladder are the production entry
:func:`~magicsoup_tpu_torch.ops.cuda_integrate.integrate_signals_cuda`
itself and live in :mod:`magicsoup_tpu_torch.performance.kernel_bisect`.

:func:`run_rung` takes a rung number, ``X`` ``(c, s)`` and the nine
parameter tensors ``(c, ...)``, and checks the inputs that the rung
reads.  On CUDA tensors it launches the rung's kernel once on the current
stream without synchronizing and adds one to :data:`launches`; it raises
on anything the kernel does not take, and never falls back.  On CPU
tensors it runs the rung's plain version, :func:`plain_rung`, built from
the helpers of :mod:`magicsoup_tpu_torch.ops.integrate` as each JAX rung
is built from the JAX helpers.  The plain versions of rungs 10-11 run per
tile of ``TILE_C`` cells, the unit of the kernel's early stop.
:func:`rung_plan` is a rung's launch plan and :func:`occupancy` its CTAs
per SM and waves on the card.
"""
import ctypes
import functools
import operator
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from magicsoup_tpu_torch._build import build_shared
from magicsoup_tpu_torch.ops.cuda_integrate import (
    GROUPS,
    NVCC_FLAGS,
    TILE_C,
    Plan,
    nvcc,
    plan,
    smem_limit,
)
from magicsoup_tpu_torch.ops.integrate import (
    INT_PARAM_DTYPE,
    TRIM_FACTORS,
    CellParams,
    _integrate_part,
    _prod_pow,
    _safe_log,
    _velocities,
    group_rows,
)

#: kernel launches so far (a plain count; set it to 0 to start a window)
launches = 0

SRC = Path(__file__).resolve().parents[1] / "csrc" / "bisect.cu"

_LIB = None
_LIB_LOCK = threading.Lock()

ALL_PARAMS = CellParams._fields
#: what the velocity body reads: every parameter but Ke, which only the
#: equilibrium correction of a trim pass reads
VELOCITY_PARAMS = tuple(n for n in ALL_PARAMS if n != "Ke")
#: each parameter tensor's launch-plan group bit
GROUP_BIT = {name: bit for names, bit in GROUPS for name in names.split("/")}


class Rung(NamedTuple):
    """One rung: the JAX body it ports, what it probes, the parameter
    tensors it reads besides ``X``, its output's last axis (``"s"``
    signals or ``"p"`` proteins) and its contract (:func:`holds`)."""

    body: str
    title: str
    reads: tuple[str, ...]
    out: str
    contract: str


#: the kernel rungs, numbered as in performance/pallas_bisect.py
RUNGS = {
    1: Rung("k_copy", "copy (known-good baseline)", (), "s", "bit-equal"),
    2: Rung("k_i16_load", "i16 load + cast + sum", ("N",), "s", "bit-equal"),
    3: Rung("k_explog", "exp/log elementwise", (), "s", "rel 1e-5"),
    4: Rung("k_reduce_sum", "reduce_sum over signals (log-space core)", ("N",), "p", "rel 1e-5"),
    5: Rung("k_prod_pow", "full _prod_pow (exp-sum-log)", ("N",), "p", "rel 1e-5"),
    6: Rung("k_float_pow", "float-exponent pow, summed over signals", ("A",), "p", "rel 1e-5"),
    7: Rung("k_unrolled_prod", "unrolled multiply-chain prod", (), "s", "bit-equal"),
    8: Rung("k_reduce_prod", "product reduction over signals", (), "s", "rel 1e-5"),
    9: Rung("k_velocities", "fast-mode velocities body", VELOCITY_PARAMS, "s", "q99 1e-4"),
    10: Rung("k_full_part", "fast-mode full trim pass", ALL_PARAMS, "s", "fast"),
    11: Rung("k_full_3trim", "fast-mode full 3-trim kernel", ALL_PARAMS, "s", "fast"),
}


def group_bits(rung: int) -> int:
    """The launch plan's groups (bits) that rung ``rung`` reads."""
    bits = 0
    for name in RUNGS[rung].reads:
        bits |= GROUP_BIT[name]
    return bits


def build() -> Path:
    """Build the ladder's shared library (once per source and header);
    its path.  The compiler's report is kept beside it as
    ``<library>.log``."""
    return build_shared("libmsbisect", SRC, [nvcc(), *NVCC_FLAGS], timeout=600)


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ms_bisect_rung.argtypes = [ci] + [vp] * 11 + [ci] * 4 + [vp]
            lib.ms_bisect_rung.restype = ci
            lib.ms_bisect_smem_bytes.argtypes = [ci, ci, ci, ci]
            lib.ms_bisect_smem_bytes.restype = ctypes.c_size_t
            lib.ms_bisect_ctas_per_sm.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
            lib.ms_bisect_ctas_per_sm.restype = ci
            lib.ms_bisect_rung_groups.argtypes = [ci]
            lib.ms_bisect_rung_groups.restype = ci
            lib.ms_bisect_tile_c.restype = ci
            lib.ms_bisect_error_string.argtypes = [ci]
            lib.ms_bisect_error_string.restype = ctypes.c_char_p
            if lib.ms_bisect_tile_c() != TILE_C:
                raise RuntimeError("ladder kernel and wrapper disagree on TILE_C")
            if any(lib.ms_bisect_rung_groups(r) != group_bits(r) for r in RUNGS):
                raise RuntimeError("ladder kernel and wrapper disagree on the rungs' groups")
            _LIB = lib
    return _LIB


def out_shape(rung: int, X: torch.Tensor, params: CellParams) -> tuple[int, int]:
    """The rung's output shape, ``(c, s)`` or ``(c, p)``."""
    c, s = X.shape
    return (c, params.Ke.shape[-1] if RUNGS[rung].out == "p" else s)


def _check(rung: int, X: torch.Tensor, params: CellParams) -> None:
    """Validate ``X`` ``(c, s)`` and the parameter tensors the rung reads
    (``(c, p)`` or ``(c, p, s)``, contiguous, on X's device)."""
    if rung not in RUNGS:
        raise ValueError(f"no ladder rung {rung} (want one of {sorted(RUNGS)})")
    if X.ndim != 2:
        raise ValueError(f"X must be (cells, signals), got {tuple(X.shape)}")
    if X.dtype != torch.float32:
        raise TypeError(f"X must be {torch.float32}, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    c, s = X.shape
    if s == 0:
        raise ValueError("X must have at least one signal")
    if c % TILE_C != 0:
        raise ValueError(f"the ladder runs tiles of {TILE_C} cells, and {TILE_C} does not divide {c}")
    p = params.Ke.shape[-1]
    for name in RUNGS[rung].reads:
        t = getattr(params, name)
        per_signal = name in ("Kmr", "N", "Nf", "Nb", "A")
        shape = (c, p, s) if per_signal else (c, p)
        dtype = INT_PARAM_DTYPE if name in ("N", "Nf", "Nb", "A") else torch.float32
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def rung_plan(rung: int, p: int, s: int, limit: int) -> Plan:
    """Rung ``rung``'s launch plan for (p, s) under ``limit`` bytes of
    shared memory per CTA: the integrator's plan restricted to the groups
    the rung reads (every group for rungs 9-11, so theirs is the
    integrator's), held against the ladder kernel's own layout."""
    got = plan(p, s, limit, group_bits(rung))
    kernel_bytes = _lib().ms_bisect_smem_bytes(rung, p, s, got.mask)
    if kernel_bytes != got.smem_bytes:
        raise RuntimeError(
            f"launch plan and ladder kernel disagree on the shared memory of rung {rung}"
            f" at {p} x {s} with groups {got.resident}: {got.smem_bytes} vs {kernel_bytes} bytes"
        )
    return got


def occupancy(rung: int, X: torch.Tensor, params: CellParams) -> dict:
    """Rung ``rung`` on CUDA ``X`` ``(c, s)``: its dynamic shared memory
    per CTA, the CTAs one SM holds at it (the CUDA occupancy calculator)
    and the waves its grid of ``c / TILE_C`` CTAs takes on the card."""
    c, s = X.shape
    p = params.Ke.shape[-1]
    how = rung_plan(rung, p, s, smem_limit(X.device.index))
    ctas = ctypes.c_int(0)
    with torch.cuda.device(X.device):
        err = _lib().ms_bisect_ctas_per_sm(rung, p, s, how.mask, ctypes.byref(ctas))
        sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    if err != 0:
        raise RuntimeError(f"occupancy query failed: {_lib().ms_bisect_error_string(err).decode()}")
    if ctas.value == 0:
        raise RuntimeError(f"no CTA of ladder rung {rung} at {p} x {s} fits on an SM")
    waves = c / TILE_C / (ctas.value * sms)
    return {"smem_bytes": how.smem_bytes, "ctas_per_sm": ctas.value, "waves": waves}


def _launch(rung: int, X: torch.Tensor, params: CellParams, streamed: bool) -> torch.Tensor:
    c, s = X.shape
    p = params.Ke.shape[-1]
    lib = _lib()
    mask = 0 if streamed else rung_plan(rung, p, s, smem_limit(X.device.index)).mask
    out = torch.empty(out_shape(rung, X, params), dtype=torch.float32, device=X.device)
    reads = RUNGS[rung].reads
    ptrs = [getattr(params, n).data_ptr() if n in reads else None for n in ALL_PARAMS]
    Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A = ptrs
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.ms_bisect_rung(
            rung, X.data_ptr(), Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A,
            out.data_ptr(), c, p, s, mask, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ladder rung {rung} launch failed: {lib.ms_bisect_error_string(err).decode()}"
        )
    return out


def plain_rung(rung: int, X: torch.Tensor, params: CellParams) -> torch.Tensor:
    """The rung's plain PyTorch version on ``X`` ``(c, s)``: the same
    expression as the JAX rung body, from the port's integrator helpers."""
    if rung == 1:
        return X * 1.000001
    if rung == 2:
        return X + params.N.to(torch.float32).sum(-2)
    if rung == 3:
        return torch.exp(torch.log(X + 1.0)) - 1.0
    if rung == 4:
        return (params.N.to(torch.float32) * _safe_log(X).unsqueeze(-2)).sum(-1)
    if rung == 5:
        return _prod_pow(_safe_log(X), params.N)
    if rung == 6:
        return torch.pow(X.unsqueeze(-2) + 1.0, params.A.to(torch.float32)).sum(-1)
    if rung == 7:
        return functools.reduce(operator.mul, X.unbind(-1)).unsqueeze(-1) + 0.0 * X
    if rung == 8:
        return X.prod(-1, keepdim=True) + 0.0 * X
    if rung == 9:
        V = _velocities(X, params.Vmax, params, det=False)
        return X + (params.N.to(torch.float32) * V.unsqueeze(-1)).sum(-2)
    if rung in (10, 11):
        trims = TRIM_FACTORS[:1] if rung == 10 else TRIM_FACTORS
        tiles = CellParams(*(group_rows(t, TILE_C) for t in params))
        Y = group_rows(X, TILE_C)
        for trim in trims:
            Y = _integrate_part(Y, torch.clamp(tiles.Vmax * trim, min=0.0), tiles, det=False)
        return Y.reshape(X.shape)
    raise ValueError(f"no ladder rung {rung} (want one of {sorted(RUNGS)})")


def run_rung(
    rung: int, X: torch.Tensor, params: CellParams, streamed: bool = False
) -> torch.Tensor:
    """Rung ``rung`` (1-11) on ``X`` ``(c, s)`` and parameters
    ``(c, ...)``: one kernel launch on CUDA tensors, the plain version on
    CPU tensors.  The launch stages the rung's groups under its launch
    plan, or with ``streamed`` none of them (every parameter read from
    device memory, as the plan leaves a group that does not fit), which
    changes no bit: the ladder prices the staging with it."""
    global launches
    _check(rung, X, params)
    if X.device.type == "cpu":
        return plain_rung(rung, X, params)
    if X.device.type != "cuda":
        raise ValueError(f"no ladder kernel for device {X.device}")
    out = _launch(rung, X, params, streamed)
    launches += 1
    return out


def scale(rung: int, X: torch.Tensor, params: CellParams, ref: torch.Tensor) -> torch.Tensor:
    """What a rung's error is relative to: ``|ref|``, except for rung 4,
    a sum over signals that cancels (its result can be far smaller than
    its terms), whose error is relative to the sum of its terms'
    magnitudes, the scale its rounding follows."""
    if rung == 4:
        terms = params.N.to(torch.float32) * _safe_log(X).unsqueeze(-2)
        return terms.abs().sum(-1)
    return ref.abs()


def holds(contract: str, out: torch.Tensor, ref: torch.Tensor, denom: torch.Tensor) -> tuple[bool, dict]:
    """Whether ``out`` holds ``ref`` under ``contract``; the errors.

    - ``bit-equal``: equal bits (exact IEEE products, integer sums, one
      fixed product order);
    - ``rel 1e-5``: max ``|out - ref| / denom`` < 1e-5 (expf, logf and
      powf round differently, and the summation or product order
      differs);
    - ``q99 1e-4``: all finite; 99th-percentile ``|out - ref| / (|ref| +
      1e-6)`` < 1e-4;
    - ``fast``: the fast contract, finite and >= 0, 99th-percentile
      relative error < 1e-4, max < 0.15 (a borderline cell may take a
      different 0.0625-granular equilibrium correction).
    """
    # graftlint: disable=GL003 f64 error metric of a check, no simulation state
    out, ref = out.double(), ref.double()
    diff = (out - ref).abs()
    err = {"max_abs_err": float(diff.max()) if diff.numel() else 0.0}
    if contract == "bit-equal":
        return bool(torch.equal(out, ref)), err
    if contract == "rel 1e-5":
        # graftlint: disable=GL003 f64 error metric of a check, no simulation state
        rel = diff / denom.double().clamp(min=torch.finfo(torch.float32).tiny)
        err["max_rel_err"] = float(rel.max())
        return err["max_rel_err"] < 1e-5, err
    rel = diff / (ref.abs() + 1e-6)
    err["q99_rel_err"] = float(torch.quantile(rel.flatten().float(), 0.99))
    err["max_rel_err"] = float(rel.max())
    finite = bool(torch.isfinite(out).all())
    if contract == "q99 1e-4":
        return finite and err["q99_rel_err"] < 1e-4, err
    if contract == "fast":
        ok = finite and bool((out >= 0).all()) and err["q99_rel_err"] < 1e-4
        return ok and err["max_rel_err"] < 0.15, err
    raise ValueError(f"unknown contract {contract!r}")
