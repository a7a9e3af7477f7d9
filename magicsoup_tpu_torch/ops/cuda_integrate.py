"""
The integrator's hand-written CUDA kernel (``csrc/integrate.cu``), its
wrapper, its tile table and its plain PyTorch version.

The kernel replaces the JAX package's Pallas kernel
(:func:`magicsoup_tpu.ops.pallas_integrate.integrate_signals_pallas`): the
fast-mode integrator over tiles of ``TILE_C = 8`` cells, with the
equilibrium correction's early stop voted per tile.  The tile size is part
of the observable numerics (cells stop with their tile-mates), so the
plain version takes the same tile.  Its grid is ``(c / TILE_C, B)`` over B
worlds (the Pallas batched grid ``(B, c // tile_c)``; one world is the
solo grid); a tile never crosses a world, so world w's result equals a
B = 1 launch on its slice.

:func:`integrate_signals_cuda` takes ``X`` ``(B, c, s)`` and parameters
``(B, c, ...)``; each parameter may be the live-row prefix of a ``(B, cap,
...)`` stack: the kernel takes the world stride, so nothing is copied.  On
CUDA tensors it launches the kernel once for all B worlds on the current
stream without synchronizing, and adds one to :data:`launches`; it raises
on anything the kernel does not take, and never falls back.  On CPU
tensors it runs the plain version, :func:`integrate_signals_tiled`: the
shared body of :mod:`magicsoup_tpu_torch.ops.integrate` with a leading
tile axis.

:func:`integrate_signals_cuda_grouped` runs several such groups of worlds
(a fused fleet step's rungs, each with its own rows, proteins, signals and
world stride) in one launch of the grouped kernel, whose grid is flattened
over every tile of every group; each world computes exactly what its
group's own launch computes.  It counts in :data:`grouped_launches`, one
per launch: one for the groups on the resident route and one for the
others, each of at most :data:`MAX_GROUPS` groups.

Each warp walks its cell's own proteins: the kernel scans the cell's
parameter rows for its extent, one past its last protein slot that is not
inert (``csrc/integrate_body.cuh``), and its passes walk only the slots
below it; the output is that of the walk over all p slots, bit for bit.
Every launch adds the sum of the cells' extents and the slots its tiles
walk (``TILE_C`` times each tile's largest extent) to the device counters
:data:`SLOT_COUNTERS` (:func:`~magicsoup_tpu_torch.telemetry.recorder.device_counter`),
read where the telemetry's counter totals are.

The kernel stages each tile's parameters in shared memory for the whole
step.  :func:`plan` chooses, per (p, s), which parameter groups are
resident and how many bytes a CTA takes; the C side computes the same
layout, and the wrapper raises if the two disagree.  Every group is
resident at the workload's shapes; a shape whose tile does not fit keeps
its least-read groups in device memory, so no shape is refused whose
scratch alone fits.

The kernel is built from the repo's source with ``nvcc`` at first use
(:mod:`magicsoup_tpu_torch._build`), into a plain shared library loaded
with ctypes.
"""
import ctypes
import functools
import os
import shutil
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from magicsoup_tpu_torch._build import build_shared
from magicsoup_tpu_torch.ops.integrate import (
    INT_PARAM_DTYPE,
    CellParams,
    group_rows,
    integrate_grouped,
)

#: cells per CTA (one warp each) and per early-stop vote
TILE_C = 8

#: kernel launches so far (a plain count; set it to 0 to start a window)
launches = 0

#: launches of the grouped kernel so far (:func:`integrate_signals_cuda_grouped`;
#: a plain count, apart from :data:`launches`)
grouped_launches = 0

#: groups one grouped launch takes (``MAX_GROUPS`` in ``csrc/integrate.cu``)
MAX_GROUPS = 16

#: the kernel's device counters: the cells' protein extents and the slots
#: the tiles walk, summed over launches
SLOT_COUNTERS = ("integrator.live_slots", "integrator.walked_slots")

SRC = Path(__file__).resolve().parents[1] / "csrc" / "integrate.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_LIB = None
_LIB_LOCK = threading.Lock()


#: the dynamic shared memory one CTA may take on an H100 (227 KB)
SMEM_LIMIT = 232_448

#: the launch plan's parameter groups and their bits, in the order the
#: plan stages them: by how often the body reads them (RES_* in
#: ``csrc/integrate_body.cuh``)
GROUPS = (
    ("N", 1),
    ("Nf", 2),
    ("Nb", 4),
    ("A", 8),
    ("Kmr", 16),
    ("Ke/Kmf/Kmb/Vmax", 32),
)
ALL_RESIDENT = 63


class SharedMemoryLimitError(ValueError):
    """The per-CTA scratch for (p, s) exceeds the card's shared memory."""


class Plan(NamedTuple):
    """How the kernel runs one (p, s): ``route`` is ``"resident"`` (every
    parameter group in shared memory), ``"partial"`` or ``"streamed"``
    (none: every group read from device memory); ``mask`` the resident
    groups' bits, ``resident`` their names, ``smem_bytes`` the dynamic
    shared memory of one CTA."""

    route: str
    mask: int
    resident: tuple[str, ...]
    smem_bytes: int


def smem_bytes(p: int, s: int, mask: int) -> int:
    """One CTA's dynamic shared memory for (p, s) with the groups of
    ``mask`` resident: per cell 4 signal and 4 protein vectors of
    scratch, then the resident groups, their (p, s) rows padded to an odd
    word stride (``tile_layout`` in ``csrc/integrate_body.cuh``)."""
    ld16 = s + (2 - s % 4) % 4
    ld32 = s | 1
    n = TILE_C * (4 * s + 4 * p) * 4
    if mask & 32:
        n += 4 * TILE_C * p * 4
    if mask & 16:
        n += TILE_C * p * ld32 * 4
    n += sum(TILE_C * p * ld16 * 2 for bit in (1, 2, 4, 8) if mask & bit)
    return n


def plan(p: int, s: int, limit: int = SMEM_LIMIT, groups: int = ALL_RESIDENT) -> Plan:
    """The launch plan for p proteins and s signals under ``limit`` bytes
    of shared memory per CTA: stage each group of :data:`GROUPS` whose bit
    is in ``groups`` (every group for the integrator; a ladder rung's own
    groups for the rung) in turn if it still fits.  Raises
    :class:`SharedMemoryLimitError` when not even the scratch fits."""
    mask = 0
    for _, bit in GROUPS:
        if bit & groups and smem_bytes(p, s, mask | bit) <= limit:
            mask |= bit
    need = smem_bytes(p, s, mask)
    if need > limit:
        raise SharedMemoryLimitError(
            f"{p} proteins x {s} signals need {need} bytes of shared memory"
            f" per tile of {TILE_C} cells; the card allows {limit}:"
            f" at most {max_proteins(s, limit)} proteins a cell fit at {s} signals."
            " The protein axis follows the longest proteome, so hold genome"
            " sizes down with a size-based kill (docs/tutorials.md, \"Genome size\")"
        )
    route = "resident" if mask == ALL_RESIDENT else ("partial" if mask else "streamed")
    names = tuple(name for name, bit in GROUPS if mask & bit)
    return Plan(route, mask, names, need)


def max_proteins(s: int, limit: int = SMEM_LIMIT) -> int:
    """The largest power-of-two protein count whose scratch (no group
    resident) fits ``limit`` bytes at ``s`` signals; 0 if none does.
    The parameter tensors' protein axis grows in powers of two, so this
    is the most the kernel takes."""
    if smem_bytes(1, s, 0) > limit:
        return 0
    p = 1
    while smem_bytes(2 * p, s, 0) <= limit:
        p *= 2
    return p


@functools.lru_cache(maxsize=None)
def _row_bytes(p: int, s: int, mask: int) -> tuple[int, int]:
    """Per row: the bytes of the six parameter groups as the kernel lays
    them out for (p, s), and those of the groups in ``mask``."""
    scratch = smem_bytes(p, s, 0)
    return ((smem_bytes(p, s, ALL_RESIDENT) - scratch) // TILE_C,
            (smem_bytes(p, s, mask) - scratch) // TILE_C)


def route_bytes(p: int, s: int, rows: int, mask: int) -> tuple[int, int]:
    """The parameter bytes of one launch over ``rows`` rows at (p, s), in
    the kernel's layout (rows padded to :func:`smem_bytes`' strides), and
    the share of them that a launch with the groups of ``mask`` resident
    stages in shared memory: ``(param_bytes, staged_bytes)``.  The rest
    is read from device memory."""
    param, staged = _row_bytes(p, s, mask)
    return rows * param, rows * staged


def select_tile_c(c: int) -> int:
    """The tile table: ``TILE_C`` when it divides the cell count ``c``.
    Live-row prefixes are multiples of 1024 or pow2 capacities >= 64, so
    8 always divides them; anything else is refused."""
    if c % TILE_C != 0:
        raise ValueError(
            f"no usable tile for {c} cells: the CUDA integrator runs tiles"
            f" of {TILE_C} cells, and {TILE_C} does not divide {c}"
        )
    return TILE_C


def integrate_signals_tiled(
    X: torch.Tensor, params: CellParams, tile_c: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the fast-mode integrator over
    tiles of ``tile_c`` cells, each tile with its own early stop.  ``X`` is
    ``(c, s)`` or ``(B, c, s)``, with the parameters' leading axes alike;
    a tile never crosses a world."""
    c, s = X.shape[-2:]
    if c % tile_c != 0:
        raise ValueError(f"cell count {c} not divisible by tile_c={tile_c}")
    lead = X.ndim - 1
    out = integrate_grouped(
        group_rows(X.reshape(-1, s), tile_c),
        CellParams(
            *(group_rows(t.reshape((-1,) + tuple(t.shape[lead:])), tile_c) for t in params)
        ),
        det=False,
    )
    return out.reshape(X.shape)


def nvcc() -> str:
    """The CUDA compiler: ``$NVCC``, ``nvcc`` on the path, or the
    toolkit's default location."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set NVCC or put nvcc on the PATH")


def build() -> Path:
    """Build the kernel's shared library (once per source and the
    headers it includes); its path.
    The compiler's report (``-Xptxas -v``) is kept beside it as
    ``<library>.log``."""
    return build_shared("libmsintegrate", SRC, [nvcc(), *NVCC_FLAGS], timeout=600)


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ms_integrate_signals.argtypes = (
                [vp] * 11 + [ci] * 4 + [ctypes.c_longlong, ci, vp, vp]
            )
            lib.ms_integrate_signals.restype = ci
            lib.ms_integrate_smem_bytes.argtypes = [ci, ci, ci]
            lib.ms_integrate_smem_bytes.restype = ctypes.c_size_t
            lib.ms_integrate_signals_grouped.argtypes = [
                ci, vp, vp, vp, vp, ctypes.POINTER(ci), vp
            ]
            lib.ms_integrate_signals_grouped.restype = ci
            lib.ms_max_groups.restype = ci
            lib.ms_grouped_ctas_per_sm.argtypes = [ci, ctypes.c_size_t, ctypes.POINTER(ci)]
            lib.ms_grouped_ctas_per_sm.restype = ci
            lib.ms_tile_c.restype = ci
            lib.ms_error_string.argtypes = [ci]
            lib.ms_error_string.restype = ctypes.c_char_p
            if lib.ms_tile_c() != TILE_C or lib.ms_max_groups() != MAX_GROUPS:
                raise RuntimeError("kernel and wrapper disagree on TILE_C or MAX_GROUPS")
            _LIB = lib
    return _LIB


def _check(X: torch.Tensor, params: CellParams) -> int:
    """Validate ``X`` ``(B, c, s)`` and the parameters ``(B, c, ...)``;
    returns the parameters' world stride in rows (each may be the c-row
    prefix of a ``(B, cap, ...)`` stack, rows contiguous)."""
    B, c, s = X.shape
    p = params.Ke.shape[-1]
    want = {
        "Ke": ((B, c, p), torch.float32),
        "Kmf": ((B, c, p), torch.float32),
        "Kmb": ((B, c, p), torch.float32),
        "Kmr": ((B, c, p, s), torch.float32),
        "Vmax": ((B, c, p), torch.float32),
        "N": ((B, c, p, s), INT_PARAM_DTYPE),
        "Nf": ((B, c, p, s), INT_PARAM_DTYPE),
        "Nb": ((B, c, p, s), INT_PARAM_DTYPE),
        "A": ((B, c, p, s), INT_PARAM_DTYPE),
    }
    if X.dtype != torch.float32:
        raise TypeError(f"X must be {torch.float32}, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    strides = set()
    for name, t in params._asdict().items():
        shape, dtype = want[name]
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if B == 0 or c == 0:
            continue
        row = t[0, 0].numel()
        if not t[0].is_contiguous():
            raise ValueError(f"{name} must be contiguous within each world")
        if B > 1 and (t.stride(0) % row or t.stride(0) < c * row):
            raise ValueError(f"{name} must hold whole rows per world")
        strides.add(t.stride(0) // row if B > 1 else c)
    if not strides:
        return c
    if len(strides) != 1:
        raise ValueError("the parameters disagree on their world stride")
    return strides.pop()


@functools.lru_cache(maxsize=None)
def smem_limit(device_index: int) -> int:
    """The card's dynamic shared memory per CTA (read once per device)."""
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def launch_plan(p: int, s: int, limit: int) -> Plan:
    """:func:`plan`, held against the kernel's own layout: raises if the C
    side's bytes for the plan's mask differ (once per (p, s, limit))."""
    got = plan(p, s, limit)
    kernel_bytes = _lib().ms_integrate_smem_bytes(p, s, got.mask)
    if kernel_bytes != got.smem_bytes:
        raise RuntimeError(
            f"launch plan and kernel disagree on the shared memory of {p} x {s}"
            f" with groups {got.resident}: {got.smem_bytes} vs {kernel_bytes} bytes"
        )
    return got


def _slot_counters(device: torch.device) -> torch.Tensor:
    """The device counters of :data:`SLOT_COUNTERS` that a launch on
    ``device`` adds to now."""
    from magicsoup_tpu_torch.telemetry import recorder

    return recorder.device_counter(SLOT_COUNTERS, device)


def _launch(X: torch.Tensor, params: CellParams, pstride: int) -> torch.Tensor:
    """Launch the kernel on ``X`` ``(B, c, s)`` (checked by :func:`_check`,
    whose world stride ``pstride`` is); the output tensor."""
    B, c, s = X.shape
    p = params.Ke.shape[-1]
    if B > 65535:
        raise ValueError(f"{B} worlds exceed the grid's 65535")
    lib = _lib()
    how = launch_plan(p, s, smem_limit(X.device.index))
    out = torch.empty_like(X)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.ms_integrate_signals(
            X.data_ptr(),
            params.Ke.data_ptr(),
            params.Kmf.data_ptr(),
            params.Kmb.data_ptr(),
            params.Kmr.data_ptr(),
            params.Vmax.data_ptr(),
            params.N.data_ptr(),
            params.Nf.data_ptr(),
            params.Nb.data_ptr(),
            params.A.data_ptr(),
            out.data_ptr(),
            B,
            c,
            p,
            s,
            pstride,
            how.mask,
            _slot_counters(X.device).data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"integrator kernel launch failed: {lib.ms_error_string(err).decode()}"
        )
    return out


def _route(X: torch.Tensor, tile_c: int | None) -> int:
    """The tile for ``X`` ``(..., c, s)``; raises where the kernel cannot
    run it on X's device."""
    c = X.shape[-2]
    if tile_c is None:
        tile_c = select_tile_c(c)
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no integrator kernel for device {X.device}")
    if X.device.type == "cuda" and tile_c != TILE_C:
        raise ValueError(f"the CUDA kernel runs tiles of {TILE_C} cells, not {tile_c}")
    return tile_c


def integrate_signals_cuda(
    X: torch.Tensor, params: CellParams, tile_c: int | None = None
) -> torch.Tensor:
    """
    One integrator step for B worlds: signals ``X`` (B, c, s), parameters
    (B, c, ...), possibly the c-row prefixes of (B, cap, ...) stacks, in
    tiles of ``tile_c`` cells of one world (default
    :func:`select_tile_c`).  CUDA tensors go through one launch of the
    kernel, which takes ``tile_c == TILE_C`` only; CPU tensors go through
    :func:`integrate_signals_tiled`.
    """
    global launches
    if X.ndim != 3:
        raise ValueError(f"X must be (worlds, cells, signals), got {tuple(X.shape)}")
    pstride = _check(X, params)
    tile_c = _route(X, tile_c)
    if X.device.type == "cpu":
        return integrate_signals_tiled(X, params, tile_c)
    out = _launch(X, params, pstride)
    launches += 1
    return out


class GroupedArgs(NamedTuple):
    """The C arrays of one grouped launch (``ms_integrate_signals_grouped``):
    11 pointers per group, ``(B, c, p, s, mask)`` per group and the
    groups' world strides.  The caller keeps the tensors alive."""

    n: int
    ptrs: object
    dims: object
    pstrides: object


def grouped_args(Xs, params_list, outs, masks, pstrides) -> GroupedArgs:
    """Pack the groups' pointers and shapes for the grouped entry."""
    n = len(Xs)
    ptrs = (ctypes.c_void_p * (11 * max(n, 1)))()
    dims = (ctypes.c_int * (5 * max(n, 1)))()
    strides = (ctypes.c_longlong * max(n, 1))()
    for k, (X, params, out, mask, pstride) in enumerate(
        zip(Xs, params_list, outs, masks, pstrides)
    ):
        B, c, s = X.shape
        tensors = (X, *params, out)
        for i, t in enumerate(tensors):
            ptrs[11 * k + i] = t.data_ptr()
        dims[5 * k : 5 * k + 5] = [B, c, params.Ke.shape[-1], s, mask]
        strides[k] = pstride
    return GroupedArgs(n, ptrs, dims, strides)


def grouped_occupancy(Xs, params_list) -> dict:
    """Per route of a grouped launch over these groups (``"resident"``,
    ``"other"``): the dynamic shared memory of its CTAs (the largest
    group's layout) and the CTAs one SM holds at it, from the CUDA
    occupancy calculator on the current card."""
    lib = _lib()
    dev = Xs[0].device
    limit = smem_limit(dev.index)
    need: dict[str, int] = {}
    for X, params in zip(Xs, params_list):
        how = launch_plan(params.Ke.shape[-1], X.shape[2], limit)
        route = "resident" if how.route == "resident" else "other"
        need[route] = max(need.get(route, 0), how.smem_bytes)
    out = {}
    with torch.cuda.device(dev):
        for route, smem in need.items():
            ctas = ctypes.c_int(0)
            err = lib.ms_grouped_ctas_per_sm(int(route == "resident"), smem, ctypes.byref(ctas))
            if err != 0:
                raise RuntimeError(f"occupancy query failed: {lib.ms_error_string(err).decode()}")
            out[route] = {"smem_bytes": smem, "ctas_per_sm": ctas.value}
    return out


def integrate_signals_cuda_grouped(Xs, params_list) -> list:
    """
    One integrator step for several groups of worlds at once: group g is
    ``Xs[g]`` (B_g, c_g, s_g) with ``params_list[g]`` (B_g, c_g, ...), each
    as :func:`integrate_signals_cuda` takes it (possibly the row prefixes
    of a stack), with its own worlds, rows, proteins and signals.  Returns
    the outputs in group order; world w of group g equals
    ``integrate_signals_cuda(Xs[g], params_list[g])[w]`` bit for bit.

    On CUDA tensors: one launch of the grouped kernel for the groups of
    the launch plan's resident route and one for the others, each of at
    most :data:`MAX_GROUPS` groups, on the current stream without
    synchronizing; each adds one to :data:`grouped_launches`.  On CPU
    tensors: :func:`integrate_signals_tiled` per group.
    """
    global grouped_launches
    if len(Xs) != len(params_list):
        raise ValueError("one parameter set per group of signals")
    if len(Xs) == 0:
        return []
    dev = Xs[0].device
    pstrides = []
    for X, params in zip(Xs, params_list):
        if X.ndim != 3:
            raise ValueError(f"X must be (worlds, cells, signals), got {tuple(X.shape)}")
        if X.device != dev:
            raise ValueError(f"every group must be on one device: {X.device} and {dev}")
        pstrides.append(_check(X, params))
        _route(X, None)
    if dev.type == "cpu":
        return [integrate_signals_tiled(X, params, TILE_C) for X, params in zip(Xs, params_list)]
    lib = _lib()
    limit = smem_limit(dev.index)
    masks = [launch_plan(params.Ke.shape[-1], X.shape[2], limit).mask
             for X, params in zip(Xs, params_list)]
    outs = [torch.empty_like(X) for X in Xs]
    args = grouped_args(Xs, params_list, outs, masks, pstrides)
    n_launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ms_integrate_signals_grouped(
            args.n, args.ptrs, args.dims, args.pstrides, _slot_counters(dev).data_ptr(),
            ctypes.byref(n_launched), stream,
        )
    grouped_launches += n_launched.value
    if err != 0:
        raise RuntimeError(
            f"grouped integrator launch failed: {lib.ms_error_string(err).decode()}"
        )
    return outs
