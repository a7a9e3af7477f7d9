"""
Cell-parameter assembly's hand-written CUDA kernel (``csrc/assemble.cu``)
and its wrapper.

:func:`assemble_rows` takes what the plain
:func:`magicsoup_tpu_torch.ops.params.assemble_rows` takes, with the
token batch and the target rows as host arrays, which is where its
callers hold them: it computes the nine ``CellParams`` rows of a dense
token batch ``(b, p_r, d_r, 5)`` at the batch's own rung, pads them out
to the state's protein capacity with the zero-token fill values, and
writes them into the state rows ``cell_idxs`` in place.  It raises on a
row outside the state.  On a card it sends the batch and the rows up in
one asynchronous copy and launches the kernel once (:func:`launch`), on
the current stream and without synchronizing, adding one to
:data:`launches` and counting ``assembly.launches`` and
``assembly.kernel_rows``; it raises on anything the kernel does not take
and on a build or launch failure, and never falls back.  For a state on
the CPU it runs the plain version in batches, which is also the kernel's
test oracle: the kernel repeats its arithmetic operation for operation,
so the two are bit-equal on the card.

The kernel replaces no TPU kernel (the JAX package runs the assembly as an
XLA program); it replaces the eager chain of about 470 small launches per
call that the plain version makes on a card.  It is built from the repo's
source with ``nvcc`` at first use (:mod:`magicsoup_tpu_torch._build`),
with ``--fmad=false``, into a plain shared library loaded with ctypes.
"""
import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from magicsoup_tpu_torch._build import build_shared
from magicsoup_tpu_torch.constants import EPS, GAS_CONSTANT, MAX
from magicsoup_tpu_torch.ops import params as _params
from magicsoup_tpu_torch.ops.cuda_integrate import NVCC_FLAGS, nvcc
from magicsoup_tpu_torch.ops.integrate import INT_PARAM_DTYPE, CellParams
from magicsoup_tpu_torch.telemetry import recorder as _recorder

#: kernel launches so far (a plain count; set it to 0 to start a window)
launches = 0

SRC = Path(__file__).resolve().parents[1] / "csrc" / "assemble.cu"

#: the gas constant, EPS and MAX as the plain version's float32 ops see them
_SCALARS = (ctypes.c_float * 3)(*(float(np.float32(v)) for v in (GAS_CONSTANT, EPS, MAX)))

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Path:
    """Build the kernel's shared library (once per source); its path.
    The compiler's report is kept beside it as ``<library>.log``."""
    return build_shared("libmsassemble", SRC, [nvcc(), *NVCC_FLAGS], timeout=600)


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp = ctypes.c_void_p
            lib.ms_assemble_rows.argtypes = [vp, vp, vp, vp]
            lib.ms_assemble_rows.restype = ctypes.c_int
            lib.ms_assemble_error_string.argtypes = [ctypes.c_int]
            lib.ms_assemble_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def _need(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    whose shape matches ``shape`` (``None`` entries match any size)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the parameters on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != len(shape) or any(w is not None and w != n for w, n in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(state: CellParams, dense, tables: _params.TokenTables, abs_temp, cell_idxs) -> None:
    """Validate what the kernel takes: the state at capacity ``(C, P,
    [s])``, ``dense`` ``(b, p_r <= P, d_r, 5)`` int16, ``cell_idxs``
    ``(b,)`` int64, the tables and ``abs_temp`` (one float32), all
    contiguous on one device."""
    dev = state.Vmax.device
    C, P = state.Vmax.shape if state.Vmax.ndim == 2 else (None, None)
    s = tables.mol_energies.shape[0] if tables.mol_energies.ndim == 1 else None
    f32, i32 = torch.float32, torch.int32
    for name in ("Ke", "Kmf", "Kmb", "Vmax"):
        _need(getattr(state, name), name, f32, (C, P), dev)
    _need(state.Kmr, "Kmr", f32, (C, P, s), dev)
    for name in ("N", "Nf", "Nb", "A"):
        _need(getattr(state, name), name, INT_PARAM_DTYPE, (C, P, s), dev)
    _need(dense, "dense", torch.int16, (None, None, None, 5), dev)
    if dense.shape[1] > P:
        raise ValueError(f"the batch's {dense.shape[1]} proteins exceed the state's {P}")
    _need(cell_idxs, "cell_idxs", torch.int64, (dense.shape[0],), dev)
    _need(abs_temp.reshape(-1), "abs_temp", f32, (1,), dev)
    for name, dtype, shape in (
        ("km_weights", f32, (None,)),
        ("vmax_weights", f32, (None,)),
        ("signs", i32, (None,)),
        ("hills", i32, (None,)),
        ("reactions", i32, (None, s)),
        ("transports", i32, (None, s)),
        ("effectors", i32, (None, s)),
        ("mol_energies", f32, (s,)),
    ):
        t = getattr(tables, name)
        _need(t, name, dtype, shape, dev)
        if t.shape[0] == 0:
            raise ValueError(f"{name} has no rows")


def launch_args(state: CellParams, dense, tables: _params.TokenTables, abs_temp, cell_idxs):
    """The pointers, dims and scalars of ``ms_assemble_rows`` for tensors
    that :func:`_check` passed (the caller keeps them alive)."""
    b, p_r, d_r, _ = dense.shape
    C, P, s = state.Kmr.shape
    tensors = (dense, cell_idxs, abs_temp, *tables, *state)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    dims = (ctypes.c_longlong * 13)(
        b, p_r, d_r, C, P, s, *(getattr(tables, n).shape[0] for n in _params.TokenTables._fields[:7])
    )
    return ptrs, dims, _SCALARS


def assemble_rows(
    state: CellParams,
    dense: np.ndarray,
    tables: _params.TokenTables,
    abs_temp: torch.Tensor,
    cell_idxs: np.ndarray,
) -> None:
    """Assemble the host token batch ``dense`` ``(b, p_r, d_r, 5)`` int16
    into ``state`` rows ``cell_idxs`` ``(b,)`` int64 in place
    (:func:`magicsoup_tpu_torch.ops.params.assemble_rows`): for a state on
    a card, one copy of the batch and the rows to it and one
    :func:`launch`; for a state on the CPU, the plain version in batches
    of :func:`_assembly_chunk`.  Target
    rows must be distinct; one outside ``[0, C)`` raises ``IndexError``."""
    if not isinstance(dense, np.ndarray) or dense.dtype != np.int16:
        raise TypeError(f"dense must be an int16 array, got {getattr(dense, 'dtype', type(dense))}")
    if not isinstance(cell_idxs, np.ndarray) or cell_idxs.dtype != np.int64:
        raise TypeError(
            f"cell_idxs must be an int64 array, got {getattr(cell_idxs, 'dtype', type(cell_idxs))}"
        )
    if dense.ndim != 4 or dense.shape[3] != 5 or cell_idxs.shape != dense.shape[:1]:
        raise ValueError(
            f"dense must be (b, p, d, 5) and cell_idxs (b,), got {dense.shape} and {cell_idxs.shape}"
        )
    C = state.Vmax.shape[0]
    if len(cell_idxs) == 0:
        return
    if cell_idxs.min() < 0 or cell_idxs.max() >= C:
        raise IndexError(
            f"cell slots must lie in [0, {C}), got {cell_idxs.min()}..{cell_idxs.max()}"
        )
    dev = state.Vmax.device
    if dev.type == "cpu":
        chunk = _assembly_chunk(dense.shape[1], dense.shape[2], state.Kmr.shape[-1])
        for a in range(0, len(cell_idxs), chunk):
            _params.assemble_rows(
                state, torch.from_numpy(np.ascontiguousarray(dense[a : a + chunk])), tables,
                abs_temp, torch.from_numpy(np.ascontiguousarray(cell_idxs[a : a + chunk])),
            )
        return
    if dev.type != "cuda":
        raise ValueError(f"no assembly kernel for device {dev}")
    dense_t, idx_t = _upload(dense, cell_idxs, dev)
    launch(state, dense_t, tables, abs_temp, idx_t)


def _assembly_chunk(p_cap: int, d_cap: int, s: int) -> int:
    """The plain version's batch on the CPU: the largest pow2 whose (b, p,
    d, s) temporaries stay ~<= 256 MB each at the given rung."""
    per_row = max(p_cap * d_cap * s, 1)
    chunk = 1 << max((2**26 // per_row).bit_length() - 1, 0)
    return max(_params.IDX_BLOCK, chunk)


def _upload(
    dense: np.ndarray, cell_idxs: np.ndarray, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """``dense`` (int16) and ``cell_idxs`` (int64) on the card, staged in
    one pinned buffer and sent in one asynchronous copy: a copy from
    pageable memory would block the host until the card's stream drains.
    The host allocator keeps the staging buffer until the copy has run."""
    n_idx = cell_idxs.nbytes
    staged = torch.empty(n_idx + 2 * dense.size, dtype=torch.uint8, pin_memory=True)
    host = staged.numpy()
    host[:n_idx].view(np.int64)[:] = cell_idxs
    host[n_idx:].view(np.int16).reshape(dense.shape)[...] = dense
    on_card = staged.to(device, non_blocking=True)
    return (
        on_card[n_idx:].view(torch.int16).view(dense.shape),
        on_card[:n_idx].view(torch.int64),
    )


def launch(
    state: CellParams,
    dense: torch.Tensor,
    tables: _params.TokenTables,
    abs_temp: torch.Tensor,
    cell_idxs: torch.Tensor,
) -> None:
    """One launch of the kernel on tensors already on the card: the token
    batch ``dense`` into ``state`` rows ``cell_idxs``, on the current
    stream and without synchronizing.  A row outside ``[0, C)`` or a
    token outside its table traps the kernel, as the plain version's
    index check stops on the card; :func:`assemble_rows` checks the rows
    on the host first."""
    global launches
    dev = state.Vmax.device
    if dev.type != "cuda":
        raise ValueError(f"no assembly kernel for device {dev}")
    _check(state, dense, tables, abs_temp, cell_idxs)
    if dense.shape[0] == 0:
        return
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ms_assemble_rows(*launch_args(state, dense, tables, abs_temp, cell_idxs), stream)
    if err != 0:
        raise RuntimeError(
            f"assembly kernel launch failed: {lib.ms_assemble_error_string(err).decode()}"
        )
    launches += 1
    _recorder.count("assembly.launches")
    _recorder.count("assembly.kernel_rows", dense.shape[0])
