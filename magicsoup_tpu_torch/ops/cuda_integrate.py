"""
The integrator's hand-written CUDA kernel (``csrc/integrate.cu``), its
wrapper, its tile table and its plain PyTorch version.

The kernel replaces the JAX package's Pallas kernel
(:func:`magicsoup_tpu.ops.pallas_integrate.integrate_signals_pallas`, solo
grid): the fast-mode integrator over tiles of ``TILE_C = 8`` cells, with
the equilibrium correction's early stop voted per tile.  The tile size is
part of the observable numerics (cells stop with their tile-mates), so
the plain version takes the same tile.

- :func:`integrate_signals_cuda` is the entry point.  On CUDA tensors it
  launches the kernel on the current stream, without synchronizing, and
  adds one to :data:`launches`; it raises on anything the kernel does not
  take, and never falls back.  On CPU tensors it runs the plain version.
- :func:`integrate_signals_tiled` is the plain version: the shared body of
  :mod:`magicsoup_tpu_torch.ops.integrate` with a leading tile axis.  With
  ``tile_c = c`` it is the port's ``torch-fast`` backend.

The kernel is built from the repo's source with ``nvcc`` at first use
(:mod:`magicsoup_tpu_torch._build`), into a plain shared library loaded
with ctypes.
"""
import ctypes
import os
import shutil
import threading
from pathlib import Path

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

SRC = Path(__file__).resolve().parents[1] / "csrc" / "integrate.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_LIB = None
_LIB_LOCK = threading.Lock()


class SharedMemoryLimitError(ValueError):
    """The per-CTA scratch for (p, s) exceeds the card's shared memory."""


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
    tiles of ``tile_c`` cells, each tile with its own early stop."""
    c = X.shape[0]
    if c % tile_c != 0:
        raise ValueError(f"cell count {c} not divisible by tile_c={tile_c}")
    out = integrate_grouped(
        group_rows(X, tile_c),
        CellParams(*(group_rows(t, tile_c) for t in params)),
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
    """Build the kernel's shared library (once per source); its path.
    The compiler's report (``-Xptxas -v``) is kept beside it as
    ``<library>.log``."""
    return build_shared("libmsintegrate", SRC, [nvcc(), *NVCC_FLAGS], timeout=600)


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ms_integrate_signals.argtypes = [vp] * 11 + [ci] * 3 + [vp]
            lib.ms_integrate_signals.restype = ci
            lib.ms_integrate_smem_bytes.argtypes = [ci, ci]
            lib.ms_integrate_smem_bytes.restype = ctypes.c_size_t
            lib.ms_tile_c.restype = ci
            lib.ms_error_string.argtypes = [ci]
            lib.ms_error_string.restype = ctypes.c_char_p
            if lib.ms_tile_c() != TILE_C:
                raise RuntimeError("kernel and wrapper disagree on TILE_C")
            _LIB = lib
    return _LIB


def _check(X: torch.Tensor, params: CellParams) -> None:
    c, s = X.shape
    p = params.Ke.shape[1]
    want = {
        "Ke": ((c, p), torch.float32),
        "Kmf": ((c, p), torch.float32),
        "Kmb": ((c, p), torch.float32),
        "Kmr": ((c, p, s), torch.float32),
        "Vmax": ((c, p), torch.float32),
        "N": ((c, p, s), INT_PARAM_DTYPE),
        "Nf": ((c, p, s), INT_PARAM_DTYPE),
        "Nb": ((c, p, s), INT_PARAM_DTYPE),
        "A": ((c, p, s), INT_PARAM_DTYPE),
    }
    tensors = {"X": X, **params._asdict()}
    want["X"] = ((c, s), torch.float32)
    for name, t in tensors.items():
        shape, dtype = want[name]
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def integrate_signals_cuda(
    X: torch.Tensor, params: CellParams, tile_c: int | None = None
) -> torch.Tensor:
    """
    One integrator step over signals ``X`` (c, s) in tiles of ``tile_c``
    cells (default :func:`select_tile_c`).  CUDA tensors go through the
    kernel, which takes ``tile_c == TILE_C`` only; CPU tensors go through
    :func:`integrate_signals_tiled`.
    """
    global launches
    if X.ndim != 2:
        raise ValueError(f"X must be (cells, signals), got {tuple(X.shape)}")
    _check(X, params)
    if tile_c is None:
        tile_c = select_tile_c(X.shape[0])
    if X.device.type == "cpu":
        return integrate_signals_tiled(X, params, tile_c)
    if X.device.type != "cuda":
        raise ValueError(f"no integrator kernel for device {X.device}")
    if tile_c != TILE_C:
        raise ValueError(
            f"the CUDA kernel runs tiles of {TILE_C} cells, not {tile_c}"
        )
    select_tile_c(X.shape[0])
    c, s = X.shape
    p = params.Ke.shape[1]
    lib = _lib()
    smem = lib.ms_integrate_smem_bytes(p, s)
    limit = torch.cuda.get_device_properties(X.device).shared_memory_per_block_optin
    if smem > limit:
        raise SharedMemoryLimitError(
            f"{p} proteins x {s} signals need {smem} bytes of shared memory"
            f" per tile of {TILE_C} cells; the card allows {limit}"
        )
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
            c,
            p,
            s,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"integrator kernel launch failed: {lib.ms_error_string(err).decode()}"
        )
    launches += 1
    return out
