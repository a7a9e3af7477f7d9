"""
The threefry draw's hand-written CUDA kernel (``csrc/threefry.cu``) and
its wrapper.

One launch hashes every 64-bit flat index ``0..n-1`` under each of a
batch of keys with Threefry-2x32 (20 rounds) and writes either the two
hash words XORed (the partitionable ``random_bits`` at 32 bits) or both
words (a key per counter, as ``split`` builds them).  Values are uint32
held in int64, the layout of the plain version
(:func:`magicsoup_tpu_torch.ops.prng.threefry2x32` and the eager ops of
:mod:`~magicsoup_tpu_torch.ops.prng` around it), so everything downstream
(``uniform``, ``randint``) is bit-equal whichever ran.

:func:`threefry` takes CUDA tensors only: it launches the kernel once on
the current stream without synchronizing, adds one to :data:`launches`,
and raises on a build or launch failure or on anything the kernel does
not take.  The dispatch between the kernel and the plain version is
``ops/prng.py::_hash_counters``, by the key's device.

The kernel is built from the repo's source with ``nvcc`` at first use
(:mod:`magicsoup_tpu_torch._build`), into a plain shared library loaded
with ctypes.
"""
import ctypes
import threading
from pathlib import Path

import torch

from magicsoup_tpu_torch._build import build_shared
from magicsoup_tpu_torch.ops.cuda_integrate import NVCC_FLAGS, nvcc

#: kernel launches so far (a plain count; set it to 0 to start a window)
launches = 0

SRC = Path(__file__).resolve().parents[1] / "csrc" / "threefry.cu"

#: keys one launch takes (the grid's y extent)
MAX_KEYS = 65535

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Path:
    """Build the kernel's shared library (once per source); its path.
    The compiler's report is kept beside it as ``<library>.log``."""
    return build_shared("libmsthreefry", SRC, [nvcc(), *NVCC_FLAGS], timeout=600)


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ms_threefry.argtypes = [vp, ci, ctypes.c_longlong, vp, ci, vp]
            lib.ms_threefry.restype = ci
            lib.ms_threefry_error_string.argtypes = [ci]
            lib.ms_threefry_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def threefry(keys: torch.Tensor, n: int, pair: bool) -> torch.Tensor:
    """Hash the counters ``0..n-1`` under each key of ``keys``
    ``(*lead, 2)`` (int64 holding uint32 words, on a CUDA device): the
    XORed words ``(*lead, n)``, or with ``pair`` both words
    ``(*lead, n, 2)``; int64 holding uint32 values."""
    global launches
    if keys.device.type != "cuda":
        raise ValueError(f"the threefry kernel runs on CUDA tensors, got {keys.device}")
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError(f"keys must be int64 (..., 2), got {keys.dtype} {tuple(keys.shape)}")
    if not 0 <= n < 2**32:
        raise ValueError("draws of 2**32 or more elements are not supported")
    lead = tuple(keys.shape[:-1])
    flat = keys.reshape(-1, 2).contiguous()
    n_keys = flat.shape[0]
    if n_keys > MAX_KEYS:
        raise ValueError(f"{n_keys} keys exceed the launch's {MAX_KEYS}")
    out = torch.empty(lead + (n, 2) if pair else lead + (n,), dtype=torch.int64,
                      device=keys.device)
    if n == 0 or n_keys == 0:
        return out
    lib = _lib()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.ms_threefry(flat.data_ptr(), n_keys, n, out.data_ptr(), int(pair), stream)
    if err != 0:
        raise RuntimeError(
            f"threefry kernel launch failed: {lib.ms_threefry_error_string(err).decode()}"
        )
    launches += 1
    return out
