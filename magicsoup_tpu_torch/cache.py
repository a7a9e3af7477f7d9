"""
The kernel build cache.  Counterpart of :mod:`magicsoup_tpu.cache`, which
configures JAX's persistent compilation cache: here what a process would
otherwise compile at first use are the port's native libraries (the CUDA
integrator, its lowering ladder and the threefry kernel with nvcc, the
genome engine with g++), each built once into one directory and named by
a hash of its sources and compiler command
(:mod:`magicsoup_tpu_torch._build`).  A second process finds them there
and loads them without running a compiler.

Configuration:

- ``MAGICSOUP_COMPILE_CACHE_DIR`` names the directory, as in the JAX
  package (default: ``build/magicsoup_tpu_torch/`` beside the package,
  git-ignored).  Unlike JAX's cache it cannot be switched off: a kernel
  cannot run unbuilt, so a value that disables the JAX cache (``""``,
  ``"0"``, ``"off"``, ``"none"``, ``"disabled"``) raises ``ValueError``.
- :func:`ensure_compile_cache` builds every library ahead of first use on
  a CUDA device, all compilers at once; a long-lived entry point calls it
  before it reports ready, so no first request stalls on nvcc.  On the
  CPU it builds nothing: no CUDA kernel runs there, and the genome engine
  builds at its own first use.
"""
import os
import threading
from pathlib import Path

ENV_VAR = "MAGICSOUP_COMPILE_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / "build" / "magicsoup_tpu_torch"
_DISABLING = ("", "0", "off", "none", "disabled")

_lock = threading.Lock()
_done = False


def compile_cache_dir() -> Path:
    """The build directory: ``MAGICSOUP_COMPILE_CACHE_DIR`` or
    :data:`DEFAULT_CACHE_DIR`.  Raises ``ValueError`` for a value that
    would disable the JAX package's cache."""
    raw = os.environ.get(ENV_VAR)
    if raw is None:
        return DEFAULT_CACHE_DIR
    if raw.strip().lower() in _DISABLING:
        raise ValueError(
            f"{ENV_VAR}={raw!r} would disable the build cache; the port's"
            " kernels cannot run unbuilt, so name a directory or unset it"
        )
    return Path(raw.strip())


def ensure_compile_cache(device=None) -> Path:
    """Build the native libraries that ``device`` runs (idempotent and
    thread-safe) and return the build directory.  ``None`` means the card,
    as everywhere in the port, and raises without one.  A failed build
    raises: nothing falls back to a plain version."""
    from concurrent.futures import ThreadPoolExecutor

    from magicsoup_tpu_torch.util import resolve_device

    global _done
    dev = resolve_device(device, "ensure_compile_cache")
    with _lock:
        if dev.type == "cuda" and not _done:
            from magicsoup_tpu_torch.native import engine
            from magicsoup_tpu_torch.ops import cuda_bisect, cuda_integrate, cuda_prng

            with ThreadPoolExecutor(4) as pool:
                jobs = [pool.submit(mod.build) for mod in (cuda_integrate, cuda_prng, cuda_bisect)]
                genome = pool.submit(engine.get_lib)
                for job in jobs:
                    job.result()
                if genome.result() is None:
                    raise RuntimeError("the native genome engine did not build")
            _done = True
    return compile_cache_dir()
