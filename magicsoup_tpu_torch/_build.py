"""
Build-at-first-use for the port's native libraries: the host genome
engine (``native/src/genome.cpp``, g++) and the CUDA kernels
(``csrc/integrate.cu``, ``csrc/bisect.cu``, nvcc).  All are plain shared
libraries with a C interface, loaded with ctypes.

Each library is named after a hash of its source, of every file the
source includes with ``#include "..."`` (found beside the including file,
followed recursively), and of the compiler command, so an edit to the
source or to a header it includes rebuilds it, and an unchanged source
is built once.  The build writes a process-unique temp file and renames
it into place: several test workers may build at once, and a reader
never sees a half-written library.
"""
import hashlib
import os
import re
import subprocess
from pathlib import Path

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def build_dir() -> Path:
    """Where built libraries go: ``MAGICSOUP_COMPILE_CACHE_DIR``, else
    ``build/magicsoup_tpu_torch/`` beside the package (git-ignored); see
    :mod:`magicsoup_tpu_torch.cache`."""
    from magicsoup_tpu_torch.cache import compile_cache_dir

    return compile_cache_dir()


def source_closure(src: Path) -> list[Path]:
    """``src`` and every file it includes with ``#include "..."``,
    resolved beside the including file and followed recursively; quoted
    includes that name no such file (a system header) are left out."""
    seen: dict[Path, None] = {}
    todo = [Path(src).resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = None
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / name.decode()).resolve()
            if dep.is_file():
                todo.append(dep)
    return list(seen)


def library_path(name: str, src: Path, cmd: list[str]) -> Path:
    """``build_dir()/<name>-<hash>.so``: the hash covers the bytes of
    :func:`source_closure` and the compiler command."""
    src = Path(src).resolve()
    digest = hashlib.sha256(" ".join(cmd).encode())
    for path in source_closure(src):
        digest.update(os.path.relpath(path, src.parent).encode() + b"\0")
        digest.update(path.read_bytes())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def build_shared(name: str, src: Path, cmd: list[str], timeout: int) -> Path:
    """Compile ``src`` with ``cmd + [src, "-o", out]`` into
    :func:`library_path` unless that file exists; returns its path, with
    the compiler's output in ``<library>.log``.  Raises ``RuntimeError``
    with the compiler's output on failure.  Each call is counted in
    ``analysis.runtime``: a library found built is a build-cache hit, a
    compiler run a compile."""
    from magicsoup_tpu_torch.analysis import runtime as _runtime

    src = Path(src)
    out = library_path(name, src, cmd)
    if out.exists():
        _runtime.note_build(compiled=False)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [*cmd, str(src), "-o", str(tmp)],
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    # the compiler's report (e.g. nvcc -Xptxas -v) stays beside the library
    log = out.with_name(f"{out.name}.log")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    _runtime.note_build(compiled=True)
    return out
