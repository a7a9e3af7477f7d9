"""
Build-at-first-use for the port's two native libraries: the host genome
engine (``native/src/genome.cpp``, g++) and the integrator kernel
(``csrc/integrate.cu``, nvcc).  Both are plain shared libraries with a C
interface, loaded with ctypes.

Each library is named after a hash of its source and of the compiler
command, so an edit rebuilds it and an unchanged source is built once.
The build writes a process-unique temp file and renames it into place:
several test workers may build at once, and a reader never sees a
half-written library.
"""
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent


def build_dir() -> Path:
    """Where built libraries go: ``build/magicsoup_tpu_torch/`` beside the
    package (git-ignored)."""
    return _PKG.parent / "build" / "magicsoup_tpu_torch"


def build_shared(name: str, src: Path, cmd: list[str], timeout: int) -> Path:
    """Compile ``src`` with ``cmd + [src, "-o", out]`` into
    ``build_dir()/<name>-<hash>.so`` unless that file exists; returns its
    path, with the compiler's output in ``<name>-<hash>.so.log``.  Raises
    ``RuntimeError`` with the compiler's output on failure."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(cmd).encode())
    out = build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
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
    return out
