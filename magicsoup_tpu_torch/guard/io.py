"""
Crash-safe file writes: temp file -> fsync -> ``os.replace``.
Counterpart of :mod:`magicsoup_tpu.guard.io`.

Opening the target and writing it in place truncates the previous file
first, so a crash in between loses both the old and the new contents.
Here a reader sees either the complete old bytes or the complete new
ones:

1. the payload goes to a uniquely named temp file in the target's
   directory (``os.replace`` is atomic only within one filesystem);
2. the temp file is flushed and fsynced;
3. ``os.replace`` moves it onto the target;
4. the directory is fsynced, so that the rename survives a power cut.

Standard library only, and loadable as a file on its own.  Every write is
a fault point of the chaos plane (:mod:`magicsoup_tpu_torch.guard.chaos`);
so that this file imports nothing of the package, the probe is handed
over by registration: ``guard.chaos`` sets ``_chaos_probe`` when it is
imported.  Unarmed (or loaded alone) the probe is ``None`` and a write
pays one attribute read.
"""
import os
from pathlib import Path

# set to guard.chaos.site by guard.chaos at import; None = disarmed
_chaos_probe = None


def _fsync_dir(dirpath: Path) -> None:
    # a directory fsync is POSIX-only: where a directory cannot be opened
    # the rename is still atomic, only not durable across a power cut
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path, data: bytes, *, chaos_site: str = "io.write") -> None:
    """Atomically replace ``path`` with ``data``.  The temp file carries
    the target's name plus a pid and random suffix, so concurrent writers
    never collide; on any failure it is removed and ``path`` is left as
    it was.

    ``chaos_site`` names this write's fault point (callers with a more
    specific identity pass their own, e.g. ``checkpoint.write``): an armed
    ``enospc``/``eio`` fault raises the errno-carrying ``OSError`` before
    any byte lands, and a ``torn`` fault leaves a truncated prefix on the
    target, the corruption a verified checkpoint reader must refuse."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if _chaos_probe is not None:
        fault = _chaos_probe(chaos_site)
        if fault is not None:
            if fault.kind == "torn":
                # deliberately not atomic: stands in for what a torn
                # write leaves on a non-atomic filesystem
                with open(path, "wb") as fh:
                    fh.write(data[: max(1, len(data) // 2)])
                return
            raise fault.as_oserror()
    tmp = path.parent / f".{path.name}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(path.parent)


def atomic_write_text(
    path, text: str, encoding: str = "utf-8", *, chaos_site: str = "io.write"
) -> None:
    """:func:`atomic_write_bytes` for text."""
    atomic_write_bytes(path, text.encode(encoding), chaos_site=chaos_site)
