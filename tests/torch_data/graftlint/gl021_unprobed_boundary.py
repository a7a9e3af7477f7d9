"""GL021 fixture: guard-scoped recovery code with NO chaos fault point
on its call path — the handler is dedicated to disk faults, so the
chaos campaign should be able to exercise it, but no probe can ever
raise into it.  The probed twin, the non-fault drain loop, and the
defensive multi-type cleanup below it stay silent."""
from magicsoup_tpu_torch.guard import chaos


def load_or_default(path) -> bytes:
    try:
        return path.read_bytes()
    except OSError:  # GL021: disk-fault recovery no campaign can reach
        return b""


def load_probed(path) -> bytes:
    try:
        fault = chaos.site("checkpoint.read")
        if fault is not None:
            raise fault.as_oserror()
        return path.read_bytes()
    except OSError:  # injectable: the probe above raises into it
        return b""


def drain(q) -> int:
    import queue

    n = 0
    while True:
        try:
            q.get_nowait()  # queue.Empty is not a chaos fault class
        except queue.Empty:
            break
        n += 1
    return n


def restore_handles(handles) -> None:
    for h in handles:
        try:
            h.close()
        except (ValueError, OSError, TypeError):
            pass  # best-effort cleanup tolerance, not a fault boundary
