"""GL018 fixture: a guard-scoped module writing its snapshot raw — the
``open(..., "wb")`` bypasses both guard.io's atomic protocol and the
chaos ``io.write`` fault point, so neither a crash nor the chaos
campaign can ever exercise this path's recovery.  The read, the
append-only stream, and the sanctioned guard.io form below it stay
silent."""
from magicsoup_tpu_torch.guard.io import atomic_write_bytes  # noqa: F401  (marks the module guard-scoped)


def save_raw(path, payload: bytes) -> None:
    with open(path, "wb") as fh:  # GL018: raw write bypasses guard.io
        fh.write(payload)


def load(path) -> bytes:
    with open(path, "rb") as fh:  # reads are not a write boundary
        return fh.read()


def append_log(path, line: str) -> None:
    with open(path, "a") as fh:  # append streams are legitimately raw
        fh.write(line + "\n")


def save_atomic(path, payload: bytes) -> None:
    atomic_write_bytes(path, payload)  # the sanctioned form
