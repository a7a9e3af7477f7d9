"""
Wall-clock watchdog: turn a wedged dispatch or fetch into diagnostics.
Counterpart of :mod:`magicsoup_tpu.guard.watchdog`.

A call that never returns leaves a hung process with no stack trace and
no record of what it was doing.  A Python-side timeout cannot interrupt
a stuck C call, but it can make the hang observable: dump every thread's
stack to stderr, write one structured JSON diagnostic line, and (for
fetches, which accept a timeout) raise a typed
:class:`~magicsoup_tpu_torch.guard.errors.WatchdogTimeout`.
"""
from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
from contextlib import contextmanager

_DEFAULT_FETCH_TIMEOUT = 300.0


def _env_positive_float(name: str, default: float) -> float:
    """Parse a positive-float guard knob from the environment.

    Unset or empty means the default; anything else must parse as a
    positive finite float or a typed
    :class:`~magicsoup_tpu_torch.guard.errors.GuardConfigError` naming
    the variable is raised when it is read: a garbage value must not
    turn into a confusing ``float()`` traceback (or a silent fallback)
    deep inside the watchdog.
    """
    import math

    raw = os.environ.get(name, "")
    if raw.strip() == "":
        return default
    from magicsoup_tpu_torch.guard.errors import GuardConfigError

    try:
        value = float(raw)
    except ValueError:
        raise GuardConfigError(
            f"{name}={raw!r} is not a number (expected a positive "
            "float, seconds)",
            variable=name,
            value=raw,
        ) from None
    if not math.isfinite(value) or value <= 0:
        raise GuardConfigError(
            f"{name}={raw!r} must be a positive finite number of "
            "seconds",
            variable=name,
            value=raw,
        )
    return value


def fetch_timeout() -> float:
    """Wall-clock budget (seconds) for a single result fetch.

    Overridable through ``MAGICSOUP_GUARD_FETCH_TIMEOUT``, so fault
    tests can force a fast trip.  A malformed value raises a typed
    ``GuardConfigError`` naming the variable (unset or empty means the
    default of 300 s).
    """
    return _env_positive_float(
        "MAGICSOUP_GUARD_FETCH_TIMEOUT", _DEFAULT_FETCH_TIMEOUT
    )


def _device_memory() -> dict:
    """The card's allocated bytes where a card is present (and torch is
    already loaded: a diagnostic never initializes CUDA), else ``{}``."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    try:
        if not torch.cuda.is_initialized():
            return {}
        return {"cuda_memory_allocated": int(torch.cuda.memory_allocated())}
    # graftlint: disable=GL013 diagnostic read on the failure path must not mask the error
    except Exception:  # noqa: BLE001 - a diagnostic must not raise
        return {}


def dump_diagnostics(tag: str, extra: dict | None = None) -> dict:
    """Dump all thread stacks to stderr plus one JSON diagnostic line.

    Returns the diagnostic record so callers can attach it to an error
    or telemetry row; where a card is in use the record also carries its
    allocated bytes.  Never raises: this runs on the failure path.
    """
    record = {
        "diagnostic": tag,
        "pid": os.getpid(),
        "time": time.time(),  # graftlint: disable=GL004 diagnostic timestamp, not simulation state
    }
    if extra:
        record.update(extra)
    record.update(_device_memory())
    try:
        sys.stderr.write(f"[graftguard] diagnostics: {tag}\n")
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.write(json.dumps(record, default=str) + "\n")
        sys.stderr.flush()
    # graftlint: disable=GL013 best-effort dump, original error already propagating
    except Exception:  # noqa: BLE001 - diagnostics must not mask the hang
        pass
    return record


class Watchdog:
    """Monitor thread that fires when a phase overstays its budget.

    Usage::

        wd = Watchdog(120.0, tag="dispatch")
        with wd.phase("megastep dispatch"):
            step_fn(...)

    If the body is still running when the budget elapses, the monitor
    calls ``on_timeout`` (default: :func:`dump_diagnostics`) exactly
    once per phase — it cannot abort the stuck call, but the hang
    becomes a stack dump + JSON record instead of silence.
    """

    def __init__(self, timeout: float, *, tag: str = "watchdog", on_timeout=None):
        self.timeout = float(timeout)
        self.tag = tag
        self.on_timeout = on_timeout
        self.fired = 0
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        done = threading.Event()

        def _monitor():
            if not done.wait(self.timeout):
                with self._lock:
                    self.fired += 1
                handler = self.on_timeout
                if handler is None:
                    dump_diagnostics(
                        f"{self.tag}:{name} exceeded {self.timeout:.1f}s",
                        {"phase": name, "timeout_s": self.timeout},
                    )
                else:
                    handler(name, self.timeout)

        t = threading.Thread(
            target=_monitor, name=f"graftguard-{self.tag}", daemon=True
        )
        t.start()
        try:
            yield
        finally:
            done.set()
            t.join(timeout=1.0)
