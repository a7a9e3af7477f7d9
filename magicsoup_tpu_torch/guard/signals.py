"""
Graceful preemption for long runs.  Counterpart of
:mod:`magicsoup_tpu.guard.signals`.

A preempted machine gets a SIGTERM and a short grace window; an
interactive run gets SIGINT.  Either way the right move is to finish the
current host iteration, drain the stepper, flush telemetry, write a last
checkpoint and exit.  :class:`GracefulShutdown` turns the signals into a
flag the main loop polls between steps::

    with GracefulShutdown() as stop:
        for i in range(n_steps):
            if stop:
                break
            stepper.step()
    # drain, flush, checkpoint after the loop

A second signal while draining re-raises the default behaviour, so a
wedged drain can still be interrupted.
"""
from __future__ import annotations

import signal
import threading

from magicsoup_tpu_torch.analysis import ownership


class GracefulShutdown:
    """Context manager that latches SIGTERM/SIGINT into a bool flag.

    Inside the ``with`` block the first signal sets the flag (and
    records which signal it was in ``.signum``); the second occurrence
    of the same signal falls through to the previous handler — two
    Ctrl-C still kills a stuck process.  Handlers are restored on exit.
    Signal handlers can only be installed from the main thread; on any
    other thread this degrades to a never-set flag rather than raising.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self.signum: int | None = None
        self._event = threading.Event()
        self._previous: dict[int, object] = {}

    def __bool__(self) -> bool:
        return self._event.is_set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def _handle(self, signum, frame):
        # Python delivers signals on the main thread only; assert the
        # installing thread and the handling thread agree
        ownership.assert_owner(
            self, "signal-owner", attribute="GracefulShutdown.signum"
        )
        if self._event.is_set():
            # second signal: restore + re-deliver the default behaviour
            previous = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, previous)
            if callable(previous):
                previous(signum, frame)
            else:
                signal.raise_signal(signum)
            return
        self.signum = signum
        self._event.set()

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is not threading.main_thread():
            return self
        ownership.bind(self, "signal-owner")
        for signum in self.signals:
            self._previous[signum] = signal.signal(signum, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for signum, previous in self._previous.items():
            try:
                signal.signal(signum, previous)
            except (ValueError, OSError, TypeError):
                pass
        self._previous.clear()
        return None
