"""
Typed errors of the guard plane: checkpoints, the sentinel and invariant
lanes, the watchdog, the environment knobs and dispatch faults.
Counterpart of :mod:`magicsoup_tpu.guard.errors`.  A caller that falls
back to an older snapshot needs to tell "the file is corrupt" from "the
file is from a future schema" without parsing messages, so each failure
it may handle differently has its own class with structured fields.
"""


class GuardError(RuntimeError):
    """Base class of the guard errors."""


class CheckpointError(GuardError):
    """A saved world could not be loaded.

    Attributes:
        check: Which check failed: ``"magic"``, ``"header"``,
            ``"version"``, ``"truncated"``, ``"digest"``, ``"unpickle"``,
            ``"migrate"``, ``"config"``, ``"format"``, ``"io"`` (the file
            could not be read), ``"degraded"`` or ``"none"`` (no loadable
            checkpoint); ``World.from_file`` raises ``"truncated"`` for a
            truncated or garbled pickle.
        path: The offending file, when there is one.
    """

    def __init__(self, message: str, *, check: str, path=None):
        super().__init__(message)
        self.check = check
        self.path = None if path is None else str(path)


class SentinelTripped(GuardError):
    """A health sentinel fired under the ``rollback`` policy.

    Attributes:
        flags: The raw health flag word of the step record (see
            :func:`magicsoup_tpu_torch.guard.sentinel.decode_health`).
        step: The replayed step index at which the flags were observed.
        n_bad_cells: How many live cells carried a bad concentration.
    """

    def __init__(self, message: str, *, flags: int, step: int, n_bad_cells: int):
        super().__init__(message)
        self.flags = int(flags)
        self.step = int(step)
        self.n_bad_cells = int(n_bad_cells)


class InvariantTripped(SentinelTripped):
    """A state invariant fired under the ``rollback`` policy; ``flags`` is
    the invariant flag word (see
    :func:`magicsoup_tpu_torch.check.invariants.decode_invariants`)."""

    def __init__(self, message: str, *, flags: int, step: int):
        super().__init__(message, flags=flags, step=step, n_bad_cells=0)


class GuardConfigError(GuardError):
    """A guard environment knob holds an unusable value; raised when the
    knob is first read, naming it.

    Attributes:
        variable: The environment variable's name.
        value: The raw string that failed to parse.
    """

    def __init__(self, message: str, *, variable: str, value: str):
        super().__init__(message)
        self.variable = variable
        self.value = value


class WatchdogTimeout(GuardError):
    """A step-record fetch exceeded its wall-clock budget.

    Attributes:
        phase: ``"fetch"`` or ``"fleet-fetch"``.
        seconds: The budget that was exceeded.
    """

    def __init__(self, message: str, *, phase: str, seconds: float):
        super().__init__(message)
        self.phase = phase
        self.seconds = float(seconds)


class TransientDispatchError(GuardError):
    """Fault-injection stand-in for a transient backend error.  Its
    message carries the transient marker ``UNAVAILABLE``, so
    :func:`magicsoup_tpu_torch.guard.retry.is_transient_error` classifies
    it as it would a real one."""

    def __init__(self, message: str = "injected fault: UNAVAILABLE: backend lost"):
        super().__init__(message)
