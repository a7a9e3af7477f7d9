"""
Typed errors of the pipelined stepper's guard lanes and of a world's
persistence.  Counterpart of the part of :mod:`magicsoup_tpu.guard.errors`
that the stepper and ``World.from_file`` raise.
"""


class GuardError(RuntimeError):
    """Base class of the guard errors."""


class CheckpointError(GuardError):
    """A saved world could not be loaded.

    Attributes:
        check: Which check failed; ``World.from_file`` raises
            ``"truncated"`` for a truncated or garbled pickle (the JAX
            package's checkpoint layer adds ``"magic"``, ``"header"``,
            ``"version"``, ``"digest"``, ``"unpickle"``, ``"config"``,
            ``"format"``, ``"io"``, ``"degraded"`` and ``"none"``).
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
