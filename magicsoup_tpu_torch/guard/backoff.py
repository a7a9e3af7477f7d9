"""
One deterministic backoff policy for every retry ladder.  Counterpart of
:mod:`magicsoup_tpu.guard.backoff`.

:meth:`BackoffPolicy.delay` is a pure function of ``(policy config,
attempt)``: jitter, when enabled, draws from a private ``random.Random``
keyed on ``(seed, attempt)``, never from the global stream, so the same
policy replays the same delays and a jittered retry cannot desynchronize
two deterministic runs; a cap keeps a persistent fault from turning into
an unbounded sleep.  The clock is injectable (:meth:`sleep` takes the
sleep function), so tests assert exact schedules without waiting.
"""
from __future__ import annotations

import time
from typing import Callable

__all__ = ["BackoffPolicy"]


class BackoffPolicy:
    """Seeded, capped, optionally jittered exponential backoff.

    Parameters:
        base: Delay for attempt 1 (seconds, or scheduler steps — the
            unit is the caller's).
        factor: Growth per attempt (default 2.0).
        max_delay: Upper clamp applied after growth AND after jitter;
            ``float("inf")`` disables the cap.
        jitter: Fractional spread in ``[0, 1)``: attempt ``n``'s delay
            is scaled by a factor drawn uniformly from
            ``[1 - jitter, 1 + jitter]``.  0 (default) = exact ladder.
        seed: Jitter stream seed; two policies with equal config
            produce identical schedules.
    """

    def __init__(
        self,
        *,
        base: float,
        factor: float = 2.0,
        max_delay: float = float("inf"),
        jitter: float = 0.0,
        seed: int = 0,
    ):
        if base < 0:
            raise ValueError(f"base must be >= 0, got {base}")
        if factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {factor}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.base = float(base)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delay(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based).  Pure: no clock,
        no global randomness, no internal state."""
        if attempt < 1:
            from magicsoup_tpu_torch.guard.errors import GuardConfigError

            raise GuardConfigError(
                f"attempt is 1-based, got {attempt}",
                variable="attempt",
                value=str(attempt),
            )
        d = min(self.max_delay, self.base * self.factor ** (attempt - 1))
        if self.jitter:
            import random

            u = random.Random(f"{self.seed}:{attempt}").random()
            d = min(self.max_delay, d * (1.0 + self.jitter * (2.0 * u - 1.0)))
        return d

    def sleep(
        self, attempt: int, *, sleep: Callable[[float], None] = time.sleep
    ) -> float:
        """Sleep out attempt ``attempt``'s delay (injectable clock);
        returns the delay slept."""
        d = self.delay(attempt)
        sleep(d)
        return d

    def schedule(self, attempts: int) -> list[float]:
        """The first ``attempts`` delays — what a bounded retry loop
        will pay end to end (tests pin these exactly)."""
        return [self.delay(i) for i in range(1, attempts + 1)]

    def __repr__(self) -> str:
        return (
            f"BackoffPolicy(base={self.base}, factor={self.factor}, "
            f"max_delay={self.max_delay}, jitter={self.jitter}, "
            f"seed={self.seed})"
        )
