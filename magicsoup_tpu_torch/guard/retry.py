"""
Bounded retry with backoff for transient backend failures.  Counterpart
of :mod:`magicsoup_tpu.guard.retry`.

The policy is narrow on purpose:

- only errors whose text carries a known transient marker are retried (a
  shape error or an out-of-memory retried forever is a hang, not
  resilience), and never a CUDA error, which is sticky in its context;
- the retry budget is bounded and the delay exponential with a cap;
- every retry is observable through ``on_retry`` (the stepper counts it
  in its stats and its recorder).

The stepper retries at the dispatch boundary only while nothing of the
dispatch has been enqueued, so a retried dispatch produces the same bits
as a first-try success.
"""
from __future__ import annotations

import errno
import re
import time
from typing import Callable

from magicsoup_tpu_torch.guard.backoff import BackoffPolicy

# substrings that mark an error as plausibly transient (the JAX
# package's markers, kept as they are)
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "RESOURCE_EXHAUSTED: Attempting to reserve",
    "Socket closed",
    "Connection reset",
    "transport is closing",
)

# errnos that mean "the storage itself is unusable" — retrying a full
# disk or a read-only filesystem is a hang with extra steps.  Checked
# BEFORE the marker scan so a message that happens to contain a marker
# substring cannot win retries for a dead disk.
_NON_TRANSIENT_ERRNOS = frozenset(
    {errno.ENOSPC, errno.EROFS, errno.EDQUOT}
)


# a CUDA failure: "CUDA error: ...", "CUDA out of memory", cudaError*
# names, the cuBLAS/cuDNN statuses.  A CUDA error is sticky: the context
# that raised it fails every later call, so a retry can only fail again
# (or run on corrupted state).  Checked before the transient markers, so
# a CUDA message that happens to hold one never wins a retry.
_STICKY = re.compile(
    r"CUDA\b.*\berror|cuda[A-Z]\w*Error|CUBLAS_STATUS|CUDNN_STATUS"
    r"|illegal memory access|out of memory|device-side assert"
)


def is_transient_error(exc: BaseException) -> bool:
    """True when ``exc`` looks like a transient backend failure worth
    retrying (against a deterministic fault that never will succeed).

    Errno-carrying ``OSError`` with ENOSPC / EROFS / EDQUOT is not
    transient: a full disk does not heal inside a retry window.  Neither
    is any CUDA error (``_STICKY``), which poisons its context.
    """
    if isinstance(exc, OSError) and exc.errno in _NON_TRANSIENT_ERRNOS:
        return False
    text = f"{type(exc).__name__}: {exc}"
    if _STICKY.search(text):
        return False
    return any(marker in text for marker in _TRANSIENT_MARKERS)


def retry_call(
    fn: Callable,
    *,
    retries: int,
    base_delay: float = 0.5,
    max_delay: float = 8.0,
    retry_if: Callable[[BaseException], bool] = is_transient_error,
    on_retry: Callable[[int, BaseException], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` with up to ``retries`` retries on transient errors.

    Delay doubles each attempt from ``base_delay`` up to ``max_delay``
    (the shared :class:`~magicsoup_tpu_torch.guard.backoff.BackoffPolicy`
    ladder).
    Non-transient errors (per ``retry_if``) and the final transient
    failure propagate unchanged.  ``on_retry(attempt, exc)`` fires
    before each sleep; ``sleep`` is injectable so tests stay instant.
    """
    policy = BackoffPolicy(base=base_delay, factor=2.0, max_delay=max_delay)
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 - reraised unless retried
            if attempt >= retries or not retry_if(exc):
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, exc)
            policy.sleep(attempt, sleep=sleep)
