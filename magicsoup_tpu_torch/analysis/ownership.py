"""
Thread-ownership assertions: a role-owned attribute or method entered
from a foreign thread raises :class:`OwnershipViolation` at the call
site, naming the role.  Counterpart of
:mod:`magicsoup_tpu.analysis.ownership` (framework-neutral, copied as it
is).

Zero-cost when disabled: ``MAGICSOUP_DEBUG_OWNERSHIP`` is read once at
import, and with the flag unset ``owned_by`` returns the undecorated
function and ``assert_owner``/``bind`` return immediately.  Set it to
``1`` to turn every test into an ownership probe.

Binding is per-instance and lazy: the first checked call from any
thread claims the role for that instance; a dead owner thread frees the
role; ``bind()`` force-rebinds at a sanctioned handoff point.
"""
from __future__ import annotations

import functools
import os
import threading

_ENABLED = os.environ.get("MAGICSOUP_DEBUG_OWNERSHIP", "") == "1"
_TABLE = "_graftrace_owners"

__all__ = [
    "OwnershipViolation",
    "assert_owner",
    "bind",
    "enabled",
    "owned_by",
]


class OwnershipViolation(AssertionError):
    """A role-owned attribute or method was touched from a foreign
    thread.  Names the attribute, the expected role, the thread that
    owns the role, and the offending thread."""

    def __init__(self, attribute: str, role: str, owner, offender) -> None:
        self.attribute = attribute
        self.role = role
        self.owner = owner
        self.offender = offender
        super().__init__(
            f"{attribute}: role `{role}` is owned by thread "
            f"{owner.name!r} (ident={owner.ident}) but was entered from "
            f"{offender.name!r} (ident={offender.ident})"
        )


def enabled() -> bool:
    """Whether ownership assertions are armed for this process."""
    return _ENABLED


def _table(obj) -> dict | None:
    table = getattr(obj, _TABLE, None)
    if table is None:
        table = {}
        try:
            object.__setattr__(obj, _TABLE, table)
        except (AttributeError, TypeError):
            return None  # __slots__/frozen instances: nothing to pin to
    return table


def _check(obj, role: str, attribute: str) -> None:
    table = _table(obj)
    if table is None:
        return
    current = threading.current_thread()
    owner = table.get(role)
    if owner is None or owner is current or not owner.is_alive():
        # lazy claim / re-claim after the owning thread exited
        table[role] = current
        return
    raise OwnershipViolation(attribute, role, owner, current)


def bind(obj, role: str, thread=None) -> None:
    """Force-assign `role` on `obj` to `thread` (default: the calling
    thread).  Use at sanctioned handoff points — the top of a loop
    thread's run(), after construction warmed the same state elsewhere."""
    if not _ENABLED:
        return
    table = _table(obj)
    if table is not None:
        table[role] = thread or threading.current_thread()


def assert_owner(obj, role: str, attribute: str | None = None) -> None:
    """Assert the calling thread owns `role` on `obj` (claiming it if
    unclaimed).  Raises :class:`OwnershipViolation` otherwise."""
    if not _ENABLED:
        return
    _check(obj, role, attribute or f"{type(obj).__name__}<{role}>")


def owned_by(role: str):
    """Method decorator: every call must come from the thread owning
    `role` on this instance.  Returns the function untouched when
    ownership checking is disabled, so decorated hot paths cost nothing
    in production."""

    def deco(fn):
        if not _ENABLED:
            return fn

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            _check(self, role, fn.__qualname__)
            return fn(self, *args, **kwargs)

        return wrapper

    return deco
