"""
The deterministic fault-injection plane.  Counterpart of
:mod:`magicsoup_tpu.guard.chaos`: the same spec grammar, sites, seeded
schedules, degraded-state registry and counters, so a spec armed in
either package fires the same hits.

Every robustness boundary carries a named fault point
(``chaos.site("checkpoint.write")``-style probes at checkpoint write,
read and delete, step dispatch, the step-record fetch and telemetry
emission).  A disarmed probe is one global read and a ``None`` return;
an armed probe consults the schedule parsed from ``MAGICSOUP_CHAOS`` (or
:func:`arm`) and returns a :class:`Fault` describing what the probed code
must inflict on itself: raise an errno-carrying ``OSError``, tear a
write, delay a fetch past its watchdog budget.

Spec grammar (clauses joined by ``;``)::

    MAGICSOUP_CHAOS = clause [";" clause]...
    clause = site ":" kind [":" arg] ["@" after] ["x" count]
                               ["%" prob] ["~" seed]

- ``site``/``kind`` must come from :data:`SITES` (unknown names raise a
  typed :class:`GuardConfigError` naming the variable at parse time),
- ``arg`` is a float payload (seconds for ``delay``/``slow``),
- ``@N`` starts firing at the N-th probe hit (default 1 = first),
- ``xM`` fires at most M times (default 1; ``x0`` = unlimited),
- ``%p`` fires each eligible hit with probability ``p`` from the
  stream seeded by ``~seed`` (default seed 0): the draw is keyed on
  ``(seed, site, hit index)``, so the same seed always fires the same
  schedule.

Examples::

    MAGICSOUP_CHAOS="checkpoint.write:enospc@2"      # 2nd save fails
    MAGICSOUP_CHAOS="dispatch:transient x3"          # (API form) 3 faults
    MAGICSOUP_CHAOS="fetch:delay:10;telemetry.emit:eio"

The serve sites (``registry.write``, ``serve.response``, ``serve.queue``)
parse as in the JAX package, so one spec arms both; the port's serving
plane probes them where the JAX package's does.

The module also hosts the process-wide degraded-state registry:
subsystems that degrade instead of crashing (a telemetry stream disarming
itself on ``EIO``) record the transition with :func:`note_degraded` /
:func:`clear_degraded`, and ``analysis.runtime.snapshot`` reports it.

Standard library only: ``guard.io`` receives this module's probe by
registration (this module imports it and sets ``_chaos_probe``), so
``io.py`` stays loadable as a file on its own.
"""
from __future__ import annotations

import os
import random
import re
import threading

from magicsoup_tpu_torch.guard import io as _io
from magicsoup_tpu_torch.guard.errors import GuardConfigError

__all__ = [
    "FAULT_POINTS",
    "SITES",
    "Fault",
    "arm",
    "armed",
    "clear_degraded",
    "counters",
    "degraded_states",
    "disarm",
    "events_since",
    "fault_points",
    "fired_counts",
    "note_counter",
    "note_degraded",
    "parse_spec",
    "reset_counters",
    "site",
    "spec",
]

#: every instrumented fault point and the fault kinds it understands —
#: the parse-time contract that keeps a typo'd spec from silently
#: arming nothing
SITES: dict[str, tuple[str, ...]] = {
    "io.write": ("enospc", "eio", "torn"),
    "checkpoint.write": ("enospc", "eio", "torn"),
    "checkpoint.read": ("eio",),
    "checkpoint.delete": ("eio",),
    "registry.write": ("enospc", "eio"),
    "dispatch": ("transient",),
    "fetch": ("delay",),
    "telemetry.emit": ("enospc", "eio"),
    "serve.response": ("drop", "malformed"),
    "serve.queue": ("full", "slow"),
}

#: where each fault point is probed in the port: site -> (module,
#: qualified callable); graftlint's GL021 holds it to the probes in the
#: code, both ways
FAULT_POINTS: dict[str, tuple[str, str]] = {
    "io.write": ("magicsoup_tpu_torch.guard.io", "atomic_write_bytes"),
    "checkpoint.write": ("magicsoup_tpu_torch.guard.checkpoint", "write_checkpoint"),
    "checkpoint.read": ("magicsoup_tpu_torch.guard.checkpoint", "_read_header"),
    "checkpoint.delete": (
        "magicsoup_tpu_torch.guard.checkpoint",
        "CheckpointManager.prune",
    ),
    "dispatch": ("magicsoup_tpu_torch.stepper", "PipelinedStepper._dispatch_with_retry"),
    "fetch": ("magicsoup_tpu_torch.stepper", "PipelinedStepper._replay"),
    "telemetry.emit": (
        "magicsoup_tpu_torch.telemetry.recorder",
        "TelemetryRecorder._flush_locked",
    ),
    "registry.write": (
        "magicsoup_tpu_torch.serve.service",
        "FleetService._write_registry",
    ),
    "serve.response": ("magicsoup_tpu_torch.serve.api", "make_handler"),
    "serve.queue": ("magicsoup_tpu_torch.serve.service", "FleetService.submit"),
}


def fault_points() -> list[dict]:
    """Machine-readable fault-point registry: one row per probed site
    with its fault kinds and the (module, callable) that probes it."""
    return [
        {
            "site": name,
            "kinds": list(SITES[name]),
            "module": module,
            "callable": qualname,
        }
        for name, (module, qualname) in sorted(FAULT_POINTS.items())
    ]

#: kinds that require a float ``arg`` (seconds)
_ARG_REQUIRED = ("delay", "slow")

_ERRNO_BY_KIND = {"enospc": 28, "eio": 5}  # errno.ENOSPC, errno.EIO


class Fault:
    """One firing of an armed fault point.

    Attributes:
        site: The fault-point name that fired.
        kind: The fault kind from the matched clause.
        arg: The clause's float payload (seconds for delays), or None.
        index: 1-based fire count of the clause (for telemetry rows).
    """

    __slots__ = ("site", "kind", "arg", "index")

    def __init__(self, site: str, kind: str, arg: float | None, index: int):
        self.site = site
        self.kind = kind
        self.arg = arg
        self.index = index

    def as_oserror(self) -> OSError:
        """The errno-carrying ``OSError`` this fault stands for —
        instrumented I/O sites raise it from inside their real handler
        path, so the recovery code under test is the production code."""
        import errno as _errno

        code = _ERRNO_BY_KIND.get(self.kind, _errno.EIO)
        return OSError(
            code,
            f"chaos-injected {self.kind.upper()} at fault point "
            f"{self.site!r} (fire #{self.index})",
        )

    def __repr__(self) -> str:
        return (
            f"Fault(site={self.site!r}, kind={self.kind!r}, "
            f"arg={self.arg!r}, index={self.index})"
        )


class _Clause:
    """One parsed spec clause plus its live hit/fire counters."""

    __slots__ = ("site", "kind", "arg", "after", "count", "prob", "seed",
                 "hits", "fires")

    def __init__(self, site, kind, arg, after, count, prob, seed):
        self.site = site
        self.kind = kind
        self.arg = arg
        self.after = after
        self.count = count  # 0 = unlimited
        self.prob = prob
        self.seed = seed
        self.hits = 0
        self.fires = 0


_CLAUSE_RE = re.compile(
    r"^(?P<site>[a-z][a-z0-9_.]*):(?P<kind>[a-z]+)"
    r"(?::(?P<arg>\d+(?:\.\d+)?))?"
    r"(?:\s*@(?P<after>\d+))?"
    r"(?:\s*x(?P<count>\d+))?"
    r"(?:\s*%(?P<prob>\d*\.?\d+))?"
    r"(?:\s*~(?P<seed>\d+))?$"
)

_lock = threading.Lock()
_plane: dict[str, list[_Clause]] | None = None
_spec: str | None = None
_fired: dict[str, int] = {}
_counters: dict[str, int] = {}
# subsystem -> {"count": transitions-into-degraded, "detail": last reason}
_degraded: dict[str, dict] = {}
# bounded ring of "chaos"/"degraded" telemetry rows.  Recorders DRAIN
# this at their counter-emit boundaries (cursor-based, see
# :func:`events_since`) instead of being called synchronously — a fault
# can fire while a recorder holds its own buffer lock (the
# ``telemetry.emit`` site fires INSIDE the flush), so a push-style hook
# would deadlock exactly when it matters most.
_events: list[dict] = []
_events_base = 0  # global sequence index of _events[0]
_EVENT_CAP = 1024


def _record_event(row: dict) -> None:
    # caller holds _lock
    global _events_base
    _events.append(row)
    if len(_events) > _EVENT_CAP:
        drop = len(_events) - _EVENT_CAP
        del _events[:drop]
        _events_base += drop


def events_since(cursor: int) -> tuple[int, list[dict]]:
    """Telemetry rows recorded after ``cursor`` (a value this function
    previously returned; start from 0).  Returns ``(new_cursor, rows)``
    — each attached recorder keeps its own cursor, so several streams
    can observe the same transitions without stealing from each other.
    Rows older than the ring capacity are gone; the cursor just skips
    ahead."""
    with _lock:
        start = max(cursor - _events_base, 0)
        return _events_base + len(_events), [dict(r) for r in _events[start:]]


def parse_spec(
    text: str, *, variable: str = "MAGICSOUP_CHAOS"
) -> dict[str, list[_Clause]]:
    """Parse a chaos spec into per-site clause lists; bad specs raise
    :class:`GuardConfigError` naming ``variable`` (parse-time refusal,
    same contract as the watchdog's env knobs)."""
    plane: dict[str, list[_Clause]] = {}
    for raw in text.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        m = _CLAUSE_RE.match(raw.replace(" ", ""))
        if m is None:
            raise GuardConfigError(
                f"{variable}: unparseable chaos clause {raw!r}: expected "
                "site:kind[:arg][@after][xcount][%prob][~seed]",
                variable=variable,
                value=raw,
            )
        name, kind = m.group("site"), m.group("kind")
        kinds = SITES.get(name)
        if kinds is None:
            raise GuardConfigError(
                f"{variable}: unknown chaos site {name!r}; known sites: "
                f"{', '.join(sorted(SITES))}",
                variable=variable,
                value=raw,
            )
        if kind not in kinds:
            raise GuardConfigError(
                f"{variable}: site {name!r} does not understand fault "
                f"kind {kind!r}; "
                f"it takes: {', '.join(kinds)}",
                variable=variable,
                value=raw,
            )
        arg = m.group("arg")
        if arg is None and kind in _ARG_REQUIRED:
            raise GuardConfigError(
                f"{variable}: fault kind {kind!r} needs a seconds "
                "argument, e.g. "
                f"{name}:{kind}:0.5",
                variable=variable,
                value=raw,
            )
        prob = float(m.group("prob") or 1.0)
        if not 0.0 < prob <= 1.0:
            raise GuardConfigError(
                f"{variable}: chaos probability must be in (0, 1], "
                f"got {prob}",
                variable=variable,
                value=raw,
            )
        clause = _Clause(
            site=name,
            kind=kind,
            arg=None if arg is None else float(arg),
            after=int(m.group("after") or 1),
            count=int(m.group("count") if m.group("count") is not None else 1),
            prob=prob,
            seed=int(m.group("seed") or 0),
        )
        plane.setdefault(name, []).append(clause)
    return plane


def arm(text: str) -> None:
    """Arm the fault plane from a spec string (replaces any prior
    schedule; clause counters start fresh)."""
    global _plane, _spec
    plane = parse_spec(text)
    with _lock:
        _plane = plane or None
        _spec = text if plane else None


def disarm() -> None:
    """Drop the armed schedule; every probe goes back to zero-cost."""
    global _plane, _spec
    with _lock:
        _plane = None
        _spec = None


def armed() -> bool:
    return _plane is not None


def spec() -> str | None:
    """The armed spec string, or None."""
    return _spec


def site(name: str) -> Fault | None:
    """Probe one fault point.  Returns ``None`` (the overwhelmingly
    common case — also when disarmed: one global read, no lock) or the
    :class:`Fault` the instrumented caller must inflict.

    Deterministic: each clause counts probe HITS; firing is a pure
    function of (hit index, clause schedule, clause seed), so the same
    spec over the same execution fires the same sites in the same
    order.  With several clauses on one site, the first eligible clause
    wins and later clauses still observe the hit."""
    plane = _plane
    if plane is None:
        return None
    clauses = plane.get(name)
    if not clauses:
        return None
    with _lock:
        fault = None
        for c in clauses:
            c.hits += 1
            if fault is not None:
                continue
            if c.hits < c.after:
                continue
            if c.count and c.fires >= c.count:
                continue
            if c.prob < 1.0:
                draw = random.Random(f"{c.seed}:{name}:{c.hits}").random()
                if draw >= c.prob:
                    continue
            c.fires += 1
            _fired[name] = _fired.get(name, 0) + 1
            fault = Fault(name, c.kind, c.arg, c.fires)
            _record_event(
                {
                    "type": "chaos",
                    "site": name,
                    "kind": c.kind,
                    "index": c.fires,
                }
            )
    return fault


def fired_counts() -> dict[str, int]:
    """Fires per site since the last :func:`arm`/:func:`reset_counters`."""
    with _lock:
        return dict(_fired)


# ----------------------------------------------------------------- #
# degraded-state registry + generic failure counters                #
# ----------------------------------------------------------------- #

def note_degraded(subsystem: str, detail: str = "") -> int:
    """Record that ``subsystem`` entered (or stayed in) its degraded
    state; returns the transition count.  Callers pair this with a
    telemetry ``degraded`` row and a single ``warnings.warn``."""
    with _lock:
        rec = _degraded.setdefault(subsystem, {"count": 0, "detail": ""})
        rec["count"] += 1
        rec["detail"] = detail
        _record_event(
            {
                "type": "degraded",
                "subsystem": subsystem,
                "state": "degraded",
                "count": rec["count"],
                "detail": detail,
            }
        )
        return rec["count"]


def clear_degraded(subsystem: str) -> None:
    """Mark ``subsystem`` recovered (drops it from the registry; its
    transition count remains visible through :func:`counters`)."""
    with _lock:
        rec = _degraded.pop(subsystem, None)
        if rec is not None:
            _counters[f"degraded_transitions:{subsystem}"] = (
                _counters.get(f"degraded_transitions:{subsystem}", 0)
                + rec["count"]
            )
            _record_event(
                {
                    "type": "degraded",
                    "subsystem": subsystem,
                    "state": "recovered",
                    "count": rec["count"],
                }
            )


def degraded_states() -> dict[str, dict]:
    """Currently degraded subsystems -> {"count", "detail"}."""
    with _lock:
        return {k: dict(v) for k, v in _degraded.items()}


def note_counter(name: str, n: int = 1) -> int:
    """Bump a named robustness counter (retention-delete failures,
    dropped telemetry rows, ...).  Merged into
    ``analysis.runtime.snapshot()``, so the counters rows of a telemetry
    stream carry every counted failure."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)
        return _counters[name]


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def runtime_counters() -> dict[str, int]:
    """The chaos contribution to ``analysis.runtime.snapshot()``:
    ``chaos_fired`` (total fault firings), ``degraded`` (subsystems
    currently degraded), plus every :func:`note_counter` key."""
    with _lock:
        out = {
            "chaos_fired": sum(_fired.values()),
            "degraded": len(_degraded),
        }
        out.update(_counters)
        return out


def reset_counters() -> None:
    """Zero fired counts, failure counters, and the degraded registry
    (the armed schedule, if any, keeps its clause state) — test
    isolation, called by ``analysis.runtime.reset_counters``."""
    global _events_base
    with _lock:
        _fired.clear()
        _counters.clear()
        _degraded.clear()
        # keep the event sequence monotone across resets so recorder
        # cursors never point past rows that haven't happened yet
        _events_base += len(_events)
        _events.clear()


# hand guard.io the probe (registration, not import: see the docstring)
_io._chaos_probe = site

# env arming: read once at import, as analysis/ownership.py does; a bad
# spec fails here with the variable named, not deep inside a write
_env_spec = os.environ.get("MAGICSOUP_CHAOS", "").strip()
if _env_spec:
    arm(_env_spec)
