"""
Trace export: recorder JSONL -> Chrome trace-event JSON.  Counterpart of
:mod:`magicsoup_tpu.telemetry.trace`, copied so that for the same JSONL
both packages give the same document.

``python -m magicsoup_tpu_torch.telemetry trace run.jsonl run.trace.json``
converts a recorder capture into the Trace Event Format that
``chrome://tracing`` / Perfetto load directly.  Thread lanes follow the
ownership roles (:mod:`magicsoup_tpu_torch.analysis.ownership`):
the ``scheduler-loop`` lane carries the host dispatch phases, the
``stepper-worker`` lane the fetch/device spans, and the
``telemetry-writer`` lane the instant events (chaos fault firings,
degradation transitions, warden/sentinel/invariant trips).

**The timeline is synthetic.**  Dispatch rows record per-phase
DURATIONS (milliseconds since the previous dispatch row), not absolute
timestamps, so the exporter lays dispatches out sequentially: each
dispatch's phases start where the previous dispatch ended, and the
phases within one lane are laid end to end in a canonical order.
Durations, ordering, and per-phase proportions are faithful; absolute
concurrency between lanes is not (the live alternative is
:func:`magicsoup_tpu_torch.telemetry.trace_window`, which wraps
``torch.profiler`` around a steady-state window for a real timeline).

Stdlib-pure by the same contract as :mod:`.summary`.
"""
from __future__ import annotations

__all__ = ["rows_to_trace"]

#: host dispatch phases, in the order they are laid out within one
#: dispatch's scheduler-loop span (the order _prepare_dispatch ->
#: _finalize_inputs -> dispatch -> replay actually runs them)
_LOOP_PHASES = (
    "spawn",
    "param_assembly",
    "push",
    "dispatch",
    "dispatch_retry",
    "replay",
)
#: phases that resolve on the fetch worker (graftrace stepper-worker):
#: the D2H fetch span and the commit-to-fetch-ready device span
_WORKER_PHASES = ("device", "fetch")

_TIDS = {"scheduler-loop": 1, "stepper-worker": 2, "telemetry-writer": 3}
_PID = 1

#: instant-event row types relayed to the telemetry-writer lane, with
#: the row keys folded into the event args
_INSTANT_TYPES = ("chaos", "degraded", "warden", "sentinel", "invariant")


def _meta_events() -> list[dict]:
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": _PID,
            "args": {"name": "magicsoup_tpu"},
        }
    ]
    for role, tid in sorted(_TIDS.items(), key=lambda kv: kv[1]):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "args": {"name": role},
            }
        )
    return events


def _complete(name: str, tid: int, ts_us: float, dur_us: float, args=None):
    ev = {
        "name": name,
        "ph": "X",
        "pid": _PID,
        "tid": tid,
        "ts": round(ts_us, 3),
        "dur": round(dur_us, 3),
        "cat": "phase",
    }
    if args:
        ev["args"] = args
    return ev


def rows_to_trace(rows: list[dict]) -> dict:
    """Convert validated recorder rows to a trace-event document."""
    events = _meta_events()
    cursor = 0.0  # synthetic timeline, microseconds
    dispatch_index = 0
    for row in rows:
        kind = row.get("type")
        if kind == "dispatch":
            phases = row.get("phases") or {}
            args = {
                k: row[k]
                for k in (
                    "k",
                    "q",
                    "rows",
                    "cold",
                    "compact",
                    "fleet_slot",
                    "fleet_size",
                    "fused_groups",
                    "envelope",
                )
                if k in row
            }
            args["dispatch_index"] = dispatch_index
            lane_end = cursor
            t = cursor
            for name in _LOOP_PHASES:
                if name not in phases:
                    continue
                dur = max(0.0, float(phases[name])) * 1e3
                events.append(
                    _complete(name, _TIDS["scheduler-loop"], t, dur, args)
                )
                t += dur
            lane_end = max(lane_end, t)
            t = cursor
            for name in _WORKER_PHASES:
                if name not in phases:
                    continue
                dur = max(0.0, float(phases[name])) * 1e3
                events.append(
                    _complete(name, _TIDS["stepper-worker"], t, dur, args)
                )
                t += dur
            lane_end = max(lane_end, t)
            # unknown phases (future recorder additions) still render
            for name in sorted(phases):
                if name in _LOOP_PHASES or name in _WORKER_PHASES:
                    continue
                dur = max(0.0, float(phases[name])) * 1e3
                events.append(
                    _complete(name, _TIDS["scheduler-loop"], lane_end, dur, args)
                )
                lane_end += dur
            cursor = lane_end + 1.0  # 1 µs gap keeps dispatches distinct
            dispatch_index += 1
        elif kind == "step":
            events.append(
                {
                    "name": "population",
                    "ph": "C",
                    "pid": _PID,
                    "ts": round(cursor, 3),
                    "args": {
                        "alive": row.get("alive", 0),
                        "occupied": row.get("occupied", 0),
                    },
                }
            )
        elif kind in _INSTANT_TYPES:
            args = {
                k: v
                for k, v in row.items()
                if k != "type" and isinstance(v, (str, int, float, bool))
            }
            events.append(
                {
                    "name": kind,
                    "ph": "i",
                    "s": "t",
                    "pid": _PID,
                    "tid": _TIDS["telemetry-writer"],
                    "ts": round(cursor, 3),
                    "cat": "event",
                    "args": args,
                }
            )
        # meta / counters / accounting rows carry no timeline content
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "magicsoup_tpu.telemetry trace",
            "synthetic_timeline": True,
            "dispatches": dispatch_index,
        },
    }
