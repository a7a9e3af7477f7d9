"""
What the per-layer metrics of the program's own spans and counters read
in a traced run: the totals that the program's telemetry keeps of the
latest profiled window (``span_totals(profiled=True)``,
``counter_totals(profiled=True)``), which is the traced window, and the
device time of the kernels launched inside a span (``range_kernels``).
A program that keeps no such totals, or a run with no such span, reads
nothing.
"""


def _telemetry():
    try:
        from magicsoup_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry if hasattr(telemetry, "span_totals") else None


def self_ms_per_step(run, names: tuple[str, ...]):
    """Host milliseconds per traced step spent in the spans ``names``
    and in none nested in them (their self time), or None."""
    tel = _telemetry()
    if tel is None or run.trace is None or not run.trace_steps:
        return None
    totals = tel.span_totals(profiled=True)
    found = [totals[name][2] for name in names if name in totals]
    return 1e3 * sum(found) / run.trace_steps if found else None


def counters():
    """The program's counters over the traced window, or None."""
    tel = _telemetry()
    return None if tel is None else tel.counter_totals(profiled=True)


def device_ms_per_step(run, name: str):
    """Device milliseconds per traced step of the kernels launched inside
    the span ``name``, or None."""
    if run.trace is None or not run.trace_steps:
        return None
    kernels = run.trace.range_kernels.get(name)
    return 1e3 * sum(kernels.values()) / run.trace_steps if kernels else None
