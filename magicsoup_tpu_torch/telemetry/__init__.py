"""
Zero-sync telemetry for the step loop.  Counterpart of
:mod:`magicsoup_tpu.telemetry`, with the same ``__all__``.

- :mod:`.recorder`: :class:`TelemetryRecorder` (host-side phase spans and
  buffered JSONL emission), :class:`TelemetrySnapshot` (one view of the
  runtime counters), :func:`trace_window` (a ``torch.profiler`` capture
  of a steady-state window, written as a Chrome trace) and the
  ``note_fetch``/``fetch_stats`` device->host accounting.  The port's
  own span plane, outside ``__all__`` (which is the JAX package's):
  :func:`span` and :class:`phases` for code that holds no recorder,
  :func:`count`, and the process-wide :func:`span_totals` and
  :func:`counter_totals`.
- :mod:`.summary`: stdlib-pure JSONL parsing, validation and aggregation.
- :mod:`.metrics`: the stdlib-pure metrics registry (Prometheus text
  exposition) and the ``note_device_time``/``device_time_stats``
  device-time census.
- :mod:`.trace`: recorder JSONL -> Chrome trace-event JSON
  (``python -m magicsoup_tpu_torch.telemetry trace in.jsonl out.json``).
- ``python -m magicsoup_tpu_torch.telemetry summarize run.jsonl``:
  per-phase p50/p95 and counter deltas of a recorded run.

The device half lives in ``stepper._step_body``: the per-step metric
lanes (alive, occupancy, mass totals) are packed into the step record
whether a recorder is attached or not, so attaching one changes nothing
on the device and deterministic trajectories are bit-identical with
telemetry on or off.
"""
from magicsoup_tpu_torch.telemetry.recorder import (
    TelemetryRecorder,
    TelemetrySnapshot,
    count,
    counter_totals,
    fetch_stats,
    note_fetch,
    phases,
    runtime_counters,
    span,
    span_totals,
    trace_window,
)
from magicsoup_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    device_time_stats,
    note_device_time,
    parse_exposition,
)
from magicsoup_tpu_torch.telemetry.summary import (
    read_jsonl,
    summarize_rows,
    validate_rows,
)
from magicsoup_tpu_torch.telemetry.trace import rows_to_trace

__all__ = [
    "MetricsRegistry",
    "TelemetryRecorder",
    "TelemetrySnapshot",
    "device_time_stats",
    "fetch_stats",
    "note_device_time",
    "note_fetch",
    "parse_exposition",
    "rows_to_trace",
    "runtime_counters",
    "trace_window",
    "read_jsonl",
    "summarize_rows",
    "validate_rows",
]
