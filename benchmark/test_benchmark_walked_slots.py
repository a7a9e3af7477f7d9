"""The integrator's walked-slot metric (``integrator.walked_slot_pct``)
reads the program's slot counters, and nothing where there are none."""
import pytest

from benchmark import program_spans, run
from benchmark.trace import Trace


def _run(trace) -> run.Run:
    return run.Run(stats={}, step_gaps=[], trace=trace, trace_steps=4,
                   activity_range="bench:activity", live=[], signals=82)


def test_walked_slot_pct_reads_the_slot_counters(monkeypatch):
    trace = Trace(window_s=1.0, busy_s=0.1, n_kernels=3, range_kernels={}, device_ops=[],
                  idle_gaps=[])
    read = run.metric_reader("integrator.walked_slot_pct")
    counters = program_spans.counters
    monkeypatch.setattr(program_spans, "counters", lambda: {
        "integrator.slots": 10240 * 512, "integrator.live_slots": 109_568,
        "integrator.walked_slots": 296_960})
    assert read(_run(trace)) == pytest.approx(100 * 296_960 / (10240 * 512))
    assert read(_run(None)) is None
    # the CPU launches no kernel, so counts no slots; a program whose
    # kernel keeps no slot counters reads nothing either
    monkeypatch.setattr(program_spans, "counters", lambda: {"integrator.calls": 4})
    assert read(_run(trace)) is None
    monkeypatch.setattr(program_spans, "counters", lambda: {"integrator.slots": 4096})
    assert read(_run(trace)) is None
    monkeypatch.setattr(program_spans, "counters", counters)
    monkeypatch.setattr(program_spans, "_telemetry", lambda: None)
    assert read(_run(trace)) is None
