"""The World's compaction metric (``world.compaction_row_pct``) reads the
program's compaction counters, and nothing where there are none."""
import pytest

from benchmark import program_spans, run
from benchmark.trace import Trace


def _run(trace) -> run.Run:
    return run.Run(stats={}, step_gaps=[], trace=trace, trace_steps=20,
                   activity_range="bench:activity", live=[], signals=82)


def test_compaction_row_pct_reads_the_compaction_counters(monkeypatch):
    trace = Trace(window_s=1.0, busy_s=0.1, n_kernels=3, range_kernels={}, device_ops=[],
                  idle_gaps=[])
    read = run.metric_reader("world.compaction_row_pct")
    counters = program_spans.counters
    monkeypatch.setattr(program_spans, "counters", lambda: {
        "compaction.rows": 3 * 10_150, "compaction.capacity_rows": 3 * 16_384})
    assert read(_run(trace)) == pytest.approx(100 * 10_150 / 16_384)
    assert read(_run(None)) is None
    # the parent program counts no compaction; a window without a kill
    # counts none either
    monkeypatch.setattr(program_spans, "counters", lambda: {"integrator.calls": 4})
    assert read(_run(trace)) is None
    monkeypatch.setattr(program_spans, "counters", lambda: {"compaction.rows": 7})
    assert read(_run(trace)) is None
    monkeypatch.setattr(program_spans, "counters", counters)
    monkeypatch.setattr(program_spans, "_telemetry", lambda: None)
    assert read(_run(trace)) is None
