"""The per-layer metrics that read the program's own spans and counters:
the tiny cell's traced run on the CPU reads the host ones, every metric
the benchmark had still reads as before, and a program without the
spans, or a trace without the ranges, reads nothing and raises nothing."""
import json

import pytest

from benchmark import program_spans, run
from benchmark.conftest import tiny_cell
from benchmark.trace import Trace

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"] for w in MANIFEST["workloads"]}
HOST = ("genome.engine_ms", "params.translate_ms", "params.assembly_ms", "world.fetch_wait_ms")
DEVICE = ("params.assembly_device_ms", "physics.device_ms")
SPAN_METRICS = HOST + DEVICE + ("phenotype.hit_pct",)


def _traced(seed: int) -> dict:
    manifest, cell, workload, config = tiny_cell("wl-10k-128.classic")
    # ten traced steps: three could hold no spawn, division or mutation (no
    # translation or assembly to read), after some lengths of the timed window
    return run.run_cell(manifest, cell, dict(workload, trace_steps=10), config, seed=seed,
                        seconds=0.5, trace=True, device="cpu")


def _run(trace=None, steps: int = 4) -> run.Run:
    return run.Run(stats={}, step_gaps=[], trace=trace, trace_steps=steps,
                   activity_range="bench:activity", live=[], signals=28)


def _trace(range_kernels: dict) -> Trace:
    return Trace(window_s=1.0, busy_s=0.1, n_kernels=3, range_kernels=range_kernels,
                 device_ops=[], idle_gaps=[])


@pytest.mark.parametrize("seed", [3, 2**31 + 101])
def test_tiny_traced_cell_reads_the_host_spans(seed, tiled_integrator):
    res = _traced(seed)
    got = res["metrics"]
    assert res["correct"] is True
    for name in HOST:
        assert got[name]["value"] > 0, name
        assert got[name]["unit"] == "ms"
    assert 0.0 <= got["phenotype.hit_pct"]["value"] <= 100.0
    # the metrics the benchmark had read as before
    assert got["world.genome_ms"]["value"] > 0
    assert got["loop.step_ms_p95"]["value"] > 0
    assert 0.0 <= got["device.idle_pct"]["value"] <= 100.0
    # no card: no kernel ran, so no device metric is read
    for name in ("activity_roofline",) + DEVICE:
        assert name not in got, name


def test_span_metrics_are_listed_for_the_cell():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert "wl-10k-128.classic" in m["workloads"] and set(m["workloads"]) <= CELLS
        assert m["moves"] == "steps_per_s"
        assert m["source"] == ("device_trace" if name in DEVICE else
                               "program_counter" if name == "phenotype.hit_pct" else
                               "program_span")


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(program_spans, "_telemetry", lambda: None)
    assert run.metric_reader(name)(_run(_trace({}))) is None
    assert run.metric_reader(name)(_run(None)) is None


def test_device_metrics_read_the_kernels_inside_their_range():
    trace = _trace({"ms:assemble": {"k1": 0.002, "k2": 0.006},
                    "ms:physics": {"stencil": 0.004}})
    assert run.metric_reader("params.assembly_device_ms")(_run(trace)) == pytest.approx(2.0)
    assert run.metric_reader("physics.device_ms")(_run(trace)) == pytest.approx(1.0)
    assert run.metric_reader("physics.device_ms")(_run(_trace({}))) is None
