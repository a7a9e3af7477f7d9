"""
The port's one span mechanism (``telemetry/recorder.py``) and the spans of
the classic ``World``, on the CPU:

- a span's self time is its duration less that of the spans nested in it;
- the module-level ``span`` goes to the recorder whose span is open on its
  thread, and to none from another thread;
- with no profiler recording no ``record_function`` is entered; under a
  CPU ``torch.profiler`` every span is a ``user_annotation``, and the
  profiled totals are those of the latest profiled window, device
  counters folded in when the totals are read;
- a sequence of phases that an exception left open is closed by the next;
- one step of the ``workload.sim_step`` schedule opens exactly the
  World's span names, translation and assembly nested in spawning,
  mutation and recombination, and counts the integrator's calls;
- a seeded deterministic run ends in the same ``state_digest`` with a
  profiler recording and without.
"""
import json
import random
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import magicsoup_tpu_torch as mt
from magicsoup_tpu_torch import telemetry
from magicsoup_tpu_torch.check.differential import state_digest
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
from magicsoup_tpu_torch.telemetry import recorder
from magicsoup_tpu_torch.workload import sim_step

#: the spans of the classic World's calls
WORLD_SPANS = {
    "ms:spawn", "ms:activity", "ms:fetch", "ms:kill", "ms:divide", "ms:recombinate",
    "ms:neighbors", "ms:mutate", "ms:lengths", "ms:translate", "ms:assemble", "ms:physics",
}
ATP = CHEMISTRY.molname_2_idx["ATP"]


def _sleep_in(name: str, seconds: float, rec=None):
    with (rec.span(name) if rec is not None else telemetry.span(name)):
        time.sleep(seconds)


def _world(seed: int, n: int = 300):
    w = mt.World(chemistry=CHEMISTRY, map_size=24, seed=seed, device="cpu")
    rng = random.Random(seed)
    w.spawn_cells([mt.random_genome(s=300, rng=rng) for _ in range(n)])
    return w, rng


def _step(w, rng, n: int = 300):
    """One step of the workload's schedule, then a division, a
    recombination and a mutation at rates at which a 300-cell world
    divides and changes genomes in every step."""
    sim_step(w, rng, n_cells=n, genome_size=300, atp_idx=ATP)
    w.divide_cells([0, 1, 2])
    w.recombinate_cells(p=1e-4)
    w.mutate_cells(p=1e-3)


def _annotations(prof, tmp_path) -> list[tuple[float, float, str]]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


# ------------------------------------------------------------ mechanism
def test_self_time_is_duration_less_children():
    rec = telemetry.TelemetryRecorder()
    with rec.span("outer"):
        time.sleep(0.01)
        _sleep_in("inner", 0.02, rec)
        _sleep_in("inner", 0.01)  # module-level: goes to rec
    st = rec.self_times()
    n, total, self_s = st["outer"]
    assert n == 1 and st["inner"][0] == 2
    assert self_s == pytest.approx(total - st["inner"][1], abs=1e-9)
    assert self_s >= 0.01 and st["inner"][1] >= 0.03
    # a leaf's self time is its duration
    assert st["inner"][2] == pytest.approx(st["inner"][1], abs=1e-12)
    # phase_stats() keeps its keys and sees every span
    assert set(rec.phase_stats()) == {"outer", "inner"}
    assert set(rec.phase_stats()["outer"]) == {"n", "mean_ms", "p50_ms", "p95_ms", "max_ms",
                                               "total_ms"}


def test_module_span_goes_to_the_recorder_open_on_its_thread():
    rec, other = telemetry.TelemetryRecorder(), telemetry.TelemetryRecorder()
    seen = {}

    def elsewhere():
        _sleep_in("thread", 0.001)
        telemetry.count("thread.count")
        seen["done"] = True

    with rec.span("outer"):
        _sleep_in("here", 0.001)
        telemetry.count("here.count", 3)
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join()
    with other.span("second"):
        _sleep_in("there", 0.001)
    _sleep_in("nowhere", 0.001)
    assert seen["done"]
    assert set(rec.self_times()) == {"outer", "here"}
    assert rec.counts() == {"here.count": 3}
    assert set(other.self_times()) == {"second", "there"}
    totals = telemetry.span_totals()
    assert {"thread", "nowhere", "here", "there"} <= set(totals)
    assert telemetry.counter_totals()["thread.count"] >= 1


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    rec = telemetry.TelemetryRecorder()
    with rec.span("a"):
        with telemetry.span("b"):
            pass
    phase = telemetry.phases()
    phase("c")
    phase(None)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("a"):
            pass
    assert entered == ["a"]


def test_spans_are_user_annotations_under_a_profiler(tmp_path):
    rec = telemetry.TelemetryRecorder()
    with rec.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("outer"):
            with telemetry.span("inner"):
                torch.ones(4).sum()
        phase = telemetry.phases()
        phase("first")
        phase("second")
        phase(None)
        telemetry.count("traced", 2)
    names = [a[2] for a in _annotations(prof, tmp_path)]
    assert sorted(names) == ["first", "inner", "outer", "second"]
    # the profiled totals hold the window's spans and counts only
    assert set(telemetry.span_totals(profiled=True)) == {"outer", "inner", "first", "second"}
    assert telemetry.counter_totals(profiled=True) == {"traced": 2}
    # a new profiled window starts them afresh
    with rec.span("between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("again"):
            pass
    assert set(telemetry.span_totals(profiled=True)) == {"again"}
    assert telemetry.counter_totals(profiled=True) == {}


def test_device_counters_fold_into_the_totals():
    # a kernel adds to a device counter; the totals fold it in when read,
    # the profiled window's own counter into the window's totals
    names, cpu = ("test.device_a", "test.device_b"), torch.device("cpu")
    before = telemetry.counter_totals()
    acc = recorder.device_counter(names, cpu)
    acc += torch.tensor([3, 5])
    assert recorder.device_counter(names, cpu) is acc
    after = telemetry.counter_totals()
    assert [after[n] - before.get(n, 0) for n in names] == [3, 5]
    assert telemetry.counter_totals() == after  # folded once
    with profile(activities=[ProfilerActivity.CPU]):
        telemetry.count("traced")
        inside = recorder.device_counter(names, cpu)
        assert inside is not acc
        inside += torch.tensor([7, 0])
    acc += torch.tensor([1, 1])  # after the window: not the window's
    assert telemetry.counter_totals(profiled=True) == {"traced": 1, "test.device_a": 7}
    total = telemetry.counter_totals()
    assert [total[n] - before.get(n, 0) for n in names] == [11, 6]
    telemetry.count("between")
    with profile(activities=[ProfilerActivity.CPU]):
        telemetry.count("again")
    assert telemetry.counter_totals(profiled=True) == {"again": 1}
    assert telemetry.counter_totals() == {**total, "between": total.get("between", 0) + 1,
                                          "again": total.get("again", 0) + 1}


def test_a_sequence_left_open_is_closed_by_the_next():
    rec = telemetry.TelemetryRecorder()
    with rec.span("outer"):
        with pytest.raises(RuntimeError):
            phase = telemetry.phases()
            phase("left")
            raise RuntimeError("a fault mid-phase")
        phase = telemetry.phases()
        phase("next")
        phase(None)
    st = rec.self_times()
    assert st["left"][0] == st["next"][0] == st["outer"][0] == 1
    # nothing stays open on the thread
    with telemetry.span("after"):
        pass
    assert "after" not in rec.self_times()


# ----------------------------------------------------------- the World
def test_world_step_opens_its_spans_nested(tmp_path):
    w, rng = _world(3)
    w.kill_cells(list(range(0, 300, 3)))  # the step tops up: a spawn
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(w, rng)
    st = w.telemetry.self_times()
    assert set(st) == WORLD_SPANS
    spans = _annotations(prof, tmp_path)
    assert {name for *_, name in spans} == WORLD_SPANS
    parents = {"ms:spawn", "ms:mutate", "ms:recombinate"}
    for name in ("ms:translate", "ms:assemble"):
        inside = set()
        for a, b, child in spans:
            if child != name:
                continue
            inside |= {p for a2, b2, p in spans if p in parents and a2 <= a and b <= b2}
        assert inside == parents, name
    # the genome spans' self times, translation's and assembly's add up
    # to the genome spans' totals
    genome = ("ms:recombinate", "ms:mutate")
    parts = ("ms:neighbors", "ms:lengths", "ms:translate", "ms:assemble") + genome
    w2, _ = _world(4)
    st0 = w2.telemetry.self_times()  # the spawn's translation and assembly
    w2.recombinate_cells(p=1e-4)
    w2.mutate_cells(p=1e-3)
    st1 = w2.telemetry.self_times()

    def spent(k, i):
        return st1[k][i] - st0.get(k, (0, 0.0, 0.0))[i]

    assert sum(spent(k, 2) for k in parts) == pytest.approx(sum(spent(k, 1) for k in genome),
                                                            rel=1e-9)
    counts = w.telemetry.counts()
    assert counts["integrator.calls"] == 1
    assert counts["integrator.launches"] == 0  # the CPU launches no kernel
    assert counts["integrator.p"] == w.kinetics.params.Vmax.shape[1]
    assert counts["phenotype.misses"] > 0


def test_world_physics_is_one_span_per_call():
    w, _ = _world(5, n=50)
    w.degrade_and_diffuse_molecules()
    w.degrade_molecules()
    w.diffuse_molecules()
    assert w.telemetry.self_times()["ms:physics"][0] == 3


@pytest.mark.parametrize("seed", [7, 2**31 + 9])
def test_det_state_is_the_same_with_a_profiler(monkeypatch, seed):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")

    def run(profiled: bool) -> str:
        w, rng = _world(seed % 1000)
        np.random.seed(0)
        for i in range(3):
            if profiled and i == 1:
                with profile(activities=[ProfilerActivity.CPU]):
                    _step(w, rng)
            else:
                _step(w, rng)
        return state_digest(w)

    assert run(False) == run(True)
