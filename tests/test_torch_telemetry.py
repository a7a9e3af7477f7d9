"""
The port's telemetry plane (``telemetry/``) against the JAX package's, on
the CPU.  Exact throughout, except the rows' timing fields (``phases``
and ``wall``), which are host clock readings and are left out of every
comparison:

- the recorder's span, window, JSONL, pickling and snapshot mechanics;
- the metrics registry's Prometheus text byte-equal to the JAX
  package's for the same calls, and the device-time census;
- ``summary`` and ``trace`` output equal to the JAX package's on the
  same JSONL, and the command line;
- the port stepper's rows pass the JAX package's ``validate_rows``, and
  in deterministic mode its ``step`` rows (alive, rows, occupied, the
  mass lanes, kills, divisions, spawns, genome lengths, totals) and its
  ``dispatch`` rows' bookkeeping equal the JAX stepper's, string and
  token, at ``megastep`` 1 and 3;
- K step rows per dispatch of K fused steps; the device program is
  unchanged by a recorder (every record byte-equal on and off);
- the fleet: one census entry per group dispatch, the ``device`` span on
  every member's recorder, dispatch rows tagged with slot and size;
- ``trace_window`` writes a Chrome trace holding the ``ms:*`` ranges.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
import pickle  # noqa: E402
import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu import telemetry as jtel  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu.telemetry import metrics as jmetrics  # noqa: E402
from magicsoup_tpu_torch import telemetry as ttel  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from magicsoup_tpu_torch.telemetry.__main__ import main as cli_main  # noqa: E402

KW = dict(
    mol_name="ATP",
    kill_below=1.0,
    divide_above=3.0,
    divide_cost=1.0,
    target_cells=40,
    genome_size=300,
    lag=2,
    max_divisions=64,
    spawn_block=16,
    push_block=16,
    p_mutation=1e-3,
    p_recombination=1e-4,
)
# dispatch-row keys that follow from the trajectory (phases are timings;
# "cold" names the JAX package's compile state, which eager torch lacks)
DISPATCH_KEYS = ("k", "rows", "pending", "compact")

_SNAPSHOT_KEYS = {
    "dispatches",
    "fused_groups",
    "chaos_fired",
    "degraded",
    "device_time_us",
    "device_dispatches",
    "fetches",
    "fetch_bytes",
}


def _world(lib, chem, seed: int, **kw):
    w = lib.World(chemistry=chem, map_size=16, seed=seed, **kw)
    rng = random.Random(seed)
    w.spawn_cells([lib.random_genome(s=300, rng=rng) for _ in range(20)])
    w._ensure_capacity(100)
    return w


def _rows_by_type(rows, kind):
    return [r for r in rows if r["type"] == kind]


# ------------------------------------------------------------ recorder
def test_public_names_equal_jax():
    assert ttel.__all__ == jtel.__all__
    assert tmetrics.__all__ == jmetrics.__all__


def test_detached_recorder_accumulates_but_never_emits():
    rec = ttel.TelemetryRecorder()
    assert not rec.attached
    with rec.span("fetch"):
        pass
    rec.note("fetch", 0.002)
    rec.emit({"type": "dispatch", "phases": {}})  # no-op while detached
    stats = rec.phase_stats()
    assert stats["fetch"]["n"] == 2
    assert stats["fetch"]["p95_ms"] >= stats["fetch"]["p50_ms"] >= 0.0
    assert rec.rows_emitted == 0
    # the aggregation is the JAX recorder's for the same notes
    jrec = jtel.TelemetryRecorder()
    rec2 = ttel.TelemetryRecorder()
    for s in (0.004, 0.001, 0.0025, 0.010):
        jrec.note("push", s)
        rec2.note("push", s)
    assert rec2.phase_stats() == jrec.phase_stats()
    assert rec2.take_dispatch() == jrec.take_dispatch()


def test_attached_recorder_jsonl_roundtrip(tmp_path):
    path = tmp_path / "t.jsonl"
    rec = ttel.TelemetryRecorder(path=path, flush_every=1)
    rec.note("dispatch", 0.004)
    rec.note("dispatch", 0.001)
    rec.emit({"type": "dispatch", "phases": rec.take_dispatch()})
    assert rec.take_dispatch() == {}  # the window drained
    rec.emit_counters()
    rec.detach()
    rows = ttel.read_jsonl(path)
    assert jtel.validate_rows(rows) == []
    assert rows[0]["type"] == "meta" and rows[0]["version"] == 1
    (dispatch,) = _rows_by_type(rows, "dispatch")
    assert abs(dispatch["phases"]["dispatch"] - 5.0) < 1e-6
    counters = _rows_by_type(rows, "counters")
    assert counters and _SNAPSHOT_KEYS <= set(counters[-1]["counters"])
    summary = ttel.summarize_rows(rows)
    assert summary["dispatches"] == 1
    assert summary["phases"]["dispatch"]["n"] == 1


def test_recorder_pickles_as_detached_twin(tmp_path):
    rec = ttel.TelemetryRecorder(path=tmp_path / "t.jsonl", flush_every=7)
    rec.note("push", 0.001)
    twin = pickle.loads(pickle.dumps(rec))
    assert not twin.attached and twin.flush_every == 7
    twin.note("push", 0.001)
    rec.detach()


def test_world_coerces_its_recorder_and_pickles_it_detached(tmp_path):
    w = mt.World(chemistry=TCHEM, map_size=16, seed=1, device="cpu")
    assert isinstance(w.telemetry, ttel.TelemetryRecorder) and not w.telemetry.attached
    shared = ttel.TelemetryRecorder()
    assert mt.World(chemistry=TCHEM, map_size=16, seed=1, device="cpu", telemetry=shared).telemetry is shared
    w2 = mt.World(chemistry=TCHEM, map_size=16, seed=1, device="cpu", telemetry=tmp_path / "w.jsonl")
    assert w2.telemetry.attached
    back = pickle.loads(pickle.dumps(w2))
    assert isinstance(back.telemetry, ttel.TelemetryRecorder) and not back.telemetry.attached
    # a pickle from before the recorder gets a fresh detached one
    state = w.__getstate__()
    del state["telemetry"]
    old = mt.World.__new__(mt.World)
    old.__setstate__(state)
    assert isinstance(old.telemetry, ttel.TelemetryRecorder)
    w2.telemetry.detach()


def test_runtime_snapshot_and_reset():
    snap = runtime.snapshot()
    tel = ttel.runtime_counters()
    assert {"dispatches", "chaos_fired", "degraded", "device_time_us"} <= set(snap)
    assert {"fetches", "fetch_bytes"} <= set(tel)
    assert all(isinstance(v, int) for v in snap.values())
    runtime.reset_counters()
    assert all(v == 0 for v in runtime.snapshot().values())


# ------------------------------------------------------------- metrics
def _feed(reg_mod):
    reg = reg_mod.MetricsRegistry()
    reg.counter("demo_total", "A demo counter.")
    reg.gauge("demo_depth", "A demo gauge.", label_names=("lane",))
    reg.histogram("demo_seconds", "A demo histogram.", buckets=(0.1, 1.0, 2.5))
    reg.counter("esc_total", 'Escapes \\ and\nnewlines.', label_names=("v", "w"))
    reg.inc("demo_total", 3)
    reg.set("demo_depth", 2, lane="b")
    reg.set("demo_depth", 1.5, lane="a")
    reg.set("demo_depth", float("nan"), lane="c")
    reg.set("demo_depth", float("inf"), lane="d")
    for v in (0.05, 4.0, 0.7, 2.5, 1e-9):
        reg.observe("demo_seconds", v)
    reg.inc("esc_total", 2, v='back\\slash "quoted"\nnewline', w="x")
    reg.set("esc_total", 10, v="plain")
    reg.set("esc_total", 4, v="plain")  # counters keep their high-water mark
    return reg.render()


def test_exposition_text_byte_equal_to_jax():
    text = _feed(tmetrics)
    assert text == _feed(jmetrics)
    # repr: the NaN sample compares unequal to itself
    assert repr(tmetrics.parse_exposition(text)) == repr(jmetrics.parse_exposition(text))
    assert tmetrics.CONTENT_TYPE == jmetrics.CONTENT_TYPE


def test_exposition_text_pinned():
    reg = tmetrics.MetricsRegistry()
    reg.counter("demo_total", "A demo counter.")
    reg.histogram("demo_seconds", "A demo histogram.", buckets=(0.1, 1.0))
    reg.inc("demo_total", 3)
    reg.observe("demo_seconds", 0.05)
    reg.observe("demo_seconds", 4.0)
    assert reg.render() == (
        "# HELP demo_total A demo counter.\n"
        "# TYPE demo_total counter\n"
        "demo_total 3\n"
        "# HELP demo_seconds A demo histogram.\n"
        "# TYPE demo_seconds histogram\n"
        'demo_seconds_bucket{le="0.1"} 1\n'
        'demo_seconds_bucket{le="1"} 1\n'
        'demo_seconds_bucket{le="+Inf"} 2\n'
        "demo_seconds_sum 4.05\n"
        "demo_seconds_count 2\n"
    )


def test_counter_discipline():
    reg = tmetrics.MetricsRegistry()
    reg.counter("mono_total", "Monotone.")
    with pytest.raises(ValueError):
        reg.inc("mono_total", -1)
    with pytest.raises(ValueError):
        reg.gauge("mono_total", "Oops.")
    with pytest.raises(KeyError):
        reg.inc("never_declared")


def test_device_time_census():
    runtime.reset_counters()
    tmetrics.note_device_time(0.0015)
    tmetrics.note_device_time(0.0000004)
    tmetrics.note_device_time(-1.0)  # clamped
    assert tmetrics.device_time_stats() == {"device_time_us": 1500, "device_dispatches": 3}
    assert runtime.snapshot()["device_dispatches"] == 3
    runtime.reset_counters()
    assert tmetrics.device_time_stats() == {"device_time_us": 0, "device_dispatches": 0}


# --------------------------------------------------- stepper and parity
def _run_pair(tmp_path, monkeypatch, backend: str, megastep: int, dispatches: int):
    """The same det run through the JAX stepper and the port's, each
    writing its JSONL; returns both row lists."""
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jw = _world(ms, JCHEM, 3, genome_backend=backend, telemetry=jpath)
    tw = _world(mt, TCHEM, 3, genome_backend=backend, telemetry=tpath, device="cpu")
    js = ms.PipelinedStepper(jw, megastep=megastep, **KW)
    ts = mt.PipelinedStepper(tw, megastep=megastep, **KW)
    for _ in range(dispatches):
        js.step()
        ts.step()
    js.flush()
    ts.flush()
    jw.telemetry.detach()
    tw.telemetry.detach()
    return jtel.read_jsonl(jpath), ttel.read_jsonl(tpath)


@pytest.mark.parametrize(
    "backend,megastep,dispatches",
    [("string", 1, 8), ("string", 3, 3), ("token", 1, 8)],
)
def test_step_rows_equal_jax_in_det_mode(tmp_path, monkeypatch, backend, megastep, dispatches):
    jrows, trows = _run_pair(tmp_path, monkeypatch, backend, megastep, dispatches)
    assert jtel.validate_rows(trows) == []
    assert ttel.validate_rows(trows) == []
    jsteps, tsteps = _rows_by_type(jrows, "step"), _rows_by_type(trows, "step")
    assert len(tsteps) == dispatches * megastep
    assert tsteps == jsteps
    assert any(r["divisions"] for r in tsteps) and any(r["kills"] for r in tsteps)
    jd, td = _rows_by_type(jrows, "dispatch"), _rows_by_type(trows, "dispatch")
    assert len(td) == dispatches
    assert [{k: r[k] for k in DISPATCH_KEYS} for r in td] == [
        {k: r[k] for k in DISPATCH_KEYS} for r in jd
    ]
    assert all(r["k"] == megastep for r in td)
    # the same row types in the same order, timing left aside
    assert [r["type"] for r in trows] == [r["type"] for r in jrows]


def test_summary_and_trace_equal_jax_on_the_same_jsonl(tmp_path, monkeypatch):
    _, trows = _run_pair(tmp_path, monkeypatch, "string", 1, 5)
    trows.append({"type": "sentinel", "flags": 4, "step": 3, "policy": "warn"})
    trows.append({"type": "chaos", "site": "dispatch", "kind": "transient", "index": 1})
    assert ttel.validate_rows(trows) == jtel.validate_rows(trows) == []
    assert ttel.summarize_rows(trows) == jtel.summarize_rows(trows)
    from magicsoup_tpu.telemetry.summary import format_summary as jformat
    from magicsoup_tpu_torch.telemetry.summary import format_summary as tformat

    summary = ttel.summarize_rows(trows)
    assert tformat(summary) == jformat(summary)
    assert ttel.rows_to_trace(trows) == jtel.rows_to_trace(trows)
    # and the problems a broken stream shows are the same
    bad = trows + [{"type": "step", "step": 0, "alive": 1}, {"no": "type"}]
    assert ttel.validate_rows(bad) == jtel.validate_rows(bad) != []


def test_command_line(tmp_path, monkeypatch, capsys):
    _, trows = _run_pair(tmp_path, monkeypatch, "string", 1, 4)
    path = tmp_path / "t.jsonl"
    assert cli_main(["validate", str(path)]) == 0
    assert cli_main(["summarize", str(path), "--json"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{") :])
    assert doc["steps"] == 4 and doc["dispatches"] == 4
    assert cli_main(["trace", str(path), str(tmp_path / "t.trace.json")]) == 0
    trace = json.loads((tmp_path / "t.trace.json").read_text())
    assert trace == ttel.rows_to_trace(trows)
    path.write_text(path.read_text() + '{"type": "step", "step": 0}\n')
    assert cli_main(["validate", str(path)]) == 1


def test_megastep_dispatch_emits_k_step_rows(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    path = tmp_path / "t.jsonl"
    w = _world(mt, TCHEM, 5, device="cpu", telemetry=path)
    st = mt.PipelinedStepper(
        w, **dict(KW, megastep=3, lag=1, kill_below=-1.0, divide_above=1e30, target_cells=None)
    )
    for _ in range(4):
        st.step()
    st.flush()
    rows = ttel.read_jsonl(path)
    assert jtel.validate_rows(rows) == []
    dispatch, steps = _rows_by_type(rows, "dispatch"), _rows_by_type(rows, "step")
    assert len(dispatch) == 4 and all(r["k"] == 3 for r in dispatch)
    assert len(steps) == 12
    for r in steps:
        assert r["occupied"] == r["alive"] == 20
        assert np.isfinite(r["mm_mass"]) and r["mm_mass"] > 0
        assert np.isfinite(r["cm_mass"])
    # the phases the port notes, each dispatch row carrying its window
    phases = set().union(*(r["phases"] for r in dispatch))
    assert {"dispatch", "device", "fetch", "replay", "param_assembly"} <= phases


@pytest.mark.parametrize("backend", ["string", "token"])
def test_det_records_bit_identical_telemetry_on_vs_off(tmp_path, monkeypatch, backend):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")

    def run(telemetry):
        w = _world(mt, TCHEM, 13, device="cpu", genome_backend=backend, telemetry=telemetry)
        st = mt.PipelinedStepper(w, **KW)
        records: list[bytes] = []
        unpack = st._unpack_outputs
        st._unpack_outputs = lambda a: (records.append(np.asarray(a).tobytes()), unpack(a))[1]
        for _ in range(5):
            st.step()
        st.flush()
        return records, w.molecule_map.numpy().tobytes(), list(w.cell_genomes)

    off = run(None)
    on = run(tmp_path / "t.jsonl")
    assert len(on[0]) == 5
    assert on == off


def test_token_step_row_fetches_lengths_only(tmp_path, monkeypatch):
    # the token step row reads the store's length vector, never a
    # whole-store snapshot: whole-store fetches per step are the same
    # with the recorder on and off
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")

    def fetches(telemetry):
        w = _world(mt, TCHEM, 17, device="cpu", genome_backend="token", telemetry=telemetry)
        st = mt.PipelinedStepper(w, **KW)
        st.step()
        st.drain()
        runtime.reset_counters()
        for _ in range(6):
            st.step()
        st.drain()
        stats = runtime.genome_stats()
        st.flush()
        return stats

    off, on = fetches(None), fetches(tmp_path / "t.jsonl")
    assert on["genome_fetches"] == off["genome_fetches"]
    assert on["genome_decode_calls"] == off["genome_decode_calls"]
    assert off["genome_length_fetches"] == 0
    assert on["genome_length_fetch_bytes"] <= on["genome_length_fetches"] * 4 * 128


# --------------------------------------------------------------- fleet
def test_fleet_rows_census_and_device_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    paths = [tmp_path / f"w{i}.jsonl" for i in range(3)]
    fleet = mt.FleetScheduler(block=4)
    worlds = [_world(mt, TCHEM, 20 + i, device="cpu", telemetry=p) for i, p in enumerate(paths)]
    for w in worlds:
        fleet.admit(w, **KW)
    runtime.reset_counters()
    for _ in range(5):
        fleet.step()
    fleet.flush()
    assert runtime.snapshot()["device_dispatches"] == 5  # one per group dispatch
    for i, p in enumerate(paths):
        worlds[i].telemetry.detach()
        rows = ttel.read_jsonl(p)
        assert jtel.validate_rows(rows) == []
        dispatch = _rows_by_type(rows, "dispatch")
        assert len(dispatch) == 5 and len(_rows_by_type(rows, "step")) == 5
        assert all(r["fleet_size"] == 4 and r["fleet_slot"] == i for r in dispatch)
        assert sum("device" in r["phases"] for r in dispatch) >= 4


# ------------------------------------------------------------- profile
def test_trace_window_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    w = _world(mt, TCHEM, 7, device="cpu")
    st = mt.PipelinedStepper(w, **KW)
    st.step()
    st.drain()
    with ttel.trace_window(tmp_path / "prof") as prof:
        for _ in range(2):
            st.step()
        st.drain()
    doc = json.loads(open(prof.trace_path).read())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"ms:activity", "ms:physics", "ms:divide"} <= names
    st.flush()
