"""
The port's fault-injection plane (``guard/chaos.py``, ``backoff.py``,
``retry.py``, the chaos probe of ``guard/io.py``) against the JAX
package's, on the CPU.  Everything here is exact (no tolerance):

- ``parse_spec`` gives the JAX package's clauses for the same spec, and
  a bad spec is refused at parse time naming ``MAGICSOUP_CHAOS``;
- an armed schedule fires the same hits as the JAX schedule, seeded
  ``%p~seed`` schedules included;
- :class:`BackoffPolicy` replays the JAX ladder (jitter included) and
  never touches the global random stream;
- the retry classification: storage errnos and every CUDA error text
  are never retried, the JAX package's transient markers are;
- the event ring, the runtime snapshot's chaos counters, ENOSPC and torn
  checkpoint writes, a recorder degrading on ``EIO`` and recovering;
- an armed plane that never fires leaves a stepper's trajectory as it
  was; a ``dispatch`` fault is absorbed by ``dispatch_retries``;
- ``guard/io.py`` loads as a file on its own and names its fault point
  (``chaos_site``); every registered fault point names a port callable.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import errno  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu.guard import backoff as jbackoff  # noqa: E402
from magicsoup_tpu.guard import chaos as jchaos  # noqa: E402
from magicsoup_tpu.guard import retry as jretry  # noqa: E402
from magicsoup_tpu.guard.errors import GuardConfigError as JGuardConfigError  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.guard import (  # noqa: E402
    CheckpointManager,
    GuardConfigError,
    TransientDispatchError,
    chaos,
)
from magicsoup_tpu_torch.guard.backoff import BackoffPolicy  # noqa: E402
from magicsoup_tpu_torch.guard.retry import is_transient_error, retry_call  # noqa: E402
from magicsoup_tpu_torch.telemetry import TelemetryRecorder, validate_rows  # noqa: E402

SPECS = [
    "checkpoint.write:enospc@2x3;fetch:delay:1.5;dispatch:transient x0 %0.25 ~7",
    "io.write:torn",
    "telemetry.emit:eio@4x0",
    "dispatch:transient x0 %0.3 ~11;dispatch:transient@2x1",
    "serve.queue:slow:0.5 x2 %0.9 ~3;registry.write:enospc",
]
CLAUSE_FIELDS = ("site", "kind", "arg", "after", "count", "prob", "seed")

KW = dict(
    mol_name="ATP",
    kill_below=1.0,
    divide_above=3.0,
    divide_cost=1.0,
    target_cells=30,
    genome_size=200,
    lag=1,
    max_divisions=64,
    spawn_block=16,
    push_block=16,
    p_mutation=1e-3,
    p_recombination=1e-4,
    megastep=2,
)


@pytest.fixture(autouse=True)
def _clean_plane():
    """The plane is process-global: each test starts and ends disarmed
    with zeroed counters, in both packages."""
    for mod in (chaos, jchaos):
        mod.disarm()
    runtime.reset_counters()
    jchaos.reset_counters()
    yield
    for mod in (chaos, jchaos):
        mod.disarm()
    runtime.reset_counters()
    jchaos.reset_counters()


def _clauses(plane) -> dict:
    return {
        site: [tuple(getattr(c, f) for f in CLAUSE_FIELDS) for c in clauses]
        for site, clauses in plane.items()
    }


def _fire_pattern(mod, spec: str, sites=("dispatch",), hits: int = 40) -> list:
    mod.arm(spec)
    out = []
    for _ in range(hits):
        for name in sites:
            f = mod.site(name)
            out.append(None if f is None else (f.site, f.kind, f.arg, f.index))
    mod.disarm()
    return out


def _world(seed: int):
    w = mt.World(chemistry=TCHEM, map_size=16, seed=seed, device="cpu")
    w.deterministic = True
    rng = random.Random(seed)
    w.spawn_cells([mt.random_genome(s=200, rng=rng) for _ in range(16)])
    w._ensure_capacity(100)
    return w


# ------------------------------------------------------------ parsing
@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equals_jax(spec):
    assert _clauses(chaos.parse_spec(spec)) == _clauses(jchaos.parse_spec(spec))


def test_sites_and_grammar_constants_equal_jax():
    assert chaos.SITES == jchaos.SITES
    assert chaos.__all__ == jchaos.__all__
    assert chaos._CLAUSE_RE.pattern == jchaos._CLAUSE_RE.pattern


@pytest.mark.parametrize(
    "bad,needle",
    [
        ("nonsense", "unparseable"),
        ("nowhere.site:eio", "unknown chaos site"),
        ("fetch:eio", "does not understand"),
        ("fetch:delay", "needs a seconds"),
        ("dispatch:transient%1.5", "probability"),
    ],
)
def test_bad_specs_refuse_at_parse_time(bad, needle):
    with pytest.raises(GuardConfigError, match=needle) as e:
        chaos.parse_spec(bad)
    assert e.value.variable == "MAGICSOUP_CHAOS" and e.value.value
    with pytest.raises(JGuardConfigError, match=needle):
        jchaos.parse_spec(bad)


def test_arm_disarm_roundtrip():
    assert not chaos.armed() and chaos.spec() is None
    assert chaos.site("dispatch") is None
    chaos.arm("dispatch:transient")
    assert chaos.armed() and chaos.spec() == "dispatch:transient"
    assert chaos.site("fetch") is None  # another site stays silent
    assert chaos.site("dispatch").kind == "transient"
    assert chaos.site("dispatch") is None  # x1 by default
    chaos.disarm()
    assert not chaos.armed()


# ----------------------------------------------------------- schedules
@pytest.mark.parametrize(
    "spec,sites",
    [
        ("dispatch:transient@3x2", ("dispatch",)),
        ("dispatch:transient x0 %0.3 ~11", ("dispatch",)),
        ("dispatch:transient x0 %0.3 ~12", ("dispatch",)),
        ("fetch:delay:2 x5 %0.5 ~1;dispatch:transient@2x0 %0.2 ~9", ("fetch", "dispatch")),
        ("checkpoint.write:enospc@1x1;checkpoint.write:torn@1x0", ("checkpoint.write",)),
    ],
)
def test_fire_schedule_equals_jax(spec, sites):
    ours = _fire_pattern(chaos, spec, sites)
    assert ours == _fire_pattern(jchaos, spec, sites)
    assert any(f is not None for f in ours)


def test_probabilistic_schedule_is_seed_deterministic():
    a = _fire_pattern(chaos, "dispatch:transient x0 %0.3 ~11")
    b = _fire_pattern(chaos, "dispatch:transient x0 %0.3 ~11")
    c = _fire_pattern(chaos, "dispatch:transient x0 %0.3 ~12")
    assert a == b
    assert 0 < sum(f is not None for f in a) < 40
    assert a != c


def test_first_eligible_clause_wins_and_all_observe():
    chaos.arm("checkpoint.write:enospc@1x1;checkpoint.write:torn@1x0")
    first = chaos.site("checkpoint.write")
    second = chaos.site("checkpoint.write")
    assert (first.kind, second.kind) == ("enospc", "torn")
    assert chaos.fired_counts() == {"checkpoint.write": 2}
    assert second.index == 1


def test_fault_as_oserror_carries_errno():
    chaos.arm("checkpoint.write:enospc")
    exc = chaos.site("checkpoint.write").as_oserror()
    assert isinstance(exc, OSError) and exc.errno == errno.ENOSPC
    assert "checkpoint.write" in str(exc)


def test_fault_points_name_port_callables():
    rows = chaos.fault_points()
    assert {r["site"] for r in rows} <= set(chaos.SITES)
    for r in rows:
        assert r["module"].startswith("magicsoup_tpu_torch.")
        obj = importlib.import_module(r["module"])
        for part in r["callable"].split("."):
            obj = getattr(obj, part)
        assert callable(obj), r


# ------------------------------------------------------------- backoff
def test_backoff_ladder_and_cap():
    pol = BackoffPolicy(base=0.5, factor=2.0, max_delay=3.0)
    assert pol.schedule(5) == [0.5, 1.0, 2.0, 3.0, 3.0]
    with pytest.raises(GuardConfigError):
        pol.delay(0)
    with pytest.raises(ValueError):
        BackoffPolicy(base=1.0, jitter=1.0)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(base=0.5),
        dict(base=1.0, factor=3.0, max_delay=20.0),
        dict(base=1.0, jitter=0.5, seed=3),
        dict(base=0.25, jitter=0.9, seed=4, max_delay=2.0),
    ],
)
def test_backoff_schedule_equals_jax(cfg):
    state = random.getstate()
    ours = BackoffPolicy(**cfg).schedule(8)
    assert random.getstate() == state  # never touches the global stream
    assert ours == jbackoff.BackoffPolicy(**cfg).schedule(8)
    assert repr(BackoffPolicy(**cfg)) == repr(jbackoff.BackoffPolicy(**cfg))


def test_backoff_injectable_clock():
    slept = []
    assert BackoffPolicy(base=2.0).sleep(3, sleep=slept.append) == 8.0
    assert slept == [8.0]


# --------------------------------------------------------------- retry
@pytest.mark.parametrize(
    "text",
    [
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: device-side assert triggered",
        "CUDA out of memory. Tried to allocate 2.00 GiB",
        "CUDA error: CUDA-capable device(s) is/are busy or UNAVAILABLE",
        "cudaErrorLaunchFailure: unspecified launch failure",
        "CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm",
        "CUDA runtime error (2) : out of memory",
        "AcceleratorError: CUDA error: misaligned address",
    ],
)
def test_cuda_errors_are_sticky_never_retried(text):
    assert not is_transient_error(RuntimeError(text))
    calls = {"n": 0}

    def launch():
        calls["n"] += 1
        raise RuntimeError(text)

    with pytest.raises(RuntimeError):
        retry_call(launch, retries=5, sleep=lambda d: None)
    assert calls["n"] == 1


@pytest.mark.parametrize(
    "exc",
    [
        RuntimeError("UNAVAILABLE: socket closed"),
        RuntimeError("DEADLINE_EXCEEDED: rpc"),
        ConnectionError("Socket closed"),
        RuntimeError("Connection reset by peer"),
        RuntimeError("transport is closing"),
        RuntimeError("RESOURCE_EXHAUSTED: Attempting to reserve 4 GiB"),
        ValueError("a shape error"),
        OSError(errno.EIO, "UNAVAILABLE"),
    ],
)
def test_transient_classification_equals_jax(exc):
    assert is_transient_error(exc) == jretry.is_transient_error(exc)


def test_storage_errnos_never_retried():
    for code in (errno.ENOSPC, errno.EROFS, errno.EDQUOT):
        assert not is_transient_error(OSError(code, "boom"))
    calls = {"n": 0}

    def dead_disk():
        calls["n"] += 1
        raise OSError(errno.ENOSPC, "UNAVAILABLE: no space left")

    with pytest.raises(OSError):
        retry_call(dead_disk, retries=5, sleep=lambda d: None)
    assert calls["n"] == 1


# ----------------------------------------------------------- event ring
def test_events_since_cursors_are_independent_and_monotone():
    cur_a = chaos.events_since(0)[0]
    cur_b = cur_a
    chaos.arm("dispatch:transient@1x1")
    chaos.site("dispatch")
    chaos.note_degraded("sub.x", "why")
    cur_a, rows_a = chaos.events_since(cur_a)
    assert [r["type"] for r in rows_a] == ["chaos", "degraded"]
    assert chaos.events_since(cur_a)[1] == []
    chaos.clear_degraded("sub.x")
    _, rows_b = chaos.events_since(cur_b)
    assert [r["type"] for r in rows_b] == ["chaos", "degraded", "degraded"]
    assert [r.get("state") for r in rows_b[1:]] == ["degraded", "recovered"]
    runtime.reset_counters()
    cur_a, rows = chaos.events_since(cur_a)
    assert rows == []
    chaos.note_counter("x")
    assert chaos.events_since(cur_a)[1] == []


def test_runtime_snapshot_merges_chaos_counters():
    chaos.arm("dispatch:transient@1x1")
    chaos.site("dispatch")
    chaos.note_degraded("sub.y", "detail")
    chaos.note_counter("widget_failures", 3)
    snap = runtime.snapshot()
    assert snap["chaos_fired"] == 1
    assert snap["degraded"] == 1
    assert snap["widget_failures"] == 3
    runtime.reset_counters()
    snap = runtime.snapshot()
    assert snap["chaos_fired"] == 0 and snap["degraded"] == 0
    assert "widget_failures" not in snap


# ----------------------------------------------------- checkpoint writes
def test_enospc_mid_save_leaves_no_torn_file_and_next_save_lands(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", keep=3)
    chaos.arm("checkpoint.write:enospc@1x1")
    with pytest.raises(OSError) as ei:
        mgr.save({"step": 1}, step=1)
    assert ei.value.errno == errno.ENOSPC
    assert list((tmp_path / "ckpt").iterdir()) == []  # no temp, no torn file
    assert mgr.failure_counters()["save_failures"] == 1
    assert runtime.snapshot()["checkpoint_save_failures"] == 1
    mgr.save({"step": 2}, step=2)
    payload, _meta, _path = mgr.load_latest()
    assert payload["step"] == 2
    assert mgr.failure_counters()["consecutive_save_failures"] == 0


def test_torn_write_walks_back(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", keep=3)
    chaos.arm("checkpoint.write:torn@2x1")
    mgr.save({"v": 1}, step=1)
    mgr.save({"v": 2}, step=2)  # torn on disk, returns normally
    with pytest.warns(UserWarning, match="falling back"):
        payload, _meta, path = mgr.load_latest()
    assert payload["v"] == 1 and "0000000001" in path.name


def test_delete_failure_is_counted_once_warned(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", keep=1)
    mgr.save({"v": 0}, step=0)
    chaos.arm("checkpoint.delete:eio x0")
    with pytest.warns(UserWarning, match="could not delete"):
        mgr.save({"v": 1}, step=1)
    mgr.save({"v": 2}, step=2)  # retried, counted again, warned once
    assert mgr.failure_counters()["delete_failures"] == 3
    assert runtime.snapshot()["checkpoint_delete_failures"] == 3
    chaos.disarm()
    mgr.save({"v": 3}, step=3)
    assert [s for s, _ in mgr.checkpoints()] == [3]


def test_read_fault_is_the_io_check(tmp_path):
    from magicsoup_tpu_torch.guard import CheckpointError, read_checkpoint, write_checkpoint

    path = write_checkpoint(tmp_path / "x.msck", {"v": 1})
    chaos.arm("checkpoint.read:eio")
    with pytest.raises(CheckpointError) as e:
        read_checkpoint(path)
    assert e.value.check == "io"
    assert read_checkpoint(path)[0] == {"v": 1}  # x1: the next read lands


# ----------------------------------------------------------- guard/io.py
def test_io_loads_standalone_and_names_its_fault_point(tmp_path):
    path = Path(mt.__file__).parent / "guard" / "io.py"
    spec = importlib.util.spec_from_file_location("_standalone_io", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod._chaos_probe is None  # loaded alone: disarmed
    mod.atomic_write_bytes(tmp_path / "a.bin", b"abc", chaos_site="checkpoint.write")
    assert (tmp_path / "a.bin").read_bytes() == b"abc"
    # the package's io module carries the registered probe
    from magicsoup_tpu_torch.guard import io as tio

    assert tio._chaos_probe is chaos.site
    chaos.arm("io.write:eio;checkpoint.write:enospc")
    with pytest.raises(OSError) as e:
        tio.atomic_write_text(tmp_path / "b.txt", "x")
    assert e.value.errno == errno.EIO
    with pytest.raises(OSError) as e:
        tio.atomic_write_bytes(tmp_path / "c.bin", b"x", chaos_site="checkpoint.write")
    assert e.value.errno == errno.ENOSPC
    assert not (tmp_path / "b.txt").exists() and not (tmp_path / "c.bin").exists()


# -------------------------------------------------- telemetry degradation
def test_recorder_degrades_counted_and_recovers_on_attach(tmp_path):
    rec = TelemetryRecorder(flush_every=1)
    rec.attach(tmp_path / "a.jsonl")
    chaos.arm("telemetry.emit:eio@1x1")
    with pytest.warns(UserWarning, match="degraded"):
        rec.emit({"type": "note", "i": 0})
    assert rec.degraded and "EIO" in rec.degraded_reason.upper()
    rec.emit({"type": "note", "i": 1})  # dropped, but counted
    assert rec.rows_dropped >= 1
    assert "telemetry.emit" in chaos.degraded_states()
    rec.attach(tmp_path / "b.jsonl")
    assert not rec.degraded
    rec.emit_counters()
    rec.detach()
    rows = [json.loads(line) for line in (tmp_path / "b.jsonl").read_text().splitlines()]
    assert validate_rows(rows) == []
    kinds = [r["type"] for r in rows]
    assert "chaos" in kinds and "degraded" in kinds
    counters = next(r for r in rows if r["type"] == "counters")["counters"]
    assert counters["telemetry_rows_dropped"] >= 1


# ------------------------------------------------------ stepper contracts
def _run(spec: str | None, retries: int = 0, dispatches: int = 4):
    w = _world(5)
    st = mt.PipelinedStepper(w, dispatch_retries=retries, **KW)
    if spec:
        chaos.arm(spec)
    for _ in range(dispatches):
        st.step()
    st.flush()
    chaos.disarm()
    return st, (
        int(w.n_cells),
        w.molecule_map.numpy().tobytes(),
        np.asarray(w.cell_molecules).tobytes(),
        list(w.cell_genomes),
    )


def test_armed_but_silent_plane_is_trajectory_invisible(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    _, baseline = _run(None)
    _, shadowed = _run("dispatch:transient@100000x1;fetch:delay:5@100000")
    assert shadowed == baseline
    assert chaos.fired_counts() == {}


def test_dispatch_fault_is_absorbed_by_retries(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    _, baseline = _run(None)
    st, faulted = _run("dispatch:transient@2x2", retries=3)
    assert st.stats["dispatch_retries"] == 2
    assert faulted == baseline
    # without a retry budget the fault reaches the caller, typed
    with pytest.raises(TransientDispatchError):
        _run("dispatch:transient@2x1", retries=0)
