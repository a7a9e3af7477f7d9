"""
The port's guard plane (``guard/``) against the JAX package's, on the
CPU.  Everything here is exact (no tolerance):

- MSCK checkpoint files: for the same plain-data payload and meta the
  port writes the JAX package's bytes, and each package reads the
  other's; the magic, header, version, truncation and digest checks;
  retention and ``load_latest``'s walk-back;
- the schema-1 migration: a port world pickled without a genome backend
  loads as a string world (and continues on the token backend on
  request); a foreign schema-1 payload fails the ``migrate`` check;
- the classic loop's kill-and-resume is bit-identical to the
  uninterrupted run;
- the four sentinel policies over an injected NaN (the policy leaves a
  clean trajectory as it was; warn counts and warns; quarantine kills
  the poisoned cell; rollback raises), and the audit's typed report
  after each corruption injector;
- the bounded dispatch retry: a fault before anything is enqueued is
  absorbed; a failure once the dispatch has started enqueueing is not
  retried; ``retry_call``'s ladder;
- ``MAGICSOUP_GUARD_FETCH_TIMEOUT`` read by the stepper and the fleet, a
  malformed value refused naming it, a ``fetch:delay`` past it raising
  ``WatchdogTimeout`` with one diagnostics record; the watchdog firing
  once; ``GracefulShutdown`` latching;
- the public names (``guard.__all__``, the error classes) equal the JAX
  package's; ``restore_run`` without a card names ``device="cpu"``.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
import pickle  # noqa: E402
import random  # noqa: E402
import signal  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu import guard as jguard  # noqa: E402
from magicsoup_tpu.guard import errors as jerrors  # noqa: E402
from magicsoup_tpu_torch import guard  # noqa: E402
from magicsoup_tpu_torch import stepper as tstepper  # noqa: E402
from magicsoup_tpu_torch.check import audit_world  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.guard import CheckpointError, CheckpointManager, SentinelTripped  # noqa: E402
from magicsoup_tpu_torch.guard import checkpoint as ckpt_mod  # noqa: E402
from magicsoup_tpu_torch.guard import chaos, errors  # noqa: E402
from magicsoup_tpu_torch.workload import sim_step  # noqa: E402

ATP = TCHEM.molname_2_idx["ATP"]
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
)
# a run in which nothing is born, dies or evolves: a poisoned cell stays
QUIET = dict(KW, kill_below=-1.0, divide_above=1e30, target_cells=None, p_mutation=0.0, p_recombination=0.0)
PAYLOADS = [
    ({"a": [1, 2]}, {"step": 3}),
    (list(range(512)), None),
    ({"nested": {"x": (1.5, "s", None, b"\x00\xff")}, "n": 2**40}, {"step": 0, "note": "é"}),
    ("text", {"z": 1, "a": [True, False]}),
]


@pytest.fixture(autouse=True)
def _det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    chaos.disarm()
    yield
    chaos.disarm()


def _world(seed=5, n_cells=24, backend="string"):
    w = mt.World(chemistry=TCHEM, map_size=16, seed=seed, device="cpu", genome_backend=backend)
    rng = random.Random(seed)
    w.spawn_cells([mt.random_genome(s=200, rng=rng) for _ in range(n_cells)])
    w._ensure_capacity(100)
    return w


def _state(world) -> dict:
    n = world.n_cells
    return {
        "n": n,
        "genomes": list(world.cell_genomes),
        "mm": world.molecule_map.numpy().tobytes(),
        "cm": np.asarray(world.cell_molecules)[:n].tobytes(),
        "positions": np.asarray(world.cell_positions).tobytes(),
        "lifetimes": np.asarray(world.cell_lifetimes).tobytes(),
        "rng": world._rng.getstate(),
        "nprng": repr(world._nprng.bit_generator.state),
    }


# -------------------------------------------------------- public names
def test_public_names_and_error_classes_equal_jax():
    assert guard.__all__ == jguard.__all__
    for name in ("GuardConfigError", "TransientDispatchError", "CheckpointError", "WatchdogTimeout"):
        assert hasattr(errors, name) and hasattr(jerrors, name)
    e = errors.GuardConfigError("bad", variable="X", value="y")
    assert (e.variable, e.value) == ("X", "y") and isinstance(e, errors.GuardError)
    t = errors.TransientDispatchError()
    assert str(t) == str(jerrors.TransientDispatchError())
    assert guard.is_transient_error(t)


# ---------------------------------------------------- checkpoint files
@pytest.mark.parametrize("payload,meta", PAYLOADS)
def test_msck_bytes_equal_jax_and_each_reads_the_other(tmp_path, payload, meta):
    tp = guard.write_checkpoint(tmp_path / "t.msck", payload, meta=meta)
    jp = jguard.write_checkpoint(tmp_path / "j.msck", payload, meta=meta)
    assert tp.read_bytes() == jp.read_bytes()
    assert guard.read_checkpoint(jp) == jguard.read_checkpoint(tp)
    assert guard.read_checkpoint(jp)[0] == payload
    assert guard.inspect_checkpoint(tp) == jguard.inspect_checkpoint(jp)


def test_checkpoint_roundtrip_and_inspect(tmp_path):
    path = tmp_path / "x.msck"
    guard.write_checkpoint(path, {"a": [1, 2]}, meta={"step": 3})
    payload, meta = guard.read_checkpoint(path)
    assert payload == {"a": [1, 2]} and meta["step"] == 3
    info = guard.inspect_checkpoint(path)
    assert info["schema"] == guard.SCHEMA_VERSION == 2 and info["meta"]["step"] == 3


def test_corrupted_checkpoint_rejected_typed(tmp_path):
    path = tmp_path / "x.msck"
    guard.write_checkpoint(path, list(range(512)))
    raw = path.read_bytes()
    guard.flip_byte(path)  # a payload byte: the digest check
    with pytest.raises(CheckpointError) as e:
        guard.read_checkpoint(path)
    assert e.value.check == "digest"
    path.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(CheckpointError) as e:
        guard.read_checkpoint(path)
    assert e.value.check == "truncated"
    path.write_bytes(b"JUNK" + raw)
    with pytest.raises(CheckpointError) as e:
        guard.read_checkpoint(path)
    assert e.value.check == "magic"
    path.write_bytes(b"MSCK\n{not json\n" + raw)
    with pytest.raises(CheckpointError) as e:
        guard.inspect_checkpoint(path)
    assert e.value.check == "header"


def test_schema_version_mismatch_rejected(tmp_path, monkeypatch):
    path = tmp_path / "future.msck"
    monkeypatch.setattr(ckpt_mod, "SCHEMA_VERSION", 999)
    guard.write_checkpoint(path, {"from": "the future"})
    monkeypatch.undo()
    with pytest.raises(CheckpointError) as e:
        guard.read_checkpoint(path)
    assert e.value.check == "version" and "999" in str(e.value)


def test_manager_retention_and_fallback(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in range(5):
        mgr.save({"step": step}, step=step)
    kept = mgr.checkpoints()
    assert [s for s, _ in kept] == [3, 4]
    assert mgr.latest() == kept[-1][1]
    payload, _meta, used = mgr.load_latest()
    assert payload == {"step": 4} and used == kept[-1][1]
    guard.flip_byte(kept[-1][1])
    with pytest.warns(UserWarning, match="skipping"):
        payload, _meta, used = mgr.load_latest()
    assert payload == {"step": 3} and used == kept[0][1]
    guard.flip_byte(kept[0][1])
    with pytest.raises(CheckpointError) as e:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mgr.load_latest()
    assert e.value.check == "none"
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path, keep=0)
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path, prefix="a/b")


# ------------------------------------------------------- schema 1 (F4)
_GETSTATE = mt.World.__getstate__


def _legacy_getstate(self):
    """A port world's pickle as a schema-1 writer laid it out: the genome
    list under ``cell_genomes``, no genome backend and no store."""
    state = _GETSTATE(self)
    state["cell_genomes"] = state.pop("_genomes_list")
    for key in ("genome_backend", "_genome_store", "telemetry"):
        state.pop(key)
    return state


@pytest.mark.parametrize("backend", ["string", "token"])
def test_schema1_port_payload_loads_as_a_string_world(tmp_path, monkeypatch, backend):
    w = _world(seed=31, n_cells=9)
    seqs = list(w.cell_genomes)
    path = tmp_path / "v1.msck"
    monkeypatch.setattr(ckpt_mod, "SCHEMA_VERSION", 1)
    monkeypatch.setattr(mt.World, "__getstate__", _legacy_getstate)
    guard.write_checkpoint(path, guard.snapshot_run(w, None), meta={"step": 0})
    monkeypatch.undo()
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    assert guard.inspect_checkpoint(path)["schema"] == 1
    payload, meta = guard.read_checkpoint(path)
    assert meta["migrated_from"] == 1
    assert payload["world"].genome_backend == "string"
    world, aux, meta2 = guard.restore_run(path, device="cpu", genome_backend=backend, audit=True)
    assert aux is None and meta2["migrated_from"] == 1
    assert world.genome_backend == backend
    assert list(world.cell_genomes) == seqs
    assert isinstance(world.telemetry, mt.telemetry.TelemetryRecorder)
    world.enzymatic_activity()  # the migrated world steps


def test_schema1_migration_rejects_a_foreign_world(tmp_path, monkeypatch):
    from types import SimpleNamespace

    fake = SimpleNamespace(genome_backend="string", cell_genomes=["TCGA"], n_cells=3)
    path = tmp_path / "bad.msck"
    monkeypatch.setattr(ckpt_mod, "SCHEMA_VERSION", 1)
    guard.write_checkpoint(path, fake)
    guard.write_checkpoint(tmp_path / "bad2.msck", {"world": SimpleNamespace(n_cells=1)})
    monkeypatch.undo()
    for p in (path, tmp_path / "bad2.msck"):
        with pytest.raises(CheckpointError) as e:
            guard.read_checkpoint(p)
        assert e.value.check == "migrate"


# ------------------------------------------------------ classic resume
def test_classic_loop_kill_resume_bit_identity(tmp_path):
    K = 3

    def drive(world, rng, steps):
        for _ in range(steps):
            sim_step(world, rng, n_cells=30, genome_size=200, atp_idx=ATP)

    wa, ra = _world(seed=13), random.Random(13)
    drive(wa, ra, 2 * K)
    wb, rb = _world(seed=13), random.Random(13)
    drive(wb, rb, K)
    mgr = CheckpointManager(tmp_path, keep=2)
    guard.save_run(mgr, wb, step=K)
    del wb
    wb, aux, meta = guard.restore_run(mgr, device="cpu", audit=True)
    assert aux is None and meta["step"] == K
    drive(wb, rb, K)
    assert _state(wb) == _state(wa)


def test_restore_run_device_rules(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)
    guard.save_run(mgr, _world(n_cells=4), step=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        guard.restore_run(mgr)
    # restore_run(mesh=) is ported: the mesh names the device itself
    with pytest.raises(ValueError, match="mutually exclusive"):
        guard.restore_run(mgr, device="cpu", mesh=object())
    with pytest.raises(CheckpointError) as e:
        guard.restore_run(mgr, device="cpu", genome_backend="rope")
    assert e.value.check == "config"
    bad = guard.write_checkpoint(tmp_path / "x.msck", {"format": "other"})
    with pytest.raises(CheckpointError) as e:
        guard.restore_run(bad, device="cpu")
    assert e.value.check == "format"


# ---------------------------------------------------- sentinel policies
def _fingerprint(world, st):
    guard.snapshot_run(world, st)
    return _state(world)


def test_sentinel_policy_does_not_change_trajectory():
    def run(policy):
        w = _world(seed=21)
        st = mt.PipelinedStepper(w, **dict(KW, sentinel_policy=policy))
        for _ in range(4):
            st.step()
        return _fingerprint(w, st)

    assert run("warn") == run("rollback") == run("quarantine")


def test_sentinel_nan_warn_policy_counts_and_warns():
    w = _world()
    st = mt.PipelinedStepper(w, **dict(QUIET, sentinel_policy="warn"))
    st.step()
    st.drain()
    assert st.stats["sentinel_trips"] == 0
    guard.inject_nan(st)
    with pytest.warns(UserWarning, match="sentinel"):
        st.step()
        st.drain()
    assert st.stats["sentinel_trips"] >= 1
    assert guard.decode_health(0b0100)["cm_nonfinite"] is True
    st.flush()


def test_sentinel_rollback_policy_raises_typed():
    w = _world()
    st = mt.PipelinedStepper(w, **dict(QUIET, sentinel_policy="rollback"))
    st.step()
    st.drain()
    guard.inject_nan(st)
    with pytest.raises(SentinelTripped) as e:
        for _ in range(4):
            st.step()
        st.drain()
    assert e.value.flags != 0 and e.value.n_bad_cells >= 1


def test_sentinel_quarantine_policy_kills_poisoned_cells():
    w = _world()
    st = mt.PipelinedStepper(w, **dict(QUIET, sentinel_policy="quarantine"))
    st.step()
    st.drain()
    n_before = w.n_cells
    guard.inject_nan(st)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st.step()
        st.drain()
        st.step()  # the quarantine runs at the next dispatch boundary
    st.flush()
    assert st.stats["quarantined"] >= 1
    assert w.n_cells < n_before
    assert np.isfinite(np.asarray(w.cell_molecules)[: w.n_cells]).all()
    assert np.isfinite(w.molecule_map.numpy()).all()


def test_invalid_sentinel_policy_rejected():
    with pytest.raises(ValueError, match="sentinel_policy"):
        mt.PipelinedStepper(_world(n_cells=4), **dict(KW, sentinel_policy="explode"))


def test_injectors_and_the_audit(tmp_path):
    w = _world(n_cells=12)
    assert audit_world(w) == []
    r, c = guard.desync_cell_map(w)
    assert "cell_map_desync" in {v.code for v in audit_world(w)}
    w._np_cell_map[r, c] = True
    assert audit_world(w) == []
    guard.inject_dead_residue(w)
    assert "dead_cm_residue" in {v.code for v in audit_world(w)}
    w2 = _world(n_cells=12)
    guard.corrupt_params_row(w2)
    assert "params_genome_mismatch" in {v.code for v in audit_world(w2)}
    w3 = _world(n_cells=12)
    cm0 = w3._cell_molecules
    guard.inject_nan(w3, row=1, mol=2)
    assert torch.isnan(w3._cell_molecules[1, 2]) and not torch.isnan(cm0).any()


def test_fleet_injectors_poison_one_world(tmp_path):
    fleet = mt.FleetScheduler(block=4)
    for s in (1, 2):
        fleet.admit(_world(seed=s, n_cells=12), **dict(QUIET, sentinel_policy="warn"))
    fleet.step()
    fleet.drain()
    guard.poison_world_mm(fleet, 1)
    with pytest.warns(UserWarning, match="sentinel"):
        fleet.step()
        fleet.drain()
    assert [lane.stats["sentinel_trips"] for lane in fleet.lanes] == [0, 1]
    row = guard.corrupt_world_params(fleet, 0)
    fleet.flush()
    assert "params_genome_mismatch" in {v.code for v in audit_world(fleet.lanes[0].world)}
    assert row >= 0


# ------------------------------------------------------ dispatch retry
def test_dispatch_retry_absorbs_transient_fault():
    def run(inject):
        w = _world()
        st = mt.PipelinedStepper(w, **dict(KW, dispatch_retries=2))
        st.step()
        st.drain()
        if inject:
            guard.inject_dispatch_failures(st, n=1)
        for _ in range(3):
            st.step()
        return st, _fingerprint(w, st)

    st, faulted = run(True)
    assert st.stats["dispatch_retries"] == 1
    assert faulted == run(False)[1]
    with pytest.raises(TypeError):
        guard.inject_dispatch_failures(object())


def test_dispatch_retry_refused_once_enqueueing_started(monkeypatch):
    # the step body writes parameter rows in place: a failure after the
    # first launch must not be retried on half-written state
    w = _world()
    st = mt.PipelinedStepper(w, **dict(KW, dispatch_retries=3))
    st.step()
    st.drain()
    calls = {"n": 0}

    def failing_megastep(state, params, *a, **k):
        calls["n"] += 1
        params[0][0, 0, 0] = params[0][0, 0, 0]  # an in-place write went out
        raise RuntimeError("UNAVAILABLE: lost after the first launch")

    monkeypatch.setattr(tstepper, "megastep", failing_megastep)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        st.step()
    assert calls["n"] == 1 and st.stats["dispatch_retries"] == 0


def test_retry_call_backoff_and_nontransient_passthrough():
    calls = {"n": 0}
    delays = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise guard.TransientDispatchError()
        return "ok"

    assert guard.retry_call(flaky, retries=3, sleep=delays.append) == "ok"
    assert calls["n"] == 3 and delays == [0.5, 1.0]

    def broken():
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        guard.retry_call(broken, retries=5, sleep=delays.append)


# --------------------------------------------------- watchdog (F1) etc.
def test_fetch_timeout_read_from_the_environment(monkeypatch):
    from magicsoup_tpu_torch.guard.watchdog import fetch_timeout

    monkeypatch.delenv("MAGICSOUP_GUARD_FETCH_TIMEOUT", raising=False)
    assert fetch_timeout() == 300.0
    monkeypatch.setenv("MAGICSOUP_GUARD_FETCH_TIMEOUT", "7.5")
    w = _world(n_cells=4)
    assert mt.PipelinedStepper(w, **KW)._fetch_timeout == 7.5
    assert mt.PipelinedStepper(w, **dict(KW, fetch_timeout=2))._fetch_timeout == 2.0
    fleet = mt.FleetScheduler(block=2)
    lane = fleet.admit(_world(n_cells=4), **KW)
    assert lane._fetch_timeout == 7.5
    for bad in ("soon", "-1", "0", "nan", "inf"):
        monkeypatch.setenv("MAGICSOUP_GUARD_FETCH_TIMEOUT", bad)
        with pytest.raises(guard.GuardConfigError, match="MAGICSOUP_GUARD_FETCH_TIMEOUT") as e:
            mt.PipelinedStepper(w, **KW)
        assert e.value.variable == "MAGICSOUP_GUARD_FETCH_TIMEOUT" and e.value.value == bad


def test_fetch_delay_past_the_budget_raises_with_diagnostics(monkeypatch, capfd):
    monkeypatch.setenv("MAGICSOUP_GUARD_FETCH_TIMEOUT", "0.2")
    w = _world(n_cells=8)
    st = mt.PipelinedStepper(w, **QUIET)
    st.step()
    chaos.arm("fetch:delay:5")
    t0 = time.perf_counter()
    with pytest.raises(guard.WatchdogTimeout) as e:
        st.step()  # at lag 1 the step replays its own record
        st.drain()
    assert time.perf_counter() - t0 < 2.0  # held for the budget, not the delay
    assert e.value.phase == "fetch" and e.value.seconds == 0.2
    err = capfd.readouterr().err
    records = [json.loads(line) for line in err.splitlines() if line.startswith('{"diagnostic"')]
    assert len(records) == 1 and records[0]["diagnostic"] == "stepper fetch timed out"
    assert records[0]["timeout_s"] == 0.2


def test_dump_diagnostics_never_raises(capfd):
    class Unprintable:
        def __repr__(self):
            raise RuntimeError("no")

    rec = guard.dump_diagnostics("t", {"x": 1, "y": Unprintable()})
    assert rec["diagnostic"] == "t" and rec["x"] == 1
    assert "cuda_memory_allocated" not in rec  # no card in use here
    capfd.readouterr()


def test_watchdog_fires_diagnostics_once():
    fired = []
    wd = guard.Watchdog(0.05, tag="t", on_timeout=lambda name, s: fired.append(name))
    with wd.phase("slow"):
        time.sleep(0.2)
    with wd.phase("fast"):
        pass
    assert fired == ["slow"] and wd.fired == 1


def test_graceful_shutdown_latches_signal():
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers need the main thread")
    before = signal.getsignal(signal.SIGTERM)
    with guard.GracefulShutdown() as stop:
        assert not stop and not stop.requested
        signal.raise_signal(signal.SIGTERM)
        assert stop and stop.signum == signal.SIGTERM and stop.wait(0)
    assert signal.getsignal(signal.SIGTERM) is before


def test_world_pickle_without_a_backend_adopts_the_string_layout():
    w = _world(n_cells=6)
    state = _legacy_getstate(w)
    back = pickle.loads(pickle.dumps(state))
    old = mt.World.__new__(mt.World)
    old.__setstate__(back)
    assert old.genome_backend == "string" and old._genome_store is None
    assert list(old.cell_genomes) == list(w.cell_genomes)
    assert audit_world(old) == []
