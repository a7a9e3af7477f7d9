"""
The port's fleet warden (``magicsoup_tpu_torch.fleet.warden``) against the
JAX package's (``magicsoup_tpu.fleet.warden``) on the same schedule, in
deterministic mode, as ``tests/fast/test_fleet_warden.py`` holds the JAX
one:

- quarantine: only the poisoned world is evicted, the healthy worlds are
  bit-equal to an unpoisoned run and to the JAX warden's worlds, the
  statuses are typed and equal the JAX warden's, the parked lane is a
  standalone stepper, the telemetry rows validate; ``warn`` only counts;
- heal: the poisoned world restores from its own rolling stream and
  readmits into its group (no new group, no new stack shape), the
  healthy worlds bit-equal to the unpoisoned warden run, the statuses
  equal the JAX warden's; the circuit breaker parks a world that keeps
  tripping; the streams share one directory and walk back on their own;
- suspend and resume keep a world's trajectory; adopt and reserve_label
  steer the labels; a timed-out shared fetch raises the typed error; the
  config refusals.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
import random  # noqa: E402
from concurrent.futures import Future  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu import fleet as jfleet  # noqa: E402
from magicsoup_tpu import guard as jguard  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu_torch import guard  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.fleet import FleetScheduler, FleetWarden, WardenStatus  # noqa: E402
from magicsoup_tpu_torch.fleet.scheduler import _SharedFetch  # noqa: E402
from magicsoup_tpu_torch.guard import (  # noqa: E402
    CheckpointError,
    CheckpointManager,
    GuardConfigError,
    WatchdogTimeout,
    flip_byte,
    poison_world_mm,
)
from magicsoup_tpu_torch.telemetry import validate_rows  # noqa: E402

#: chemistry only: populations never change, the det schedule is plain
KW = dict(
    mol_name="ATP",
    kill_below=-1.0,
    divide_above=1e30,
    divide_cost=0.0,
    target_cells=None,
    genome_size=300,
    lag=1,
    max_divisions=64,
    spawn_block=16,
    p_mutation=0.0,
    p_recombination=0.0,
    megastep=2,
)
SEEDS = (10, 11, 12)


@pytest.fixture(scope="module", autouse=True)
def det():
    mp = pytest.MonkeyPatch()
    mp.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    yield
    mp.undo()


def _world(lib, chem, seed: int, **kw):
    w = lib.World(chemistry=chem, map_size=16, seed=seed, **kw)
    rng = random.Random(seed)
    w.spawn_cells([lib.random_genome(s=300, rng=rng) for _ in range(20)])
    return w


def _tworld(seed: int):
    return _world(mt, TCHEM, seed, device="cpu")


def _jworld(seed: int):
    return _world(ms, JCHEM, seed)


def _state(world) -> dict:
    """A world's state as host arrays (either package)."""
    mm = world.molecule_map
    return {
        "n": world.n_cells,
        "mm": np.asarray(mm.cpu() if torch.is_tensor(mm) else mm),
        "cm": np.asarray(world.cell_molecules)[: world.n_cells],
        "pos": np.asarray(world.cell_positions),
        "genomes": list(world.cell_genomes),
    }


def _fingerprint(lane) -> dict:
    snap = guard.snapshot_run(lane.world, lane)
    return {**_state(lane.world), "key": np.asarray(snap["stepper"]["key"]),
            "rng": repr(snap["stepper"]["rng_state"])}


def _assert_identical(a: dict, b: dict, label: str = "") -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].tobytes() == b[k].tobytes(), f"{label}{k} differs"
        else:
            assert a[k] == b[k], f"{label}{k} differs"


def _status_view(statuses) -> list:
    return [(s.label, s.status, s.trips, s.restarts, s.reason is None) for s in statuses]


def _read_rows(path):
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


# ------------------------------------------------------------ quarantine
@pytest.fixture(scope="module")
def quarantine_run(tmp_path_factory):
    """Three worlds, world 1 poisoned before step 2 of 6 under
    ``quarantine``; the same schedule unpoisoned without a warden (no
    cadence, so no flush differs); the JAX warden on the same schedule."""
    T, poison_at = 6, 2
    base = FleetScheduler(block=4)
    base_lanes = [base.admit(_tworld(s), **KW) for s in SEEDS]
    for _ in range(T):
        base.step()
    base.flush()
    base_fp = [_fingerprint(lane) for lane in base_lanes]

    tel = tmp_path_factory.mktemp("warden-q") / "lane1.jsonl"
    sch = FleetScheduler(block=4)
    lanes = [sch.admit(_tworld(s), **KW) for s in SEEDS]
    warden = FleetWarden(sch, policy="quarantine")
    lanes[1].telemetry.attach(tel)
    jsch = jfleet.FleetScheduler(block=4)
    jlanes = [jsch.admit(_jworld(s), **KW) for s in SEEDS]
    jwarden = jfleet.FleetWarden(jsch, policy="quarantine")
    for i in range(T):
        if i == poison_at:
            poison_world_mm(sch, 1)
            jguard.poison_world_mm(jsch, 1)
        sch.step()
        jsch.step()
    sch.flush()
    jsch.flush()
    lanes[1].telemetry.flush()
    return dict(warden=warden, sch=sch, lanes=lanes, base_fp=base_fp,
                jwarden=jwarden, jlanes=jlanes, rows=_read_rows(tel))


def test_quarantine_isolates_the_poisoned_world(quarantine_run):
    r = quarantine_run
    assert len(r["sch"].lanes) == 2
    for w in (0, 2):
        _assert_identical(_fingerprint(r["lanes"][w]), r["base_fp"][w], f"world {w} ")
        jstate = _state(r["jlanes"][w].world)
        _assert_identical(_state(r["lanes"][w].world), jstate, f"world {w} vs JAX ")


def test_quarantine_statuses_are_typed_and_equal_the_jax_wardens(quarantine_run):
    w = quarantine_run["warden"]
    by_label = {s.label: s for s in w.statuses()}
    assert all(isinstance(s, WardenStatus) for s in by_label.values())
    assert by_label[1].status == "parked" and by_label[1].trips >= 1
    assert "sentinel" in by_label[1].reason
    assert by_label[0].status == by_label[2].status == "active"
    assert w.status_of(1).status == "parked"
    with pytest.raises(KeyError):
        w.status_of(99)
    assert _status_view(w.statuses()) == _status_view(quarantine_run["jwarden"].statuses())
    assert w.status_of(1).reason == quarantine_run["jwarden"].status_of(1).reason


def test_quarantine_parks_a_standalone_lane(quarantine_run):
    r = quarantine_run
    parked = r["warden"].parked()
    assert parked == [r["lanes"][1]]
    lane = parked[0]
    assert lane._fleet_slot is None and lane._fleet is None
    lane.flush()
    assert not torch.isfinite(lane.world.molecule_map).all()  # the poison stays
    lane.step()  # a standalone stepper again
    lane.flush()


def test_warden_telemetry_rows_validate(quarantine_run):
    rows = quarantine_run["rows"]
    assert validate_rows(rows) == []
    sentinel = [r for r in rows if r["type"] == "sentinel"]
    assert sentinel
    for row in sentinel:
        assert row["policy"] == "warden-quarantine"
        assert row["world"] == 1 and "fleet_slot" in row
    events = [r for r in rows if r["type"] == "warden"]
    assert [r["event"] for r in events] == ["quarantine"]
    assert events[0]["world"] == 1


def test_warn_policy_only_counts():
    sch = FleetScheduler(block=4)
    lanes = [sch.admit(_tworld(s), **KW) for s in SEEDS]
    warden = FleetWarden(sch, policy="warn")
    for i in range(6):
        if i == 2:
            # the stepper-level injector reaches a resident lane too
            guard.inject_nan(lanes[1], row=0, mol=0)
        sch.step()
    sch.flush()
    assert len(sch.lanes) == 3
    by_label = {s.label: s for s in warden.statuses()}
    assert by_label[1].status == "active"
    assert by_label[1].trips >= 1 and by_label[1].last_flags != 0
    assert by_label[0].trips == by_label[2].trips == 0
    assert lanes[1].stats["sentinel_trips"] >= 1


# ------------------------------------------------------------------ heal
@pytest.fixture(scope="module")
def heal_run(tmp_path_factory):
    """``heal`` (cadence 2, keep 2), world 1 poisoned before step 5 of
    12; the same warden unpoisoned (cadence flushes are part of the
    schedule); the JAX warden on the poisoned schedule."""
    T, poison_at = 12, 5
    base = FleetScheduler(block=4)
    base_lanes = [base.admit(_tworld(s), **KW) for s in SEEDS]
    FleetWarden(base, policy="heal", checkpoint_dir=tmp_path_factory.mktemp("base"),
                cadence=2, keep=2)
    for _ in range(T):
        base.step()
    base.flush()
    base_fp = [_fingerprint(lane) for lane in base_lanes]

    run_dir = tmp_path_factory.mktemp("heal")
    tel = run_dir / "lane1.jsonl"
    sch = FleetScheduler(block=4)
    lanes = [sch.admit(_tworld(s), **KW) for s in SEEDS]
    warden = FleetWarden(sch, policy="heal", checkpoint_dir=run_dir / "ckpt", cadence=2,
                         keep=2, max_restarts=3, backoff_base=1)
    lanes[1].telemetry.attach(tel)
    jsch = jfleet.FleetScheduler(block=4)
    for s in SEEDS:
        jsch.admit(_jworld(s), **KW)
    jwarden = jfleet.FleetWarden(jsch, policy="heal", checkpoint_dir=run_dir / "jckpt",
                                 cadence=2, keep=2, max_restarts=3, backoff_base=1)
    shape = None
    for i in range(T):
        if i == poison_at:
            groups = [g for sib in sch._groups.values() for g in sib]
            shape = [(g, g.stacked_shape, g.fstate.cm.shape) for g in groups]
            poison_world_mm(sch, 1)
            jguard.poison_world_mm(jsch, 1)
        sch.step()
        jsch.step()
    sch.flush()
    jsch.flush()
    lanes[1].telemetry.flush()
    groups = [g for sib in sch._groups.values() for g in sib]
    return dict(warden=warden, sch=sch, base_fp=base_fp, jwarden=jwarden, jsch=jsch,
                shape_before=shape, groups_after=groups, ckpt_dir=run_dir / "ckpt",
                rows=_read_rows(tel))


def test_heal_restores_and_readmits_into_its_group(heal_run):
    r = heal_run
    w = r["warden"]
    by_label = {s.label: s for s in w.statuses()}
    assert by_label[1].status == "active" and by_label[1].restarts == 1
    assert by_label[1].trips >= 1
    assert len(r["sch"].lanes) == 3
    assert _status_view(w.statuses()) == _status_view(r["jwarden"].statuses())
    lanes = {rec.label: rec.lane for rec in w._records}
    for label in (0, 2):
        _assert_identical(_fingerprint(lanes[label]), r["base_fp"][label], f"world {label} ")
    assert torch.isfinite(lanes[1].world.molecule_map).all()
    # the JAX warden's healed world lands on the same state
    jlanes = {rec.label: rec.lane for rec in r["jwarden"]._records}
    _assert_identical(_state(lanes[1].world), _state(jlanes[1].world), "healed vs JAX ")
    # no new group, no new stack shape: the heal reused the group it left
    assert [(g, g.stacked_shape, g.fstate.cm.shape) for g in r["groups_after"]] == r["shape_before"]
    assert lanes[1]._fleet_slot[0] is r["groups_after"][0]


def test_heal_telemetry_tells_the_story(heal_run):
    rows = heal_run["rows"]
    assert validate_rows(rows) == []
    events = [r for r in rows if r["type"] == "warden"]
    assert [r["event"] for r in events] == ["quarantine", "heal"]
    assert events[1]["restarts"] == 1 and events[1]["checkpoint_step"] is not None


def test_per_world_streams_share_the_directory(heal_run):
    by_world: dict = {}
    for path in sorted(heal_run["ckpt_dir"].glob("*.msck")):
        by_world.setdefault(path.name.rsplit("-", 1)[0], []).append(path.name)
    assert set(by_world) == {"world-000", "world-001", "world-002"}
    assert all(1 <= len(names) <= 2 for names in by_world.values())


def test_circuit_breaker_parks_after_the_budget(tmp_path):
    sch = FleetScheduler(block=4)
    for s in SEEDS:
        sch.admit(_tworld(s), **KW)
    warden = FleetWarden(sch, policy="heal", checkpoint_dir=tmp_path, cadence=2, keep=2,
                         max_restarts=1, backoff_base=1)
    records = {rec.label: rec for rec in warden._records}
    for i in range(13):
        if i in (3, 8):
            poison_world_mm(sch, sch.lanes.index(records[1].lane))
        sch.step()
    sch.flush()
    status = warden.status_of(1)
    assert status.status == "parked" and status.restarts == 1
    assert "circuit breaker" in status.reason
    assert len(sch.lanes) == 2
    assert {s.label: s.status for s in warden.statuses()} == {
        0: "active", 1: "parked", 2: "active"}


def test_streams_walk_back_independently(tmp_path):
    mgrs = [CheckpointManager(tmp_path, keep=2, prefix=f"world-{i:03d}") for i in range(3)]
    for step in (0, 2, 4):
        for i, mgr in enumerate(mgrs):
            mgr.save({"world": i, "step": step}, step=step)
    assert len(list(tmp_path.glob("*.msck"))) == 6
    flip_byte(mgrs[1].checkpoints()[-1][1], offset=-1)
    with pytest.warns(UserWarning, match="falling back"):
        payload, _meta, _path = mgrs[1].load_latest()
    assert payload == {"world": 1, "step": 2}
    for i in (0, 2):
        assert mgrs[i].load_latest()[0] == {"world": i, "step": 4}
    with pytest.raises(CheckpointError):
        CheckpointManager(tmp_path, keep=2, prefix="world-009").load_latest()


def test_suspend_resume_adopt_and_reserved_labels(tmp_path):
    sch = FleetScheduler(block=4)
    lanes = [sch.admit(_tworld(s), **KW) for s in SEEDS[:2]]
    warden = FleetWarden(sch, policy="quarantine", checkpoint_dir=tmp_path)
    for _ in range(2):
        sch.step()
    lane = warden.suspend(lanes[1])
    assert warden.status_of(1).status == "suspended" and lane._fleet is None
    sch.step()
    assert warden.resume(lane) is lane and warden.status_of(1).status == "active"
    for _ in range(2):
        sch.step()
    sch.flush()
    # the suspended world missed one fleet step and nothing else
    ref = FleetScheduler(block=4)
    ref_lane = ref.admit(_tworld(SEEDS[1]), **KW)
    for _ in range(4):
        ref.step()
    ref.flush()
    _assert_identical(_fingerprint(lane), _fingerprint(ref_lane))
    adopted = warden.adopt(_tworld(30), label=7, **KW)
    assert warden.label_of(adopted) == 7
    assert warden.stream_of(7).prefix == "world-007"
    warden.reserve_label(20)
    assert warden.label_of(sch.admit(_tworld(31), **KW)) == 21
    with pytest.raises(KeyError):
        warden.resume(lanes[0])


def test_a_timed_out_shared_fetch_raises_the_typed_error():
    fetch = _SharedFetch(Future(), timeout=0.05, context={"B": 3, "k": 2, "slots": [0, 1, 2]})
    with pytest.raises(WatchdogTimeout) as err:
        fetch.result()
    assert err.value.phase == "fleet-fetch"
    assert not isinstance(err.value, TimeoutError)


def test_warden_config_refusals(tmp_path):
    sch = FleetScheduler(block=4)
    with pytest.raises(GuardConfigError, match="policy"):
        FleetWarden(sch, policy="smite")
    with pytest.raises(GuardConfigError, match="cadence"):
        FleetWarden(sch, policy="warn", cadence=-1)
    with pytest.raises(GuardConfigError, match="checkpoint_dir"):
        FleetWarden(sch, policy="heal")
    with pytest.raises(GuardConfigError, match="cadence"):
        FleetWarden(sch, policy="heal", checkpoint_dir=tmp_path, cadence=0)
    with pytest.raises(GuardConfigError, match="max_save_failures"):
        FleetWarden(sch, policy="warn", max_save_failures=0)
    FleetWarden(sch, policy="warn")
    with pytest.raises(GuardConfigError, match="already"):
        FleetWarden(sch, policy="warn")
