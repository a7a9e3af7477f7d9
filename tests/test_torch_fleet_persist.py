"""
The port's fleet checkpoints (``magicsoup_tpu_torch.fleet.persist``) in
deterministic mode, as ``tests/fast/test_fleet_guard.py`` holds the JAX
package's:

- one world extracted from a fleet checkpoint restores bit-identically to
  the lane it was cut from, to a solo checkpoint of that lane and to the
  JAX package's extraction of the same world, and steps on identically;
- a whole-fleet checkpoint round-trips through a ``CheckpointManager``,
  the restored fleet's future bit-identical to the original's;
- a fleet file refuses to load as a run file and a run file as a fleet
  file, typed, and an index out of range is refused, typed;
- ``restore_world`` readmits into a live scheduler's group and continues
  as the same world restored solo;
- the restore audit rejects a world corrupted before the save and passes
  its neighbours.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu import fleet as jfleet  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu_torch import check, guard  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.fleet import (  # noqa: E402
    FLEET_FORMAT,
    FleetScheduler,
    restore_fleet,
    restore_world,
    save_fleet,
    snapshot_fleet,
)

#: the full selection workload at K = 2
KW = dict(
    mol_name="ATP",
    kill_below=1.0,
    divide_above=3.0,
    divide_cost=1.0,
    target_cells=30,
    genome_size=300,
    lag=1,
    max_divisions=64,
    spawn_block=16,
    push_block=16,
    p_mutation=1e-3,
    p_recombination=1e-4,
    megastep=2,
)
#: chemistry only: the audit at restore sees the census the injector saw
CHEM_KW = dict(
    KW,
    kill_below=-1.0,
    divide_above=1e30,
    divide_cost=0.0,
    target_cells=None,
    p_mutation=0.0,
    p_recombination=0.0,
)
SEEDS = (7, 11, 17)


@pytest.fixture(autouse=True)
def det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")


def _world(lib, chem, seed: int, **kw):
    w = lib.World(chemistry=chem, map_size=16, seed=seed, **kw)
    rng = random.Random(seed)
    w.spawn_cells([lib.random_genome(s=300, rng=rng) for _ in range(24)])
    return w


def _tworld(seed: int):
    return _world(mt, TCHEM, seed, device="cpu")


def _state(world) -> dict:
    mm = world.molecule_map
    n = world.n_cells
    return {
        "n": n,
        "genomes": list(world.cell_genomes),
        "mm": np.asarray(mm.cpu() if torch.is_tensor(mm) else mm),
        "cm": np.asarray(world.cell_molecules)[:n],
        "positions": np.asarray(world.cell_positions),
        "lifetimes": np.asarray(world.cell_lifetimes),
        "divisions": np.asarray(world.cell_divisions),
    }


def _fingerprint(world, st) -> dict:
    snap = guard.snapshot_run(world, st)
    aux = snap["stepper"]
    return {
        **_state(world),
        "world_rng": snap["world_rng_state"],
        "world_nprng": repr(snap["world_nprng_state"]),
        "key": np.asarray(aux["key"]),
        "stepper_rng": repr(aux["rng_state"]),
    }


def _assert_identical(a: dict, b: dict, label: str = "") -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].tobytes() == b[k].tobytes(), f"{label}{k} differs"
        else:
            assert a[k] == b[k], f"{label}{k} differs"


def _stepped(kw=KW, n: int = 2):
    fleet = FleetScheduler(block=4)
    lanes = [fleet.admit(_tworld(s), **kw) for s in SEEDS]
    for _ in range(n):
        fleet.step()
    return fleet, lanes


def test_one_world_extracts_bit_identically(tmp_path):
    fleet, lanes = _stepped()
    path = save_fleet(tmp_path / "fleet.msck", fleet, meta={"tag": "x"})
    # the JAX fleet on the same worlds and schedule, extracted the same way
    jf = jfleet.FleetScheduler(block=4)
    for s in SEEDS:
        jf.admit(_world(ms, JCHEM, s), **KW)
    for _ in range(2):
        jf.step()
    jpath = jfleet.save_fleet(tmp_path / "jfleet.msck", jf)
    for i, lane in enumerate(lanes):
        world, aux, meta = restore_world(path, i, device="cpu")
        assert meta["format"] == FLEET_FORMAT and meta["worlds"] == 3 and meta["tag"] == "x"
        st = mt.PipelinedStepper(world, **KW)
        guard.restore_stepper(st, aux)
        _assert_identical(_fingerprint(lane.world, lane), _fingerprint(world, st), f"world {i} ")
        jworld, _jaux, _ = jfleet.restore_world(jpath, i)
        _assert_identical(_state(world), _state(jworld), f"world {i} vs JAX ")
    # a lane's entry IS a solo snapshot: its solo checkpoint restores alike
    solo_path = tmp_path / "solo.msck"
    guard.write_checkpoint(solo_path, guard.snapshot_run(lanes[1].world, lanes[1]))
    world, aux, _ = guard.restore_run(solo_path, device="cpu")
    st = mt.PipelinedStepper(world, **KW)
    guard.restore_stepper(st, aux)
    _assert_identical(_fingerprint(lanes[1].world, lanes[1]), _fingerprint(world, st))
    # a negative index counts from the end, and the cut world steps on
    # as the lane it came from
    world, aux, _ = restore_world(path, -1, device="cpu")
    st = mt.PipelinedStepper(world, **KW)
    guard.restore_stepper(st, aux)
    st.step()
    st.flush()
    fleet.step()
    fleet.flush()
    _assert_identical(_fingerprint(lanes[-1].world, lanes[-1]), _fingerprint(world, st))


def test_fleet_checkpoint_round_trips_through_a_manager(tmp_path):
    fleet, lanes = _stepped()
    mgr = guard.CheckpointManager(tmp_path / "ck", keep=2)
    save_fleet(mgr, fleet, step=2)
    fleet2 = FleetScheduler(block=4)
    lanes2, meta = restore_fleet(mgr, fleet2, KW, device="cpu")
    assert meta["step"] == 2 and meta["worlds"] == len(lanes2) == 3
    for i, (a, b) in enumerate(zip(lanes, lanes2)):
        _assert_identical(_fingerprint(a.world, a), _fingerprint(b.world, b), f"world {i} ")
    for _ in range(2):
        fleet.step()
        fleet2.step()
    for i, (a, b) in enumerate(zip(lanes, lanes2)):
        _assert_identical(_fingerprint(a.world, a), _fingerprint(b.world, b), f"future {i} ")
    assert snapshot_fleet(fleet2)["format"] == FLEET_FORMAT


def test_a_wrong_format_is_refused_both_ways(tmp_path):
    fleet, lanes = _stepped(n=1)
    fleet_path = save_fleet(tmp_path / "fleet.msck", fleet)
    solo_path = tmp_path / "solo.msck"
    guard.write_checkpoint(solo_path, guard.snapshot_run(lanes[0].world, lanes[0]))
    with pytest.raises(guard.CheckpointError) as err:
        guard.restore_run(fleet_path, device="cpu")
    assert err.value.check == "format"
    with pytest.raises(guard.CheckpointError) as err:
        restore_world(solo_path, 0, device="cpu")
    assert err.value.check == "format"
    for index in (3, -4):
        with pytest.raises(guard.CheckpointError) as err:
            restore_world(fleet_path, index, device="cpu")
        assert err.value.check == "index"
    # no device means the card, and without one that says device="cpu"
    torch_cuda = torch.cuda.is_available
    try:
        torch.cuda.is_available = lambda: False
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore_world(fleet_path, 0)
    finally:
        torch.cuda.is_available = torch_cuda


def test_restore_world_readmits_into_a_live_scheduler(tmp_path):
    fleet, _ = _stepped(CHEM_KW)
    path = save_fleet(tmp_path / "fleet.msck", fleet)
    fleet.step()
    fleet.drain()
    world_a, aux_a, _ = restore_world(path, 1, device="cpu")
    solo = mt.PipelinedStepper(world_a, **CHEM_KW)
    guard.restore_stepper(solo, aux_a)
    for _ in range(2):
        solo.step()
    solo.flush()
    groups = [g for sib in fleet._groups.values() for g in sib]
    world_b, aux_b, _ = restore_world(path, 1, device="cpu")
    lane = fleet.admit(world_b, **CHEM_KW)
    guard.restore_stepper(lane, aux_b)
    for _ in range(2):
        fleet.step()
    fleet.drain()
    # it joined the live group: no new group, no new stack shape
    group, _slot = lane._fleet_slot
    assert [g for sib in fleet._groups.values() for g in sib] == groups
    assert len(group.members()) == 4 and group.stacked_shape == (4, group.maxp, group.maxd)
    lane.flush()
    _assert_identical(_fingerprint(solo.world, solo), _fingerprint(lane.world, lane))


def test_the_restore_audit_rejects_seeded_corruption(tmp_path):
    fleet, lanes = _stepped(CHEM_KW)
    assert lanes[1]._fleet_resident
    row = guard.corrupt_world_params(fleet, 1)
    path = save_fleet(tmp_path / "fleet.msck", fleet)
    restore_world(path, 1, device="cpu", audit=False)  # the bytes are intact
    with pytest.raises(check.AuditFailed) as err:
        restore_world(path, 1, device="cpu", audit=True)
    hits = [v for v in err.value.violations if v.code == "params_genome_mismatch"]
    assert hits and row in hits[0].rows
    restore_world(path, 0, device="cpu", audit=True)
    restore_world(path, 2, device="cpu", audit=True)
    with pytest.raises(check.AuditFailed):
        restore_fleet(path, FleetScheduler(block=4), CHEM_KW, device="cpu", audit=True)
