"""
World-axis sharding of the port's fleet (``magicsoup_tpu_torch.fleet.sharding``)
on the CPU, the counterpart of ``tests/fast/test_fleet.py``'s sharded
fleet step: four worlds of one group over a two-rank gloo process group
(``RankPool``, bounded by timeouts), each rank stepping its block of two
worlds with ``sharded_fleet_step``, every leaf of the state, the
parameters and the records bit-equal to the unsharded
``fleet_step_program`` over the whole stack, in deterministic and fast
mode (nothing reduces across worlds), also with the integrator left to
its default.  A mesh-placed world is refused by ``FleetScheduler.admit``.
"""
from pathlib import Path

import pytest

from magicsoup_tpu_torch.parallel.launch import RankPool

TESTS = str(Path(__file__).resolve().parent)


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, device="cpu", env={"PYTHONPATH": TESTS}, timeout=60.0) as p:
        yield p


@pytest.mark.parametrize("det", [True, False])
def test_sharded_fleet_step_matches_unsharded(pool, det):
    got = pool.run(
        "torch_mesh_runs:fleet_sharding",
        seeds=[7, 11, 13, 17],
        steps=3,
        map_size=16,
        n_cells=30,
        det=det,
    )
    assert [r["worlds"] for r in got] == [[0, 2], [2, 4]]
    for rank in got:
        assert rank["equal"], rank
        assert rank["leaves"] == 16 and rank["alive"] > 0


def test_sharded_fleet_step_default_integrator_is_the_worlds(pool):
    """Without ``integrator`` the sharded step resolves the numeric mode's
    backend on the mesh's device, as a fleet world does: in deterministic
    mode ``torch-det``, so the run stays bit-equal to the unsharded one."""
    got = pool.run(
        "torch_mesh_runs:fleet_sharding",
        seeds=[7, 11, 13, 17],
        steps=2,
        map_size=16,
        n_cells=30,
        det=True,
        default_integrator=True,
    )
    for rank in got:
        assert rank["equal"], rank


def test_fleet_refuses_a_mesh_world(pool):
    for msg in pool.run("torch_mesh_jobs:fleet_refuses_mesh_world"):
        assert "fleet worlds must be single-device" in msg
        assert "magicsoup_tpu_torch.fleet.sharding" in msg
