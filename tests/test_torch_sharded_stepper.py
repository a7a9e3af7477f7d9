"""
The port's pipelined stepper over a mesh-placed world, on the CPU, over a
two-rank gloo process group of child processes started once for the
module (``RankPool``, bounded by timeouts), held against the stepper on
one device and the JAX package's sharded stepper on its two-device mesh
(``tests/fast/test_sharded_stepper.py``'s world and stepper, run in a
process of its own, ``tests/jax_mesh_reference.py``):

- deterministic trajectories at K 1 and 2 bit-identical to the
  single-device ones and to JAX's sharded stepper's ``state_digest``;
- the per-tile occupancy lanes (summing to ``occupied``) and the
  dispatch rows' ``tiles`` / ``mesh_axis``;
- the record layout: single-device unchanged, the mesh appending one
  word per tile;
- ``restore_run(mesh=)``: a det checkpoint of one device resumed on the
  mesh, and one of the mesh resumed on one device, bit-identical to the
  uninterrupted run.
"""
from pathlib import Path

import pytest

from magicsoup_tpu_torch import stepper as tstepper
from magicsoup_tpu_torch.parallel.launch import RankPool
from magicsoup_tpu_torch.telemetry import summary

import torch_mesh_jobs as jobs
from jax_mesh_reference import jax_reference

TESTS = str(Path(__file__).resolve().parent)
J = "torch_mesh_jobs:"


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, device="cpu", env={"PYTHONPATH": TESTS}, timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded stepper on two tiles at K 1 and 2 (a
    process of its own: ``tests/jax_mesh_reference.py``)."""
    kw = jobs.SHARDED_STEPPER_KW
    k1, k2 = jax_reference(
        [["sharded_stepper", {"megastep": 1, "stepper_kw": kw}],
         ["sharded_stepper", {"megastep": 2, "stepper_kw": kw}]]
    )
    return {1: k1, 2: k2}


@pytest.mark.parametrize("megastep", [1, 2])
def test_det_trajectory_bit_identical_to_single_device_and_jax(pool, jax_sharded, megastep):
    got = pool.run(J + "sharded_stepper", megastep=megastep, steps=8 // megastep)
    one = jobs.sharded_stepper(None, megastep=megastep, steps=8 // megastep)
    assert got[0]["digest"] == got[1]["digest"] == one["digest"]
    assert got[0]["stats"] == one["stats"]
    assert got[0]["n_cells"] == one["n_cells"] > 0
    assert got[0]["digest"] == jax_sharded[megastep]


def test_mesh_telemetry_tile_occupancy(pool, tmp_path):
    path = tmp_path / "telemetry.jsonl"
    pool.run(J + "sharded_stepper", megastep=1, steps=5, jsonl=str(path))
    rows = summary.read_jsonl(path)
    assert summary.validate_rows(rows) == []
    srows = [r for r in rows if r.get("type") == "step"]
    assert srows
    for r in srows:
        assert len(r["tile_occupancy"]) == 2
        assert sum(r["tile_occupancy"]) == r["occupied"]
    drows = [r for r in rows if r.get("type") == "dispatch"]
    assert drows and all(r["tiles"] == 2 and r["mesh_axis"] == "tile" for r in drows)
    out = summary.summarize_rows(rows)
    assert out["tiles"] == 2
    assert len(out["final"]["tile_occupancy"]) == 2
    # the same run on one device writes neither key
    one = tmp_path / "one.jsonl"
    jobs.sharded_stepper(None, megastep=1, steps=2, jsonl=str(one))
    rows = summary.read_jsonl(one)
    assert not any("tile_occupancy" in r or "tiles" in r for r in rows)


def test_record_layout_single_device_unchanged_mesh_appends_tail(pool):
    one = jobs.sharded_stepper(None, megastep=1, steps=1)
    md, sb, cap = 2048, 1024, one["cap"]
    nw_k, nw_s = -(-cap // 16), -(-sb // 16)
    assert one["record"] == 11 + nw_k + md + 2 * md + nw_s + 2 * sb + nw_k
    assert one["record"] == tstepper.record_length(cap, md, sb)
    assert one["n_tiles"] == 1
    got = pool.run(J + "sharded_stepper", megastep=1, steps=1)[0]
    assert got["cap"] == cap
    assert got["record"] == one["record"] + 2 == tstepper.record_length(cap, md, sb, 2)


def test_restore_run_onto_a_mesh_and_back(pool, tmp_path):
    want = jobs.uninterrupted(None, steps=6, flush_at=3)
    one_ck = str(tmp_path / "one")
    jobs.save_for_resume(None, ckdir=one_ck, steps=3)
    got = pool.run(J + "resume", ckdir=one_ck, steps=3)
    assert got[0]["digest"] == got[1]["digest"] == want
    assert got[0]["tiles"] == 2 and got[0]["mm_block"][1] == 16
    mesh_ck = tmp_path / "mesh"
    pool.run(J + "save_for_resume", ckdir=str(mesh_ck), steps=3)
    assert len(list(mesh_ck.glob("*.msck"))) == 1  # rank 0 alone writes
    back = jobs.resume(None, ckdir=str(mesh_ck), steps=3)
    assert back["digest"] == want and back["tiles"] == 1
