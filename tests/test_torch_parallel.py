"""
The port's device meshes (``magicsoup_tpu_torch.parallel``) on the CPU,
over a two-rank gloo process group of child processes started once for
the module (``RankPool``; every collective and the pool's calls are
bounded by timeouts), held against the JAX package's two-device mesh in
this process and against the port on one device:

- ``halo_diffuse``: deterministic mode bit-equal to JAX's two-tile
  ``halo_diffuse`` and to the single-device ``diffuse``; fast mode within
  rtol 1e-5 of both (per-tile totals and an all-reduce reorder the mass
  fixup's sum); one tile is ``diffuse``;
- ``make_sharded_step``: bit-equal to the World's own steps in
  deterministic mode, within atol 1e-5 in fast mode, and finite and
  conserving (within the JAX test's sanity bound) without decay;
- a mesh ``World`` through the full classic lifecycle: bit-identical to
  the single-device port world and to JAX's mesh world in deterministic
  mode; finite in fast mode;
- the divisibility and device/mesh errors, ``load_state`` keeping the
  placement, a pickle dropping the mesh, a custom axis name, capacity rounding over three ranks, a
  JAX world's state carried into a mesh world, and the pinned collective
  count of a mesh step.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
import random  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
from magicsoup_tpu.check import differential as jdiff  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu_torch.ops import diffusion as tdiff  # noqa: E402
from magicsoup_tpu_torch.parallel.launch import RankPool  # noqa: E402

import torch_mesh_jobs as jobs  # noqa: E402
from jax_mesh_reference import jax_reference  # noqa: E402

TESTS = str(Path(__file__).resolve().parent)
J = "torch_mesh_jobs:"


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, device="cpu", env={"PYTHONPATH": TESTS}, timeout=60.0) as p:
        yield p


def _map_and_kernels():
    rng = np.random.default_rng(0)
    mm = (rng.random((3, 24, 24)) * 10).astype(np.float32)
    return mm, tdiff.diffusion_kernels([0.1, 1.0, 0.3])


@pytest.fixture(scope="module")
def jax_mesh():
    """The JAX package's two-tile runs (a process of their own:
    ``tests/jax_mesh_reference.py``)."""
    det, fast, life = jax_reference(
        [["halo", {"det": True}], ["halo", {"det": False}], ["lifecycle", {"det": True}]]
    )
    return {
        "halo_det": np.asarray(det, dtype=np.float32),
        "halo_fast": np.asarray(fast, dtype=np.float32),
        "lifecycle_det": life,
    }


def test_halo_diffuse_det_bit_equal_to_jax_and_one_device(pool, jax_mesh):
    mm, kernels = _map_and_kernels()
    got = pool.run("torch_mesh_runs:halo_diffusion", mm, kernels, True)
    one = tdiff.diffuse(torch.from_numpy(mm), torch.from_numpy(kernels), det=True).numpy()
    want = jax_mesh["halo_det"]
    for rank in got:
        assert rank.tobytes() == want.tobytes()
        assert rank.tobytes() == one.tobytes()


def test_halo_diffuse_fast_within_tolerance(pool, jax_mesh):
    # stated tolerance: rtol 1e-5 (the mass fixup sums per tile, then
    # across tiles, where one device sums the map in one tree)
    mm, kernels = _map_and_kernels()
    got = pool.run("torch_mesh_runs:halo_diffusion", mm, kernels, False)
    one = tdiff.diffuse(torch.from_numpy(mm), torch.from_numpy(kernels)).numpy()
    want = jax_mesh["halo_fast"]
    assert got[0].tobytes() == got[1].tobytes()
    np.testing.assert_allclose(got[0], one, rtol=1e-5)
    np.testing.assert_allclose(got[0], want, rtol=1e-5)


@pytest.mark.parametrize("det", [True, False])
def test_halo_diffuse_one_tile_is_diffuse(pool, det):
    mm, kernels = _map_and_kernels()
    assert pool.run(J + "one_tile_halo", mm, kernels, det) == [True, None]


def test_sharded_step_matches_unsharded(pool):
    # deterministic: bit-equal; fast: atol 1e-5 (the JAX test's bound)
    ref = jobs.sharded_step(None, det=True, steps=2)
    for rank in pool.run(J + "sharded_step", det=True, steps=2):
        assert rank[0].tobytes() == ref[0].tobytes()
        assert rank[1].tobytes() == ref[1].tobytes()
    ref = jobs.sharded_step(None, det=False, steps=2)
    got = pool.run(J + "sharded_step", det=False, steps=2)[0]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-5)


def test_sharded_step_conserves_molecules(pool):
    got = pool.run(J + "sharded_step", det=False, steps=3, degrade=False)[0]
    mm, cm = got
    before = jobs.sharded_step(None, det=False, steps=0, degrade=False)
    assert np.isfinite(mm).all() and (mm >= 0).all()
    assert np.isfinite(cm).all()
    total = mm.sum() + cm.sum()
    assert total == pytest.approx(before[0].sum() + before[1].sum(), rel=0.5)


def test_mesh_world_full_lifecycle_det_bit_identical(pool, jax_mesh):
    got = pool.run(J + "api_lifecycle", det=True)
    one = jobs.api_lifecycle(None, det=True)
    assert got[0] == got[1]
    assert got[0]["digest"] == one["digest"]
    assert got[0]["digest"] == jax_mesh["lifecycle_det"]
    # the state stayed on its blocks: 32 of 64 map rows, half the slots
    assert got[0]["mm_block"][1] == 32
    assert got[0]["cm_block"][0] * 2 == got[0]["vmax_block"][0] * 2 == one["cm_block"][0]


def test_mesh_world_full_lifecycle_fast_smoke(pool):
    got = pool.run(J + "api_lifecycle", det=False, steps=3)
    assert got[0]["finite"] and got[0]["n_cells"] > 0
    assert got[0]["digest"] == got[1]["digest"]


def test_mesh_world_validates_map_divisibility(pool):
    for msg in pool.run(J + "divisibility_error"):
        assert "must be divisible by the first mesh axis size 2" in msg
    for msg in pool.run(J + "device_and_mesh_error"):
        assert "mutually exclusive" in msg


def test_mesh_entry_points_default_to_the_card(pool, monkeypatch):
    """``device=None`` is the card on every mesh entry point, as across the
    port: with no card each raises naming ``device='cpu'``, and none
    runs on the CPU unasked."""
    for rank in pool.run(J + "default_device_errors"):
        assert len(rank) == 4
        for msg in rank:
            assert "device='cpu'" in msg, rank
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="RankPool.*device='cpu'"):
        RankPool(2, env={"PYTHONPATH": TESTS})


def test_mesh_world_load_state_keeps_placement(pool, tmp_path):
    for rank in pool.run(J + "load_state_keeps_placement", str(tmp_path)):
        assert rank["n_cells"] == 16 and rank["same"]
        assert rank["mm_block"][1] == 32
        assert rank["cm_block"][0] == rank["vmax_block"][0] == 32


def test_mesh_world_pickle_drops_the_mesh(pool):
    for rank in pool.run(J + "pickle_drops_mesh"):
        assert rank["mesh_free"] and rank["same"]
        assert rank["mm"][1] == 16 and rank["vmax"][0] == 64


def test_custom_axis_name_mesh_works(pool, tmp_path):
    from magicsoup_tpu_torch.telemetry import summary

    path = tmp_path / "run.jsonl"
    got = pool.run(J + "custom_axis", str(path))
    assert all(r == {"axis": ("rows",), "finite": True} for r in got)
    rows = summary.read_jsonl(path)
    assert summary.validate_rows(rows) == []
    drows = [r for r in rows if r.get("type") == "dispatch"]
    assert drows and all(r["tiles"] == 2 and r["mesh_axis"] == "rows" for r in drows)


def test_capacity_rounds_to_a_tile_multiple_over_three_ranks():
    with RankPool(3, device="cpu", env={"PYTHONPATH": TESTS}, timeout=60.0) as three:
        got = three.run(J + "three_tile_capacity")
    assert got[0] == got[1] == got[2]
    assert got[0]["capacity"] % 3 == 0 and got[0]["n_cells"] > 0
    assert got[0]["cm_block"][0] * 3 == got[0]["capacity"]
    assert got[0]["mm_block"][1] == 11


def test_a_jax_worlds_state_loads_into_a_mesh_world(pool):
    jw = ms.World(chemistry=JCHEM, map_size=32, seed=5)
    rng = random.Random(5)
    jw.spawn_cells([ms.random_genome(s=500, rng=rng) for _ in range(40)])
    arrays = dict(
        molecule_map=np.asarray(jw.molecule_map),
        cell_molecules=np.asarray(jw.cell_molecules),
        cell_positions=jw.cell_positions,
        cell_lifetimes=jw.cell_lifetimes,
        cell_divisions=jw.cell_divisions,
        cell_genomes=list(jw.cell_genomes),
        cell_labels=list(jw.cell_labels),
        params={k: np.asarray(v) for k, v in jw.kinetics.params._asdict().items()},
    )
    got = pool.run(J + "load_arrays", arrays)
    one = jobs.load_arrays(None, arrays)
    assert got[0]["loaded"] == jdiff.state_digest(jw)
    assert got[0] == got[1]
    assert got[0]["stepped"] == one["stepped"]
    assert got[0]["vmax_block"][0] * 2 == one["vmax_block"][0]


def test_pinned_collective_count(pool):
    """The port's counterpart of the JAX collective census: a mesh step's
    collectives are counted (``analysis.runtime.collective_stats``) and
    pinned.  A classic step (fast mode, torch-fast): the map gather, the
    delta gather and one stop all-reduce per correction increment of the
    activity, the halo edges, the two fixup all-reduces, the map gather
    and the delta gather of the permeation (19).  A stepper step: the
    state gathers at its entry, the stop all-reduces, the integrator
    output's gather, the nine gathers of the division parents' parameter
    rows (a budget of rows, not the capacity) and the residue lane's
    gather; it diffuses the gathered map with no collective (34).  No
    step without a compaction gathers whole parameter tensors."""
    got = pool.run(J + "collective_census", steps=3)
    assert got[0]["classic"]["collectives"] == got[1]["classic"]["collectives"]
    census = got[0]
    assert census["classic"]["collectives"] == 19, census
    per_step = census["stepper"]["collectives"] / 3
    assert per_step == 34, census
    # bytes per collective stay within a gathered map (no parameter rows)
    assert census["stepper"]["collective_bytes"] / census["stepper"]["collectives"] < census["map_bytes"]
    assert json.dumps(census)
