"""
The port's deep audit (``magicsoup_tpu_torch.check``) against the JAX
package's: a world the public API built audits clean, and each injected
fault of ``tests/fast/test_check.py`` (a cell-map desync, dead-row
residue, a params/genome mismatch) is reported with the JAX audit's code
on the same state; the token store's lanes catch PAD and dead-row residue.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu import check as jcheck  # noqa: E402
from magicsoup_tpu.guard import faults as jfaults  # noqa: E402
from magicsoup_tpu_torch import check  # noqa: E402


def _chem(pkg):
    mols = [pkg.Molecule("taudit-a", 10e3), pkg.Molecule("taudit-atp", 8e3, half_life=100_000)]
    return pkg.Chemistry(molecules=mols, reactions=[([mols[0]], [mols[1]])])


def _world(pkg=mt, *, seed=7, n_cells=12, genome_backend="string"):
    kw = {"device": "cpu"} if pkg is mt else {}
    world = pkg.World(
        chemistry=_chem(pkg), map_size=16, seed=seed, genome_backend=genome_backend, **kw
    )
    world.deterministic = True
    rng = random.Random(seed)
    world.spawn_cells([pkg.random_genome(s=200, rng=rng) for _ in range(n_cells)])
    return world


# the JAX package's fault injectors (guard/faults.py), on a port world
def _desync_cell_map(world):
    r, c = (int(x) for x in np.argwhere(world._np_cell_map)[0])
    world._np_cell_map[r, c] = False
    return r, c


def _inject_dead_residue(world, mol=0, value=1.0):
    row = int(world.n_cells)
    cm = world._cell_molecules.clone()
    cm[row, mol] = value
    world._cell_molecules = cm
    world._cm_cache = None
    return row


def _corrupt_params_row(world):
    from magicsoup_tpu_torch.check.audit import _sample_rows

    counts, _, _ = world.genetics.translate_genomes_flat(list(world.cell_genomes))
    row = next(i for i in _sample_rows(world.n_cells, 8) if int(counts[i]) > 0)
    world.kinetics.params.Vmax[row, 0] += 7.0
    return row


@pytest.mark.parametrize("genome_backend", ["string", "token"])
def test_audit_clean_world_full_coverage(genome_backend):
    world = _world(genome_backend=genome_backend)
    assert check.audit_world(world, sample=world.n_cells) == []
    for _ in range(3):
        world.enzymatic_activity()
        world.degrade_and_diffuse_molecules()
    world.kill_cells([0, 3])
    world.divide_cells([1, 2])
    world.mutate_cells(p=1e-2)
    assert check.audit_world(world, sample=world.n_cells) == []


def test_audit_detects_cell_map_desync():
    world, jworld = _world(), _world(ms)
    r, c = _desync_cell_map(world)
    assert (r, c) == jfaults.desync_cell_map(jworld)
    codes = {v.code for v in check.audit_world(world)}
    assert "cell_map_desync" in codes
    assert codes == {v.code for v in jcheck.audit_world(jworld)}
    world._np_cell_map[r, c] = True
    assert check.audit_world(world) == []


def test_audit_detects_dead_cm_residue():
    world, jworld = _world(), _world(ms)
    row = _inject_dead_residue(world)
    assert row == jfaults.inject_dead_residue(jworld)
    hits = [v for v in check.audit_world(world) if v.code == "dead_cm_residue"]
    jhits = [v for v in jcheck.audit_world(jworld) if v.code == "dead_cm_residue"]
    assert hits and row in hits[0].rows
    assert hits[0].rows == jhits[0].rows


def test_audit_detects_params_genome_mismatch():
    world, jworld = _world(), _world(ms)
    row = _corrupt_params_row(world)
    assert row == jfaults.corrupt_params_row(jworld)
    hits = [
        v
        for v in check.audit_world(world, sample=world.n_cells)
        if v.code == "params_genome_mismatch"
    ]
    assert hits and row in hits[0].rows
    assert "Vmax" in hits[0].details.get("tensors", ())
    jhits = [
        v
        for v in jcheck.audit_world(jworld, sample=jworld.n_cells)
        if v.code == "params_genome_mismatch"
    ]
    assert [v.rows for v in hits] == [v.rows for v in jhits]


def test_assert_consistent_raises_audit_failed():
    world = _world()
    _inject_dead_residue(world)
    with pytest.raises(check.AuditFailed) as err:
        check.assert_consistent(world)
    assert any(v.code == "dead_cm_residue" for v in err.value.violations)
    assert "dead_cm_residue" in str(err.value)
    check.assert_consistent(_world())


def test_audit_token_store_lanes():
    from magicsoup_tpu_torch.genomes import PAD

    world = _world(genome_backend="token")
    store = world.genome_store
    n = world.n_cells
    tokens = store.tokens.clone()
    length = int(store.lengths[0])
    tokens[0, length] = 1  # a base past the genome's end
    lengths = store.lengths.clone()
    lengths[n] = 5  # a dead row with a length
    store.apply(tokens, lengths)
    codes = {v.code for v in check.audit_world(world)}
    assert {"token_pad_residue", "token_dead_residue"} <= codes
    tokens[0, length] = PAD
    lengths[n] = 0
    store.apply(tokens, lengths)
    assert check.audit_world(world) == []


def test_empty_world_audits_clean():
    world = mt.World(chemistry=_chem(mt), map_size=16, seed=3, device="cpu")
    assert check.audit_world(world) == []
