"""
The rest of the classic World's public API and of its Kinetics, held to
the JAX package's on the CPU in deterministic mode: worlds from one seed
that call the same methods hold the same positions, genomes, labels,
counters, molecules, parameters and RNG states, bit for bit.

- ``add_cell_molecules`` with repeated indexes accumulates (ROADMAP C1);
- ``get_cell``, ``add_cells`` (with the shuffle of an overfull add),
  ``move_cells`` and ``reposition_cells``, string and token genomes, and
  the cases of ``tests/fast/test_world.py`` for them;
- ``Kinetics.set_cell_params``, ``remove_cell_params``,
  ``increase_max_cells``, ``increase_max_proteins`` and
  ``integrate_signals`` (bit-equal in deterministic mode, under the fast
  contract in fast mode).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import random  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu_torch.check import assert_consistent  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402

BACKENDS = ["string", "token"]


@pytest.fixture
def det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")


def _genomes(n, s=400, seed=0):
    rng = random.Random(seed)
    return [mt.random_genome(s=s, rng=rng) for _ in range(n)]


def _pair(seed=3, map_size=16, n=20, genome_backend="string", steps=2):
    """A JAX and a port world from one seed that did the same things."""
    jw = ms.World(chemistry=JCHEM, map_size=map_size, seed=seed, genome_backend=genome_backend)
    tw = mt.World(
        chemistry=TCHEM, map_size=map_size, seed=seed, device="cpu", genome_backend=genome_backend
    )
    if n:
        for w in (jw, tw):
            w.spawn_cells(_genomes(n, seed=seed))
            for _ in range(steps):
                w.enzymatic_activity()
                w.degrade_and_diffuse_molecules()
                w.increment_cell_lifetimes()
    return jw, tw


def _assert_equal(jw, tw):
    assert jw.n_cells == tw.n_cells
    np.testing.assert_array_equal(jw.cell_positions, tw.cell_positions)
    np.testing.assert_array_equal(jw.cell_map, tw.cell_map)
    np.testing.assert_array_equal(jw.cell_lifetimes, tw.cell_lifetimes)
    np.testing.assert_array_equal(jw.cell_divisions, tw.cell_divisions)
    assert jw.cell_genomes == tw.cell_genomes
    assert jw.cell_labels == tw.cell_labels
    assert np.asarray(jw.cell_molecules).tobytes() == tw.cell_molecules.tobytes()
    assert np.asarray(jw.molecule_map).tobytes() == tw.molecule_map.numpy().tobytes()
    for a, b in zip(jw.kinetics.params, tw.kinetics.params):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert np.array_equal(np.asarray(jw._positions_dev), tw._positions_dev.numpy())
    assert jw._rng.getstate() == tw._rng.getstate()
    assert jw._nprng.bit_generator.state == tw._nprng.bit_generator.state


def test_add_cell_molecules_accumulates_repeated_indexes(det):
    jw, tw = _pair()
    before = tw.cell_molecules.copy()
    for w in (jw, tw):
        w.add_cell_molecules([2, 2, 2], 1, 1.0)
        w.add_cell_molecules([0, 5, 5, 7], 3, 0.25)
        w.add_cell_molecules([], 0, 1.0)
    _assert_equal(jw, tw)
    after = tw.cell_molecules
    assert after[2, 1] - before[2, 1] == pytest.approx(3.0, rel=1e-6)
    assert after[5, 3] - before[5, 3] == pytest.approx(0.5, rel=1e-6)
    assert after[7, 3] - before[7, 3] == pytest.approx(0.25, rel=1e-6)


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_get_cell_matches_jax(det, genome_backend):
    jw, tw = _pair(genome_backend=genome_backend)
    for idx in range(tw.n_cells):
        jc, tc = jw.get_cell(by_idx=idx), tw.get_cell(by_idx=idx)
        assert (tc.idx, tc.genome, tc.position, tc.label) == (jc.idx, jc.genome, jc.position, jc.label)
        assert (tc.n_steps_alive, tc.n_divisions) == (jc.n_steps_alive, jc.n_divisions)
        assert np.asarray(tc.int_molecules).tobytes() == np.asarray(jc.int_molecules).tobytes()
        assert np.asarray(tc.ext_molecules).tobytes() == np.asarray(jc.ext_molecules).tobytes()
        assert [str(p) for p in tc.proteome] == [str(p) for p in jc.proteome]
        assert tw.get_cell(by_position=tc.position).idx == idx
    free = np.argwhere(~tw.cell_map)[0]
    with pytest.raises(ValueError):
        tw.get_cell(by_position=(int(free[0]), int(free[1])))


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_add_cells_matches_jax(det, genome_backend):
    jsrc, tsrc = _pair(seed=4, genome_backend=genome_backend)
    jcells = [jsrc.get_cell(by_idx=i) for i in range(5)]
    tcells = [tsrc.get_cell(by_idx=i) for i in range(5)]
    jw, tw = _pair(seed=77, n=8, genome_backend=genome_backend)
    assert tw.add_cells(tcells) == jw.add_cells(jcells) == list(range(8, 13))
    _assert_equal(jw, tw)
    assert tw.cell_genomes[8:] == [c.genome for c in tcells]
    assert tw.cell_labels[8:] == [c.label for c in tcells]
    np.testing.assert_array_equal(tw.cell_lifetimes[8:], [c.n_steps_alive for c in tcells])
    np.testing.assert_array_equal(
        tw.cell_molecules[8:], np.stack([c.int_molecules for c in tcells])
    )
    assert_consistent(tw, sample=tw.n_cells)
    for w in (jw, tw):
        w.enzymatic_activity()
    _assert_equal(jw, tw)
    assert tw.add_cells([]) == []


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_add_cells_to_a_nearly_full_map_shuffles_as_jax(det, genome_backend):
    jsrc, tsrc = _pair(seed=5, n=12, genome_backend=genome_backend)
    jcells = [jsrc.get_cell(by_idx=i) for i in range(12)]
    tcells = [tsrc.get_cell(by_idx=i) for i in range(12)]
    jw, tw = _pair(seed=6, map_size=3, n=4, genome_backend=genome_backend, steps=0)
    assert tw.add_cells(tcells) == jw.add_cells(jcells) == list(range(4, 9))
    _assert_equal(jw, tw)
    assert tw.cell_map.all()
    assert tw.add_cells(tcells[:1]) == jw.add_cells(jcells[:1]) == []


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_kill_and_add_back_matches_jax(det, genome_backend):
    jw, tw = _pair(seed=8, genome_backend=genome_backend)
    idxs = [1, 4, 6, 11]
    cells = {}
    for key, w in (("jax", jw), ("port", tw)):
        cells[key] = [w.get_cell(by_idx=i) for i in idxs]
        for c in cells[key]:
            c.genome, c.int_molecules  # read before the rows move
        w.kill_cells(idxs)
    _assert_equal(jw, tw)
    assert jw.add_cells(cells["jax"]) == tw.add_cells(cells["port"])
    _assert_equal(jw, tw)
    assert_consistent(tw, sample=tw.n_cells)


@pytest.mark.parametrize("genome_backend", BACKENDS)
@pytest.mark.parametrize("subset", [None, [0, 3, 3, 9, 17]])
def test_move_cells_matches_jax(det, genome_backend, subset):
    jw, tw = _pair(seed=9, n=60, genome_backend=genome_backend)
    before = tw.cell_positions.copy()
    for w in (jw, tw):
        w.move_cells(subset)
    _assert_equal(jw, tw)
    after = tw.cell_positions
    assert tw.cell_map.sum() == tw.n_cells
    assert tw.cell_map[after[:, 0], after[:, 1]].all()
    d = np.abs(after - before)
    assert np.minimum(d, 16 - d).max() <= 1
    assert (after != before).any()
    for w in (jw, tw):
        w.enzymatic_activity()
        w.degrade_and_diffuse_molecules()
    _assert_equal(jw, tw)
    assert_consistent(tw, sample=tw.n_cells)


@pytest.mark.parametrize("genome_backend", BACKENDS)
@pytest.mark.parametrize("subset", [None, [0, 1]])
def test_reposition_cells_matches_jax(det, genome_backend, subset):
    jw, tw = _pair(seed=10, genome_backend=genome_backend)
    cm_before = tw.cell_molecules.copy()
    for w in (jw, tw):
        w.reposition_cells(subset)
    _assert_equal(jw, tw)
    assert tw.cell_map.sum() == tw.n_cells
    np.testing.assert_array_equal(tw.cell_molecules, cm_before)
    for w in (jw, tw):
        w.enzymatic_activity()
        w.degrade_and_diffuse_molecules()
    _assert_equal(jw, tw)
    assert_consistent(tw, sample=tw.n_cells)


def test_empty_moves_do_nothing(det):
    jw, tw = _pair(n=0)
    for w in (jw, tw):
        w.move_cells()
        w.reposition_cells()
        w.move_cells([])
    _assert_equal(jw, tw)


# ---------------------------------------------------------------- Kinetics


def _proteomes(world, n, seed):
    return world.genetics.translate_genomes(_genomes(n, s=800, seed=seed))


def test_kinetics_set_and_remove_cell_params_match_jax(det):
    jw, tw = _pair(n=10)
    jk, tk = jw.kinetics, tw.kinetics
    proteomes = _proteomes(tw, 6, seed=21)
    assert proteomes == _proteomes(jw, 6, seed=21)
    for k in (jk, tk):
        k.set_cell_params([2, 12, 3, 40, 12, 7], proteomes)
    _assert_equal(jw, tw)
    keep = np.zeros(tk.max_cells, dtype=bool)
    keep[[0, 2, 3, 7, 12, 40]] = True
    for k in (jk, tk):
        k.remove_cell_params(keep)
    _assert_equal(jw, tw)
    assert not tk.params.N[6:].any()


def test_kinetics_increase_capacities_match_jax(det):
    jw, tw = _pair(n=10)
    jk, tk = jw.kinetics, tw.kinetics
    cap, p = tk.max_cells, tk.max_proteins
    for k in (jk, tk):
        k.increase_max_cells(by_n=5)
        k.increase_max_proteins(max_n=p + 3)
        k.increase_max_proteins(max_n=1)
    assert (tk.max_cells, tk.max_proteins) == (jk.max_cells, jk.max_proteins) == (cap + 5, p + 3)
    for a, b in zip(jk.params, tk.params):
        assert a.shape == tuple(b.shape)
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def _signals(world):
    """The world's own signals (cell molecules, then their pixels'),
    over all cell slots; the dead rows are zero."""
    X0, _ = world.integrator_inputs()
    X = np.zeros((world.kinetics.max_cells, 2 * world.n_molecules), dtype=np.float32)
    X[: X0.shape[0]] = X0.numpy()
    return X


def _real_state_contract(out: np.ndarray, ref: np.ndarray) -> None:
    """The per-cell contract of fast mode on a world's real parameters
    (tests/test_torch_world.py, ROADMAP C4): finite and >= 0; at least
    85% of cells within 1e-4 relative, 98% within 0.01 of their largest
    value, all within 0.25."""
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    assert (rel.max(axis=1) < 1e-4).mean() >= 0.85
    scale = np.maximum(np.abs(ref).max(axis=1), 1e-6)
    norm = np.abs(out - ref).max(axis=1) / scale
    assert (norm < 0.01).mean() >= 0.98, (norm < 0.01).mean()
    assert norm.max() < 0.25, norm.max()


def test_kinetics_integrate_signals_det_is_bit_equal(det):
    jw, tw = _pair(n=30)
    X = _signals(tw)
    want = np.asarray(jw.kinetics.integrate_signals(jnp.asarray(X)))
    got = tw.kinetics.integrate_signals(X)
    assert got.dtype == torch.float32 and got.shape == X.shape
    assert got.numpy().tobytes() == want.tobytes()


def test_kinetics_integrate_signals_fast_matches_xla_fast(monkeypatch):
    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    monkeypatch.delenv("MAGICSOUP_TPU_TORCH_INTEGRATOR", raising=False)
    jw, tw = _pair(n=30)
    X = _signals(tw)
    want = np.asarray(jw.kinetics.integrate_signals(jnp.asarray(X)))
    got = tw.kinetics.integrate_signals(torch.from_numpy(X)).numpy()
    _real_state_contract(got[: tw.n_cells], want[: tw.n_cells])


def test_kinetics_integrate_signals_cuda_matches_pallas(monkeypatch):
    from magicsoup_tpu.ops.pallas_integrate import integrate_signals_pallas
    from magicsoup_tpu_torch.ops import cuda_integrate

    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    jw, tw = _pair(n=30)
    X = _signals(tw)
    want = np.asarray(
        integrate_signals_pallas(jnp.asarray(X), jw.kinetics.params, tile_c=8, interpret=True)
    )
    before = cuda_integrate.launches
    monkeypatch.setenv("MAGICSOUP_TPU_TORCH_INTEGRATOR", "cuda")
    got = tw.kinetics.integrate_signals(torch.from_numpy(X)).numpy()
    assert cuda_integrate.launches == before  # the plain version, on the CPU
    _real_state_contract(got[: tw.n_cells], want[: tw.n_cells])
