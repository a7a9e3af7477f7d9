"""
Persistence of the port's World on the CPU, string and token genomes:

- ``save``/``from_file`` round trips bit for bit (every state array,
  genomes, labels, counters, kinetic parameters, the token store, both
  RNG states), and the restored world continues bit-equal to the
  original for 5 deterministic workload steps;
- the pickle holds no torch storage (a world saved on a card loads with
  ``device="cpu"`` where there is none) and no phenotype-cache entries;
- a truncated or garbled file is a ``CheckpointError``; writes are atomic;
- ``save_state`` writes the JAX package's file set byte for byte, and a
  state directory written by either package loads into the other, with
  equal ``state_digest`` after 3 deterministic steps on both sides;
- the cases of ``tests/fast/test_world.py`` on saving and restoring.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import importlib.util  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import pickletools  # noqa: E402
import random  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu.check import differential as jdiff  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime  # noqa: E402
from magicsoup_tpu_torch.check import assert_consistent  # noqa: E402
from magicsoup_tpu_torch.check import differential as tdiff  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.guard.errors import CheckpointError  # noqa: E402
from magicsoup_tpu_torch.guard.io import atomic_write_bytes, atomic_write_text  # noqa: E402
from magicsoup_tpu_torch.workload import sim_step  # noqa: E402

BACKENDS = ["string", "token"]
ATP = TCHEM.molname_2_idx["ATP"]
STATE_FILES = (
    "cell_molecules.npy",
    "cell_map.npy",
    "molecule_map.npy",
    "cell_lifetimes.npy",
    "cell_positions.npy",
    "cell_divisions.npy",
    "cells.fasta",
)


def _world(genome_backend="string", seed=5, n_cells=30, steps=3):
    world = mt.World(
        chemistry=TCHEM, map_size=16, seed=seed, device="cpu", genome_backend=genome_backend
    )
    rng = random.Random(seed)
    for _ in range(steps):
        sim_step(world, rng, n_cells=n_cells, genome_size=300, atp_idx=ATP)
    return world


def _snapshot(world) -> dict:
    """Every piece of a world's state that a save must keep."""
    out = {
        "n_cells": world.n_cells,
        "capacity": world._capacity,
        "molecule_map": world.molecule_map.numpy().copy(),
        "cell_molecules": world._cell_molecules.numpy().copy(),
        "positions": world._np_positions.copy(),
        "lifetimes": world._np_lifetimes.copy(),
        "divisions": world._np_divisions.copy(),
        "cell_map": world.cell_map.copy(),
        "genomes": list(world.cell_genomes),
        "labels": list(world.cell_labels),
        "rng": world._rng.getstate(),
        "nprng": world._nprng.bit_generator.state,
        "deterministic": world.deterministic,
        "integrator": world.integrator,
        "kin_caps": (world.kinetics.max_cells, world.kinetics.max_proteins, world.kinetics.max_doms),
    }
    for name, t in world.kinetics.params._asdict().items():
        out[f"params.{name}"] = t.numpy().copy()
    for name, t in world.kinetics.tables._asdict().items():
        out[f"tables.{name}"] = t.numpy().copy()
    if world.genome_store is not None:
        out["store.tokens"] = world.genome_store.tokens.numpy().copy()
        out["store.lengths"] = world.genome_store.lengths.numpy().copy()
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tobytes() == y.tobytes(), key
        else:
            assert x == y, key


def _torch_modules(data: bytes) -> set[str]:
    """Module names of the globals a pickle refers to, if any are torch's."""
    strings = {arg for _, arg, _ in pickletools.genops(data) if isinstance(arg, str)}
    return {s for s in strings if s == "torch" or s.startswith("torch.")}


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_save_from_file_round_trip_is_bit_equal_and_continues(tmp_path, monkeypatch, genome_backend):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    world = _world(genome_backend)
    world.save(tmp_path)
    restored = mt.World.from_file(tmp_path, device="cpu")
    assert restored.device == torch.device("cpu")
    _assert_same(_snapshot(world), _snapshot(restored))
    assert_consistent(restored, sample=restored.n_cells)
    rngs = [random.Random(9), random.Random(9)]
    for _ in range(5):
        for w, rng in zip((world, restored), rngs):
            sim_step(w, rng, n_cells=30, genome_size=300, atp_idx=ATP)
        _assert_same(_snapshot(world), _snapshot(restored))


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_pickle_holds_no_torch_storage_and_no_cache_entries(genome_backend):
    world = _world(genome_backend)
    world.prefetch_cell_molecule_column(ATP)
    assert len(world.phenotypes) > 0
    drops0 = runtime.phenotype_cache_stats()["pickle_drops"]
    data = pickle.dumps(world)
    assert _torch_modules(data) == set()
    restored = pickle.loads(data)
    assert len(restored.phenotypes) == 0
    assert runtime.phenotype_cache_stats()["pickle_drops"] - drops0 == len(world.phenotypes)
    assert restored._col_prefetch is None
    assert restored._positions_dev.tolist() == world._positions_dev.tolist()
    # the first step re-translates, with the same parameters as before
    misses = restored.phenotypes.misses
    restored.update_cells([(g, i) for i, g in enumerate(restored.cell_genomes)])
    assert restored.phenotypes.misses > misses
    _assert_same(_snapshot(world), _snapshot(restored))


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_a_world_saved_on_the_card_loads_with_device_cpu(tmp_path, monkeypatch, genome_backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a machine without a card
    world = _world(genome_backend)
    want = _snapshot(world)
    # a world saved on the card records its device as "cuda"
    cuda = torch.device("cuda")
    world.device = world.kinetics.device = cuda
    if world.genome_store is not None:
        world.genome_store.device = cuda
    world.save(tmp_path)
    assert _torch_modules((tmp_path / "world.pkl").read_bytes()) == set()
    restored = mt.World.from_file(tmp_path, device="cpu")
    assert restored.device == restored.kinetics.device == torch.device("cpu")
    _assert_same(want, _snapshot(restored))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.World.from_file(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pickle.loads((tmp_path / "world.pkl").read_bytes())


def test_truncated_or_garbled_pickle_raises_checkpoint_error(tmp_path):
    world = _world()
    world.save(tmp_path)
    data = (tmp_path / "world.pkl").read_bytes()
    for bad in (data[: len(data) // 2], b"", b"not a pickle"):
        (tmp_path / "bad.pkl").write_bytes(bad)
        with pytest.raises(CheckpointError) as err:
            mt.World.from_file(tmp_path, name="bad.pkl", device="cpu")
        assert err.value.check == "truncated"
        assert err.value.path == str(tmp_path / "bad.pkl")


def test_atomic_writes_leave_the_old_file_on_failure(tmp_path, monkeypatch):
    target = tmp_path / "sub" / "f.bin"
    atomic_write_bytes(target, b"old")
    atomic_write_text(tmp_path / "t.txt", "text\n")
    assert (tmp_path / "t.txt").read_text() == "text\n"

    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", fail)
    with pytest.raises(OSError, match="disk full"):
        atomic_write_bytes(target, b"new")
    assert target.read_bytes() == b"old"
    assert sorted(p.name for p in target.parent.iterdir()) == ["f.bin"]


def test_kinetics_and_genome_store_pickle_alone(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    world = _world("token")
    kin = pickle.loads(pickle.dumps(world.kinetics))
    for a, b in zip(world.kinetics.params, kin.params):
        assert a.dtype == b.dtype and torch.equal(a, b)
    X = torch.rand((world._capacity, 2 * world.n_molecules), generator=torch.Generator().manual_seed(0))
    assert torch.equal(kin.integrate_signals(X), world.kinetics.integrate_signals(X))
    store = pickle.loads(pickle.dumps(world.genome_store))
    assert store.decoded(world.n_cells) == world.cell_genomes
    assert store.version == world.genome_store.version
    store.place("cpu")
    assert torch.equal(store.tokens, world.genome_store.tokens)


def _jax_world(seed, genome_backend="string"):
    return ms.World(chemistry=JCHEM, map_size=16, seed=seed, genome_backend=genome_backend)


def _det_pair(genome_backend, seed=5):
    """A JAX and a port world from one seed, 3 det workload steps each."""
    path = Path(__file__).resolve().parents[1] / "performance" / "workload.py"
    spec = importlib.util.spec_from_file_location("_jax_workload", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jw = _jax_world(seed, genome_backend)
    tw = mt.World(chemistry=TCHEM, map_size=16, seed=seed, device="cpu", genome_backend=genome_backend)
    jr, tr = random.Random(seed), random.Random(seed)
    for _ in range(3):
        mod.sim_step(jw, jr, n_cells=30, genome_size=300, atp_idx=ATP)
        sim_step(tw, tr, n_cells=30, genome_size=300, atp_idx=ATP)
    return jw, tw


def _chem_steps(world, n=3):
    for _ in range(n):
        world.enzymatic_activity()
        world.degrade_and_diffuse_molecules()
        world.increment_cell_lifetimes()


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_save_state_crosses_the_two_packages(tmp_path, monkeypatch, genome_backend):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    jw, tw = _det_pair(genome_backend)
    assert jdiff.state_digest(jw) == tdiff.state_digest(tw)
    jw.save_state(tmp_path / "jax")
    tw.save_state(tmp_path / "port")
    for name in STATE_FILES:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name
    assert not (tmp_path / "port" / "cells.fasta").read_text().endswith("\n")
    assert np.load(tmp_path / "port" / "cell_map.npy").dtype == bool

    # JAX -> port and port -> JAX, each into a fresh world of the other
    # package from one seed
    into_port = mt.World(chemistry=TCHEM, map_size=16, seed=8, device="cpu", genome_backend=genome_backend)
    into_port.load_state(tmp_path / "jax")
    into_jax = _jax_world(8, genome_backend)
    into_jax.load_state(tmp_path / "port")
    assert tdiff.state_digest(into_port) == jdiff.state_digest(into_jax)
    _chem_steps(into_port)
    _chem_steps(into_jax)
    assert tdiff.state_digest(into_port) == jdiff.state_digest(into_jax)
    assert_consistent(into_port, sample=into_port.n_cells)


@pytest.mark.parametrize("genome_backend", BACKENDS)
def test_save_and_load_state(tmp_path, genome_backend):
    world = _world(genome_backend, n_cells=20, steps=1)
    for _ in range(3):
        world.enzymatic_activity()
        world.diffuse_molecules()
    world.increment_cell_lifetimes()
    world.save_state(tmp_path / "state")
    genomes = list(world.cell_genomes)
    labels = list(world.cell_labels)
    cm = world.cell_molecules.copy()
    mm = world.molecule_map.numpy().copy()
    pos = world.cell_positions.copy()
    lifetimes = world.cell_lifetimes.copy()
    n_before = world.n_cells

    world.kill_cells()
    world.load_state(tmp_path / "state")
    assert world.n_cells == n_before
    assert world.cell_genomes == genomes
    assert world.cell_labels == labels
    assert world.cell_molecules.tobytes() == cm.tobytes()
    assert world.molecule_map.numpy().tobytes() == mm.tobytes()
    np.testing.assert_array_equal(world.cell_positions, pos)
    np.testing.assert_array_equal(world.cell_lifetimes, lifetimes)
    assert_consistent(world, sample=world.n_cells)
    world.enzymatic_activity()

    # into a fresh world of another seed, and with ignore_cell_params
    fresh = mt.World(chemistry=TCHEM, map_size=16, seed=99, device="cpu", genome_backend=genome_backend)
    fresh.load_state(tmp_path / "state")
    assert fresh.cell_genomes == genomes and fresh.cell_labels == labels
    assert_consistent(fresh, sample=fresh.n_cells)
    bare = mt.World(chemistry=TCHEM, map_size=16, seed=99, device="cpu", genome_backend=genome_backend)
    bare.load_state(tmp_path / "state", ignore_cell_params=True)
    assert bare.cell_genomes == genomes
    assert not bare.kinetics.params.N.any()


def test_save_and_from_file_roundtrip(tmp_path):
    world = _world(n_cells=10, steps=1)
    world.enzymatic_activity()
    world.save(tmp_path)
    w2 = mt.World.from_file(tmp_path, device="cpu")
    assert w2.n_cells == world.n_cells
    assert w2.cell_genomes == world.cell_genomes
    np.testing.assert_array_equal(w2.cell_molecules, world.cell_molecules)
    # the genotype -> phenotype maps survive: the same proteome
    p1 = [str(d) for d in world.get_cell(by_idx=0).proteome]
    p2 = [str(d) for d in w2.get_cell(by_idx=0).proteome]
    assert p1 == p2
    assert torch.equal(w2.kinetics.params.Kmf, world.kinetics.params.Kmf)
    w2.enzymatic_activity()


def test_capacity_growth_preserves_state():
    world = mt.World(chemistry=TCHEM, map_size=32, seed=1, device="cpu", mol_map_init="zeros")
    world.molecule_map = np.full(world.molecule_map.shape, 2.0)
    rng = random.Random(1)
    world.spawn_cells([mt.random_genome(s=500, rng=rng) for _ in range(10)])
    cm_before = world.cell_molecules.copy()
    vmax_before = world.kinetics.params.Vmax[:10].clone()
    world.spawn_cells([mt.random_genome(s=500, rng=rng) for _ in range(200)])
    assert world._capacity > 64
    np.testing.assert_array_equal(world.cell_molecules[:10], cm_before)
    p = vmax_before.shape[1]
    assert torch.equal(world.kinetics.params.Vmax[:10, :p], vmax_before)


def test_seeded_worlds_reproduce():
    w1, w2 = (mt.World(chemistry=TCHEM, map_size=32, seed=123, device="cpu") for _ in range(2))
    rng = random.Random(9)
    g = [mt.random_genome(s=300, rng=rng) for _ in range(10)]
    assert w1.spawn_cells(g) == w2.spawn_cells(g)
    np.testing.assert_array_equal(w1.cell_positions, w2.cell_positions)
    assert torch.equal(w1.molecule_map, w2.molecule_map)
    w1.enzymatic_activity()
    w2.enzymatic_activity()
    np.testing.assert_array_equal(w1.cell_molecules, w2.cell_molecules)
    w1.mutate_cells(p=1e-3)
    w2.mutate_cells(p=1e-3)
    assert w1.cell_genomes == w2.cell_genomes
