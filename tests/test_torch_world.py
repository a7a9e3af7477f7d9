"""
The slice as a whole: the port's classic World running the canonical
workload step against the JAX package's World.

- deterministic mode: worlds from one seed take the same decisions for 3
  steps of sim_step (positions, genomes, lifetimes, divisions, cell
  counts equal) and hold bit-equal molecules after each step;
- fast mode: from matched state (via ``interop``), one activity step plus
  degradation and diffusion agree with ``xla-fast`` under the fast
  contract, and the card's ``cuda`` backend (its plain version here)
  agrees with ``World(integrator="pallas")`` on eight seeds;
- the device default: CUDA, with ``device="cpu"`` as the way to the CPU.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import importlib.util  # noqa: E402
import random  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu.ops.integrate import CellParams as JCellParams  # noqa: E402
from magicsoup_tpu.ops.integrate import integrate_signals as jax_integrate_signals  # noqa: E402
from magicsoup_tpu.ops.pallas_integrate import integrate_signals_pallas  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.interop import load_world_arrays  # noqa: E402
from magicsoup_tpu_torch.ops import cuda_integrate  # noqa: E402
from magicsoup_tpu_torch.workload import sim_step as torch_sim_step  # noqa: E402


def _jax_sim_step():
    path = Path(__file__).resolve().parents[1] / "performance" / "workload.py"
    spec = importlib.util.spec_from_file_location("_jax_workload", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.sim_step


def _fast_contract(out: np.ndarray, ref: np.ndarray) -> None:
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    assert rel.max() < 0.15, rel.max()


def test_det_sim_step_matches_jax_world(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    jw = ms.World(chemistry=JCHEM, map_size=32, seed=7)
    tw = mt.World(chemistry=TCHEM, map_size=32, seed=7, device="cpu")
    assert (jw.integrator, tw.integrator) == ("xla-det", "torch-det")
    jstep = _jax_sim_step()
    jr, tr = random.Random(1), random.Random(1)
    for _ in range(3):
        jstep(jw, jr, n_cells=200, genome_size=500, atp_idx=2)
        torch_sim_step(tw, tr, n_cells=200, genome_size=500, atp_idx=2)
        assert jw.n_cells == tw.n_cells
        assert np.array_equal(jw.cell_positions, tw.cell_positions)
        assert jw.cell_genomes == tw.cell_genomes
        assert jw.cell_labels == tw.cell_labels
        assert np.array_equal(jw.cell_lifetimes, tw.cell_lifetimes)
        assert np.array_equal(jw.cell_divisions, tw.cell_divisions)
        assert np.array_equal(jw.cell_map, tw.cell_map)
        assert np.array_equal(np.asarray(jw.cell_molecules), tw.cell_molecules)
        assert np.array_equal(np.asarray(jw.molecule_map), tw.molecule_map.numpy())


def _real_state_contract(out: np.ndarray, ref: np.ndarray) -> None:
    """Cell molecules after a step on a world's real parameters (Km and
    Vmax log-normal over four orders of magnitude).  The negative guard
    drains a signal to exactly 0 up to rounding, and the equilibrium
    correction's quotient turns 0 against 5e-7 into a different branch:
    which cells take it follows summation order, and the JAX package's
    own det and fast integrators differ that way too.  So: finite and
    >= 0; at least 85% of cells within 1e-4 relative, 98% within 0.01 of
    their largest value, and all within 0.25."""
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    within = (rel.max(axis=1) < 1e-4).mean()
    assert within >= 0.85, within
    scale = np.maximum(np.abs(ref).max(axis=1), 1e-6)
    norm = np.abs(out - ref).max(axis=1) / scale
    assert (norm < 0.01).mean() >= 0.98, (norm < 0.01).mean()
    assert norm.max() < 0.25, norm.max()


def _matched_worlds(seed: int, n: int, integrators=(None, None)):
    jw = ms.World(chemistry=JCHEM, map_size=32, seed=seed, integrator=integrators[0])
    rng = random.Random(seed)
    jw.spawn_cells([ms.random_genome(s=500, rng=rng) for _ in range(n)])
    tw = mt.World(
        chemistry=TCHEM,
        map_size=32,
        seed=seed + 1,
        device="cpu",
        integrator=integrators[1],
    )
    load_world_arrays(
        tw,
        dict(
            molecule_map=np.asarray(jw.molecule_map),
            cell_molecules=np.asarray(jw.cell_molecules),
            cell_positions=jw.cell_positions,
            cell_lifetimes=jw.cell_lifetimes,
            cell_divisions=jw.cell_divisions,
            cell_genomes=list(jw.cell_genomes),
            cell_labels=list(jw.cell_labels),
            params={k: np.asarray(v) for k, v in jw.kinetics.params._asdict().items()},
        ),
    )
    return jw, tw


def test_fast_step_matches_xla_fast(monkeypatch):
    # the JAX world runs xla-fast (batch-global early stop), the port
    # torch-fast (its counterpart), under the elementwise fast contract;
    # that holds only on a seed where no cell sits on a correction
    # threshold (seed 5), so every seed goes through the real-state
    # contract in test_cuda_backend_matches_pallas_world
    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    jw, tw = _matched_worlds(seed=5, n=100)
    assert (jw.integrator, tw.integrator) == ("xla-fast", "torch-fast")
    assert tw.n_cells == jw.n_cells and tw._capacity == jw._capacity
    for w in (jw, tw):
        w.enzymatic_activity()
        w.degrade_and_diffuse_molecules()
    _fast_contract(tw.cell_molecules, np.asarray(jw.cell_molecules))
    _fast_contract(tw.molecule_map.numpy(), np.asarray(jw.molecule_map))


def test_cuda_backend_on_cpu_world_runs_the_plain_kernel_version(monkeypatch):
    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    _, tw = _matched_worlds(seed=5, n=100)
    before = cuda_integrate.launches
    ref_map, ref_cm = tw._molecule_map, tw._cell_molecules
    tw._integrator_choice = "cuda"
    tw.enzymatic_activity(prefetch_column=2)
    assert cuda_integrate.launches == before
    atp = tw.cell_molecule_column(2)
    assert atp.shape == (100,) and np.array_equal(atp, tw.cell_molecules[:, 2])
    # the per-tile stop differs from the batch-global one only where a
    # tile stops early; both stay finite and non-negative
    assert np.isfinite(tw.cell_molecules).all() and (tw.cell_molecules >= 0).all()
    assert tw._molecule_map is not ref_map and tw._cell_molecules is not ref_cm


@pytest.mark.parametrize("seed", range(8))
def test_cuda_backend_matches_pallas_world(monkeypatch, seed):
    # the card's default backend on a CPU world (its plain version, per
    # tile of 8 cells) against the JAX World(integrator="pallas"), whose
    # kernel runs in interpret mode on the CPU
    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    jw, tw = _matched_worlds(seed=seed, n=100, integrators=("pallas", "cuda"))
    assert (jw.integrator, tw.integrator) == ("pallas", "cuda")
    # the contract is one the JAX package meets against itself: its det
    # integrator against its Pallas kernel on this step's inputs
    X0, params = tw.integrator_inputs()
    jX0 = jnp.asarray(X0.numpy())
    jparams = JCellParams(*(jnp.asarray(t.numpy()) for t in params))
    pallas = integrate_signals_pallas(jX0, jparams, tile_c=8, interpret=True)
    det = jax_integrate_signals(jX0, jparams, det=True)
    _real_state_contract(np.asarray(det)[:100], np.asarray(pallas)[:100])
    before = cuda_integrate.launches
    for w in (jw, tw):
        w.enzymatic_activity()
        w.degrade_and_diffuse_molecules()
    assert cuda_integrate.launches == before
    jcm, jmm = np.asarray(jw.cell_molecules), np.asarray(jw.molecule_map)
    tcm, tmm = tw.cell_molecules, tw.molecule_map.numpy()
    _real_state_contract(tcm, jcm)
    _fast_contract(tmm, jmm)
    # per species, cells and map together
    jtot = jcm.sum(0, dtype=np.float64) + jmm.sum((1, 2), dtype=np.float64)
    ttot = tcm.sum(0, dtype=np.float64) + tmm.sum((1, 2), dtype=np.float64)
    assert (np.abs(ttot - jtot) / jtot).max() < 1e-4


def test_deterministic_mode_refuses_the_kernel(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    with pytest.raises(ValueError, match="not bit-reproducible"):
        mt.World(chemistry=TCHEM, map_size=16, seed=0, device="cpu", integrator="cuda")


def test_world_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.World(chemistry=TCHEM, map_size=16, seed=0)
    w = mt.World(chemistry=TCHEM, map_size=16, seed=0, device="cpu")
    assert w.device.type == "cpu" and w._capacity == 64
    assert w.integrator in ("torch-fast", "torch-det")


def test_lifecycle_keeps_state_consistent(monkeypatch):
    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    w = mt.World(chemistry=TCHEM, map_size=16, seed=4, device="cpu")
    rng = random.Random(4)
    idxs = w.spawn_cells([mt.random_genome(s=300, rng=rng) for _ in range(30)])
    assert idxs == list(range(30)) and w.cell_map.sum() == 30
    total = w.molecule_map.double().sum() + torch.from_numpy(w.cell_molecules).double().sum()
    pairs = w.divide_cells([0, 1, 2])
    assert [p for p, _ in pairs] == [0, 1, 2] and w.n_cells == 33
    assert np.array_equal(w.cell_genomes[30:], w.cell_genomes[:3])
    for t in w.kinetics.params:
        assert torch.equal(t[30:33], t[:3])
    w.kill_cells([5, 0])
    assert w.n_cells == 31 and w.cell_map.sum() == 31
    after = w.molecule_map.double().sum() + torch.from_numpy(w.cell_molecules).double().sum()
    assert torch.isclose(after, total, rtol=1e-6)
    for t in w.kinetics.params:
        assert not t[31:].any()
    assert w.get_neighbors(list(range(w.n_cells))) == [
        tuple(p) for p in w._neighbor_pairs(None).tolist()
    ]
