"""
The public names the port took over from the JAX package last, each
against its JAX counterpart on the same seeded inputs:

- ``stepper.record_flag_views``: equal views, sharing the fetched
  buffer's memory, at each leading shape;
- ``Kinetics.build_dense_tokens``: equal dense tokens and capacities,
  through a batch that grows the capacities;
- ``ops.integrate.integrate_signals_steps``: bit-equal in deterministic
  mode at n 1 and 3, within the fast contract (ROADMAP C4) in fast mode;
  the caller's ``X`` is left intact;
- ``World.prewarm_activity`` / ``wait_warm``: ``state_digest`` unchanged,
  the next activity at that rung compiles 0, and the det trajectory
  equals the JAX world's; the stepper's ``prewarm`` / ``wait_warm`` warm
  its dispatch without changing its trajectory.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import random  # noqa: E402
import time  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu import stepper as jstepper  # noqa: E402
from magicsoup_tpu.analysis import runtime as jrt  # noqa: E402
from magicsoup_tpu.check.differential import state_digest as jdigest  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu.ops.integrate import CellParams as JParams  # noqa: E402
from magicsoup_tpu.ops.integrate import integrate_signals_steps as jsteps  # noqa: E402
from magicsoup_tpu_torch import stepper as tstepper  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime as rt  # noqa: E402
from magicsoup_tpu_torch.check.differential import state_digest as tdigest  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.interop import params_from_numpy  # noqa: E402
from magicsoup_tpu_torch.ops.integrate import integrate_signals_steps  # noqa: E402


@pytest.fixture
def det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")


# --------------------------------------------------- record_flag_views
@pytest.mark.parametrize("lead", [(), (4,), (3, 4)], ids=["one", "megastep", "fleet"])
def test_record_flag_views_equal_jax_and_share_memory(lead):
    assert (tstepper.HEALTH_WORD, tstepper.INVARIANT_WORD) == (
        jstepper.HEALTH_WORD, jstepper.INVARIANT_WORD,
    )
    rec = np.random.default_rng(7).integers(0, 2**15, lead + (40,), dtype=np.int32)
    health, inv = tstepper.record_flag_views(rec)
    jhealth, jinv = jstepper.record_flag_views(rec)
    assert health.shape == lead and inv.shape == lead
    assert np.array_equal(health, jhealth) and np.array_equal(inv, jinv)
    assert np.shares_memory(health, rec) and np.shares_memory(inv, rec)
    rec[..., tstepper.HEALTH_WORD] = 5  # views, not copies
    assert (health == 5).all()


# -------------------------------------------------- build_dense_tokens
def test_build_dense_tokens_equals_jax_through_capacity_growth():
    jw = ms.World(chemistry=JCHEM, map_size=16, seed=7)
    tw = mt.World(chemistry=TCHEM, map_size=16, seed=7, device="cpu")
    rng = random.Random(7)
    batches = [
        [ms.random_genome(s=200, rng=rng) for _ in range(6)],
        [ms.random_genome(s=3000, rng=rng) for _ in range(3)],  # grows p and d
    ]
    grew = False
    for genomes in batches:
        jflat = jw.genetics.translate_genomes_flat(genomes)
        tflat = tw.genetics.translate_genomes_flat(genomes)
        for a, b in zip(jflat, tflat):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        before = (tw.kinetics.max_proteins, tw.kinetics.max_doms)
        jdense = jw.kinetics.build_dense_tokens(*jflat)
        tdense = tw.kinetics.build_dense_tokens(*tflat)
        assert (tw.kinetics.max_proteins, tw.kinetics.max_doms) == (
            jw.kinetics.max_proteins, jw.kinetics.max_doms,
        )
        assert tdense.shape == (len(genomes), tw.kinetics.max_proteins, tw.kinetics.max_doms, 5)
        assert tdense.dtype == np.asarray(jdense).dtype
        assert np.array_equal(tdense, np.asarray(jdense))
        grew |= (tw.kinetics.max_proteins, tw.kinetics.max_doms) != before
    assert grew


# --------------------------------------------- integrate_signals_steps
def _inputs(c: int = 64, p: int = 8, s: int = 12, seed: int = 3):
    rng = np.random.default_rng(seed)
    d = dict(
        Ke=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmf=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmb=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmr=rng.uniform(0.1, 10, (c, p, s)).astype(np.float32),
        Vmax=rng.uniform(0, 2, (c, p)).astype(np.float32),
        N=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
        Nf=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        Nb=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        A=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
    )
    return rng.uniform(0, 4, (c, s)).astype(np.float32), d


def _jax_steps(X, d, n, det):
    params = JParams(**{k: jnp.asarray(v) for k, v in d.items()})
    return np.asarray(jsteps(jnp.asarray(X), params, n_steps=n, det=det))


def _assert_fast_contract(out: np.ndarray, ref: np.ndarray) -> None:
    """ROADMAP C4's per-cell contract: every cell finite and >= 0; >= 85%
    of cells within 1e-4 relative; >= 98% within 0.01 of their largest
    value; all within 0.25."""
    assert np.isfinite(out).all() and (out >= 0).all()
    diff = np.abs(out - ref)
    rel = (diff / (np.abs(ref) + 1e-6)).max(axis=1)
    scaled = (diff / (np.abs(ref).max(axis=1, keepdims=True) + 1e-6)).max(axis=1)
    assert (rel <= 1e-4).mean() >= 0.85, (rel <= 1e-4).mean()
    assert (scaled <= 0.01).mean() >= 0.98, (scaled <= 0.01).mean()
    assert scaled.max() <= 0.25, scaled.max()


@pytest.mark.parametrize("n", [1, 3])
def test_integrate_signals_steps_det_bit_equal_to_jax(n):
    X, d = _inputs()
    Xt = torch.from_numpy(X.copy())
    out = integrate_signals_steps(Xt, params_from_numpy(d, "cpu"), n_steps=n, det=True)
    assert np.array_equal(out.numpy(), _jax_steps(X, d, n, det=True))
    assert np.array_equal(Xt.numpy(), X)  # the caller's X is left intact


@pytest.mark.parametrize("n", [1, 3])
def test_integrate_signals_steps_fast_within_contract(n):
    X, d = _inputs(seed=4)
    out = integrate_signals_steps(X, params_from_numpy(d, "cpu"), n_steps=n, det=False)
    assert isinstance(out, torch.Tensor) and out.shape == X.shape
    _assert_fast_contract(out.numpy(), _jax_steps(X, d, n, det=False))


def test_integrate_signals_steps_is_n_serial_steps():
    from magicsoup_tpu_torch.ops.integrate import integrate_signals

    X, d = _inputs(seed=5)
    params = params_from_numpy(d, "cpu")
    serial = torch.from_numpy(X)
    for _ in range(3):
        serial = integrate_signals(serial, params, det=True)
    assert torch.equal(integrate_signals_steps(torch.from_numpy(X), params, 3, det=True), serial)
    zero = integrate_signals_steps(torch.from_numpy(X), params, 0, det=True)
    assert np.array_equal(zero.numpy(), X)


# ---------------------------------------------------- prewarm_activity
def _chem(lib, tag: str):
    mols = [lib.Molecule(f"{tag}-a", 10e3), lib.Molecule(f"{tag}-atp", 8e3, half_life=100_000)]
    return lib.Chemistry(molecules=mols, reactions=[([mols[0]], [mols[1]])])


CHEMS = {(lib.__name__, t): _chem(lib, t) for lib in (ms, mt) for t in ("api-pw", "api-st", "api-st0")}


def _world(lib, tag: str, seed: int, n_cells: int = 60, **kw):
    if lib is mt:
        kw.setdefault("device", "cpu")
    w = lib.World(chemistry=CHEMS[(lib.__name__, tag)], map_size=32, seed=seed, **kw)
    rng = random.Random(seed)
    w.spawn_cells([lib.random_genome(s=250, rng=rng) for _ in range(n_cells)])
    return w


def test_prewarm_activity_leaves_state_and_warms_the_rung(det):
    jw, tw = _world(ms, "api-pw", 9), _world(mt, "api-pw", 9)
    d0 = tdigest(tw)
    assert d0 == jdigest(jw)
    jw.prewarm_activity()
    tw.prewarm_activity()
    t0 = time.perf_counter()
    jw.wait_warm()
    tw.wait_warm(timeout=1.0)
    assert time.perf_counter() - t0 < 5.0
    assert tdigest(tw) == d0 == jdigest(jw)
    with rt.hot_path_guard(compile_budget=0) as stats:
        tw.enzymatic_activity()
    with jrt.hot_path_guard(compile_budget=0, transfers="allow") as jstats:
        jw.enzymatic_activity()
    assert stats.compiles == jstats.compiles == 0
    assert tdigest(tw) == jdigest(jw)
    # the rung above is warm too, the prefetch variant is its own shape
    from magicsoup_tpu_torch.ops.params import next_rung, quantize_rows

    q = quantize_rows(tw.n_cells, tw._capacity)
    assert tw._activity_variant_key(next_rung(q, tw._capacity), False) in rt._shapes_seen
    assert tw._activity_variant_key(q, True) not in rt._shapes_seen
    tw.prewarm_activity(q=q, has_col=True)
    assert tw._activity_variant_key(q, True) in rt._shapes_seen


def test_prewarm_activity_is_a_no_op_without_cells():
    w = mt.World(chemistry=CHEMS[("magicsoup_tpu_torch", "api-pw")], map_size=16, seed=1,
                 device="cpu")
    before = rt.compile_count()
    w.prewarm_activity()
    w.wait_warm()
    assert rt.compile_count() == before


def test_stepper_prewarm_warms_its_dispatch_without_changing_it(det):
    # a capacity that holds the run, so the first dispatch is at the rung
    # prewarm() warms; a run at a capacity no one warmed compiles once
    def run(warm, cap):
        w = _world(mt, "api-st", 11, n_cells=40)
        w._ensure_capacity(cap)
        st = mt.PipelinedStepper(
            w, mol_name="api-st-atp", kill_below=-1.0, divide_above=1e30,
            divide_cost=0.0, target_cells=None, genome_size=250, lag=2,
            p_mutation=0.0, p_recombination=0.0,
        )
        if warm:
            st.prewarm()
            st.wait_warm()
        with rt.hot_path_guard(compile_budget=1) as stats:
            for _ in range(4):
                st.step()
            st.drain()
        st.flush()
        return stats.compiles, tdigest(w)

    warm = run(True, 512)
    assert warm[0] == 0
    assert run(False, 1024)[0] == 1
    again = run(False, 512)  # warm now without prewarm: the same trajectory
    assert again == (0, warm[1])
