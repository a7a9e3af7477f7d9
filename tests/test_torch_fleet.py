"""
The port's fleet rung-group step against the JAX package's fleet and
against solo steppers, all in deterministic mode:

- a B = 1 fleet equals the solo stepper;
- in one group of B = 3 worlds (a block of 4, one empty slot), each world
  is bit-equal to its solo run and to
  ``magicsoup_tpu.fleet.FleetScheduler`` on the same worlds, with one
  dispatch and one integrator dispatch per group per fleet step;
- retire, solo steps, readmit: the round trip leaves the world's
  trajectory as a solo run's, and a fifth world opens a sibling group;
  a capacity growth moves a world to another rung, with its solo
  trajectory;
- three token worlds (``genome_backend="token"``) in one group: each
  bit-equal to its solo run and to the JAX fleet, stores included (the
  counterpart of ``check/differential.py``'s ``token_fleet3``);
- K2's plain version (the batched grid, per world in tiles of 8) on a
  rank-3 X against the Pallas kernel's batched grid in interpret mode,
  under the fast contract, with world w bit-equal to its B = 1 output.
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
from magicsoup_tpu.fleet import FleetScheduler as JFleet  # noqa: E402
from magicsoup_tpu.ops.integrate import CellParams as JParams  # noqa: E402
from magicsoup_tpu.ops.pallas_integrate import integrate_signals_pallas  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.interop import params_from_numpy  # noqa: E402
from magicsoup_tpu_torch.ops import backends  # noqa: E402
from magicsoup_tpu_torch.ops import cuda_integrate as ci  # noqa: E402
from magicsoup_tpu_torch.ops.integrate import CellParams  # noqa: E402

KW = dict(
    mol_name="ATP",
    kill_below=1.0,
    divide_above=3.0,
    divide_cost=1.0,
    target_cells=40,
    genome_size=300,
    lag=2,
    max_divisions=64,
    spawn_block=16,
    push_block=16,
    p_mutation=1e-3,
    p_recombination=1e-4,
)


@pytest.fixture
def det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")


def _world(lib, chem, seed: int, **kw):
    w = lib.World(chemistry=chem, map_size=16, seed=seed, **kw)
    rng = random.Random(seed)
    w.spawn_cells([lib.random_genome(s=300, rng=rng) for _ in range(20)])
    w._ensure_capacity(100)
    return w


def _tworld(seed: int, **kw):
    return _world(mt, TCHEM, seed, device="cpu", **kw)


def _solo(seed: int, n: int, **kw):
    w = _tworld(seed, **kw)
    st = mt.PipelinedStepper(w, **KW)
    for _ in range(n):
        st.step()
    st.flush()
    return w, st


def _assert_same(a, b) -> None:
    """Two worlds (either package) in equal structure, bit-equal molecules."""
    assert a.n_cells == b.n_cells > 0
    assert np.array_equal(a.cell_positions, b.cell_positions)
    assert a.cell_genomes == b.cell_genomes
    assert a.cell_labels == b.cell_labels
    assert np.array_equal(a.cell_lifetimes, b.cell_lifetimes)
    assert np.array_equal(a.cell_divisions, b.cell_divisions)
    assert np.array_equal(np.asarray(a.cell_molecules), np.asarray(b.cell_molecules))
    amm, bmm = (np.asarray(w.molecule_map.cpu() if torch.is_tensor(w.molecule_map)
                           else w.molecule_map) for w in (a, b))
    assert np.array_equal(amm, bmm)


def test_b1_fleet_equals_solo(det):
    w = _tworld(7)
    fleet = mt.FleetScheduler(block=1)
    fleet.admit(w, **KW)
    for _ in range(5):
        fleet.step()
    fleet.flush()
    solo, _ = _solo(7, 5)
    _assert_same(w, solo)


def test_b3_group_matches_jax_fleet_and_solo(det):
    seeds, n = (3, 4, 5), 5
    jf, tf = JFleet(block=4), mt.FleetScheduler(block=4)
    jws = [_world(ms, JCHEM, s) for s in seeds]
    tws = [_tworld(s) for s in seeds]
    for jw, tw in zip(jws, tws):
        jf.admit(jw, **KW)
        tf.admit(tw, **KW)
    runtime.reset_counters()
    for _ in range(n):
        jf.step()
        tf.step()
    census = runtime.snapshot()
    # the snapshot also carries the device-time census (one entry per
    # replayed group dispatch, so settled only after the flush below) and
    # the chaos counters, as the JAX package's does
    device_us, device_dispatches = census.pop("device_time_us"), census.pop("device_dispatches")
    assert device_us >= 0 and device_dispatches <= n
    # the compile, build-cache and phenotype counters depend on what this
    # process ran before (a program shape dispatched once stays warm)
    assert census.pop("compiles") <= 1
    for key in ("persistent_cache_hits", "persistent_cache_misses", "phenotype_hits",
                "phenotype_misses", "phenotype_evictions", "phenotype_pickle_drops"):
        assert census.pop(key) >= 0
    assert census == {
        "dispatches": n,
        "fused_groups": n,
        "integrator_dispatches_torch-det": n,
        "restack_full": 1,
        "restack_inserts": 0,
        "restack_skipped": 0,
        "attach_full": 0,
        "attach_skipped": 0,
        "genome_decode_calls": 0,
        "genome_decode_rows": 0,
        "chaos_fired": 0,
        "degraded": 0,
    }
    jf.flush()
    tf.flush()
    assert runtime.snapshot()["device_dispatches"] == n
    assert sum(lane.stats["divisions"] for lane in tf.lanes) > 0
    assert sum(lane.stats["spawned"] for lane in tf.lanes) > 0
    for s, jw, tw in zip(seeds, jws, tws):
        _assert_same(jw, tw)
        _assert_same(_solo(s, n)[0], tw)


def test_token_b3_group_matches_jax_fleet_and_solo(det):
    seeds, n = (3, 4, 5), 5
    jf, tf = JFleet(block=4), mt.FleetScheduler(block=4)
    jws = [_world(ms, JCHEM, s, genome_backend="token") for s in seeds]
    tws = [_tworld(s, genome_backend="token") for s in seeds]
    for jw, tw in zip(jws, tws):
        jf.admit(jw, **KW)
        tf.admit(tw, **KW)
    for _ in range(n):
        jf.step()
        tf.step()
    jf.flush()
    tf.flush()
    assert sum(lane.stats["genome_changes"] for lane in tf.lanes) > 0
    for s, jw, tw in zip(seeds, jws, tws):
        _assert_same(jw, tw)
        solo = _solo(s, n, genome_backend="token")[0]
        _assert_same(solo, tw)
        for ref in (jw.genome_store, solo.genome_store):
            assert np.array_equal(np.asarray(ref.tokens), tw.genome_store.tokens.numpy())
            assert np.array_equal(np.asarray(ref.lengths), tw.genome_store.lengths.numpy())


def test_retire_readmit_and_sibling_groups(det):
    seeds = (11, 12, 13, 14, 15)
    fleet = mt.FleetScheduler(block=4)
    worlds = [_tworld(s) for s in seeds]
    lanes = [fleet.admit(w, **KW) for w in worlds]
    runtime.reset_counters()
    for _ in range(2):
        fleet.step()
    # five worlds in blocks of 4: a second group of the same rung
    assert runtime.snapshot()["dispatches"] == 4
    lane = fleet.retire(lanes[0])
    for _ in range(2):
        lane.step()
    fleet.readmit(lane)
    for _ in range(2):
        fleet.step()
    fleet.flush()
    _assert_same(worlds[0], _solo(seeds[0], 6)[0])
    _assert_same(worlds[4], _solo(seeds[4], 4)[0])
    with pytest.raises(RuntimeError, match="FleetScheduler"):
        lanes[1].step()


def test_capacity_growth_moves_a_world_to_another_rung(det):
    # a larger population target crowds capacity 128 after a few steps:
    # that world drains, grows to 256 and leaves the group for a rung of
    # its own, and both keep their solo trajectories
    kw = dict(KW, target_cells=70)
    fleet = mt.FleetScheduler(block=2)
    worlds = [_tworld(21), _tworld(22)]
    lanes = [fleet.admit(worlds[0], **kw), fleet.admit(worlds[1], **KW)]
    runtime.reset_counters()
    for _ in range(6):
        fleet.step()
    assert lanes[0].stats["growths"] == 1 and worlds[0]._capacity == 256
    assert lanes[1].stats["growths"] == 0
    assert 6 < runtime.snapshot()["dispatches"] < 12
    fleet.flush()
    for seed, w, k in ((21, worlds[0], kw), (22, worlds[1], KW)):
        solo = _tworld(seed)
        st = mt.PipelinedStepper(solo, **k)
        for _ in range(6):
            st.step()
        st.flush()
        _assert_same(w, solo)


def _inputs(B: int, c: int = 32, p: int = 8, s: int = 12, seed: int = 0):
    """Seeded inputs drawn as performance/pallas_bisect.py draws them, with
    a leading world axis."""
    rng = np.random.default_rng(seed)
    d = dict(
        Ke=rng.uniform(0.1, 10, (B, c, p)).astype(np.float32),
        Kmf=rng.uniform(0.1, 10, (B, c, p)).astype(np.float32),
        Kmb=rng.uniform(0.1, 10, (B, c, p)).astype(np.float32),
        Kmr=rng.uniform(0.1, 10, (B, c, p, s)).astype(np.float32),
        Vmax=rng.uniform(0, 2, (B, c, p)).astype(np.float32),
        N=rng.integers(-2, 3, (B, c, p, s)).astype(np.int16),
        Nf=rng.integers(0, 3, (B, c, p, s)).astype(np.int16),
        Nb=rng.integers(0, 3, (B, c, p, s)).astype(np.int16),
        A=rng.integers(-2, 3, (B, c, p, s)).astype(np.int16),
    )
    X = rng.uniform(0, 4, (B, c, s)).astype(np.float32)
    for k in d:  # one dead tile in world 1
        d[k][1, 8:16] = 0
    return X, d


def _fast_contract(out: np.ndarray, ref: np.ndarray) -> None:
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    assert rel.max() < 0.15, rel.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_plain_matches_pallas_batched_grid(seed):
    X, d = _inputs(B=3, seed=seed)
    ref = integrate_signals_pallas(
        jnp.asarray(X), JParams(**{k: jnp.asarray(v) for k, v in d.items()}),
        tile_c=8, interpret=True,
    )
    Xt, params = torch.from_numpy(X), params_from_numpy(d, "cpu")
    before = ci.launches
    out = ci.integrate_signals_cuda(Xt, params)
    assert ci.launches == before  # CPU tensors never launch the kernel
    _fast_contract(out.numpy(), np.asarray(ref))
    assert np.array_equal(out[1, 8:16].numpy(), X[1, 8:16])  # dead rows inert
    for w in range(3):
        solo = ci.integrate_signals_cuda(
            Xt[w : w + 1], CellParams(*(t[w : w + 1] for t in params))
        )
        assert torch.equal(solo[0], out[w])
        assert torch.equal(
            backends.integrate("cuda", Xt[w], CellParams(*(t[w] for t in params))), out[w]
        )
    # the backend plane routes rank-3 X: cuda to one launch, the torch
    # bodies per world
    assert torch.equal(backends.integrate("cuda", Xt, params), out)
    det = backends.integrate("torch-det", Xt, params)
    for w in range(3):
        one = backends.integrate("torch-det", Xt[w], CellParams(*(t[w] for t in params)))
        assert torch.equal(det[w], one)


def test_batched_wrapper_takes_row_prefixes_of_a_stack():
    X, d = _inputs(B=2, c=32)
    stack = params_from_numpy(d, "cpu")
    prefix = CellParams(*(t[:, :16] for t in stack))
    Xq = torch.from_numpy(X[:, :16].copy())
    out = ci.integrate_signals_cuda(Xq, prefix)
    dense = CellParams(*(t.contiguous() for t in prefix))
    assert torch.equal(out, ci.integrate_signals_cuda(Xq, dense))
    assert ci._check(Xq, prefix) == 32  # the stack's world stride in rows
    with pytest.raises(ValueError, match="must be contiguous within each world"):
        ci.integrate_signals_cuda(
            Xq, prefix._replace(Kmr=stack.Kmr.transpose(2, 3).contiguous().transpose(2, 3)[:, :16])
        )


@pytest.mark.cuda
def test_batched_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    X, d = _inputs(B=3, c=1024, p=16, s=28, seed=5)
    Xt = torch.from_numpy(X).cuda()
    params = params_from_numpy(d, "cuda")
    before = ci.launches
    out = ci.integrate_signals_cuda(Xt, params)
    torch.cuda.synchronize()
    assert ci.launches == before + 1
    ref = ci.integrate_signals_tiled(Xt, params, ci.TILE_C)
    _fast_contract(out.cpu().numpy(), ref.cpu().numpy())
    for w in range(3):
        solo = ci.integrate_signals_cuda(
            Xt[w : w + 1], CellParams(*(t[w : w + 1] for t in params))
        )
        assert torch.equal(solo[0], out[w])
