"""
The port's cross-rung fused fleet dispatch against the JAX package's and
against solo steppers, in deterministic mode unless stated:

- a two-rung fused fleet (``fusion="fleet"``, B = 4 worlds on 16x16 and
  32x32 maps): each world bit-equal to its solo run and to
  ``magicsoup_tpu.fleet.FleetScheduler(fusion="fleet")`` on the same
  worlds; one dispatch carrying two groups per megastep, one integrator
  dispatch, one physical record fetch through the fetcher and one grouped
  integrator call per simulated step; the dispatch rows' fused tags;
- ``fusion="auto"`` forms the JAX planner's sets for the same rungs and
  ``fusion_waste``; the envelope is grow-only and a warm rung's free slot
  admits without a new group;
- a transient dispatch fault under fusion is retried with the fault-free
  bits;
- the grouped integrator wrapper on the CPU: per group the kernel's plain
  version, bit for bit, with no kernel launch; the backend plane's
  grouped call equal to each group's own call.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu.fleet import FleetScheduler as JFleet  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.guard import chaos  # noqa: E402
from magicsoup_tpu_torch.interop import params_from_numpy  # noqa: E402
from magicsoup_tpu_torch.ops import backends  # noqa: E402
from magicsoup_tpu_torch.ops import cuda_integrate as ci  # noqa: E402
from magicsoup_tpu_torch.ops.integrate import CellParams  # noqa: E402
from magicsoup_tpu_torch.telemetry import validate_rows  # noqa: E402
from magicsoup_tpu_torch.telemetry.recorder import fetch_stats  # noqa: E402

#: the full selection workload (spawn, kill, divide, evolution)
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
#: chemistry only: no kill, divide or spawn, so every rung keeps its shape
CHEM_KW = dict(
    mol_name="ATP",
    kill_below=-1.0,
    divide_above=1e30,
    divide_cost=0.0,
    target_cells=None,
    genome_size=300,
    lag=1,
    max_divisions=64,
    spawn_block=16,
    p_mutation=0.0,
    p_recombination=0.0,
    megastep=2,
)
#: (seed, map size): two worlds on each of two capacity rungs
SPEC = ((7, 16), (11, 16), (17, 32), (23, 32))


@pytest.fixture
def det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")


def _world(lib, chem, seed: int, map_size: int = 16, n_cells: int = 20, **kw):
    w = lib.World(chemistry=chem, map_size=map_size, seed=seed, **kw)
    rng = random.Random(seed)
    w.spawn_cells([lib.random_genome(s=300, rng=rng) for _ in range(n_cells)])
    w._ensure_capacity(100 if map_size == 16 else 200)
    return w


def _tworld(seed: int, map_size: int = 16, **kw):
    return _world(mt, TCHEM, seed, map_size, device="cpu", **kw)


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


class _CountGrouped:
    """Counts the fused program's grouped integrator calls."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = backends.integrate_grouped

        def counted(names, Xs, params_list):
            self.calls.append(tuple(names))
            return inner(names, Xs, params_list)

        monkeypatch.setattr(backends, "integrate_grouped", counted)


def test_two_rung_fused_fleet_matches_solo_and_the_jax_fleet(det, monkeypatch):
    n = 4
    jf, tf = JFleet(block=2, fusion="fleet"), mt.FleetScheduler(block=2, fusion="fleet")
    jws = [_world(ms, JCHEM, s, m) for s, m in SPEC]
    tws = [_tworld(s, m) for s, m in SPEC]
    for jw, tw in zip(jws, tws):
        jf.admit(jw, **KW)
        tf.admit(tw, **KW)
    grouped = _CountGrouped(monkeypatch)
    runtime.reset_counters()
    for _ in range(n):
        jf.step()
        tf.step()
    census = runtime.snapshot()
    assert len(tf._groups) == 2
    assert {k: census[k] for k in ("dispatches", "fused_groups",
                                   "integrator_dispatches_torch-det")} == {
        "dispatches": n, "fused_groups": 2 * n, "integrator_dispatches_torch-det": n}
    # one grouped integrator call per simulated step, over both rungs
    assert grouped.calls == [("torch-det", "torch-det")] * n
    jf.flush()
    tf.flush()
    assert sum(lane.stats["divisions"] for lane in tf.lanes) > 0
    assert sum(lane.stats["spawned"] for lane in tf.lanes) > 0
    for (s, m), jw, tw in zip(SPEC, jws, tws):
        _assert_same(jw, tw)
        solo = _tworld(s, m)
        st = mt.PipelinedStepper(solo, **KW)
        for _ in range(n):
            st.step()
        st.flush()
        _assert_same(solo, tw)


def test_one_dispatch_one_fetch_per_megastep_and_fused_tags(det, monkeypatch, tmp_path):
    fleet = mt.FleetScheduler(block=2, fusion="fleet")
    lanes = [fleet.admit(_tworld(s, m), **CHEM_KW) for s, m in SPEC]
    fleet.step()
    fleet.drain()
    grouped = _CountGrouped(monkeypatch)
    path = tmp_path / "fused.jsonl"
    lanes[2].telemetry.attach(path)
    before = fetch_stats()["fetches"]
    runtime.reset_counters()
    for _ in range(3):
        fleet.step()
    fleet.drain()
    lanes[2].telemetry.flush()
    lanes[2].telemetry.detach()
    # ONE physical fetch per megastep, through the shared fetcher
    assert fetch_stats()["fetches"] - before == 3
    census = runtime.snapshot()
    assert (census["dispatches"], census["fused_groups"]) == (3, 6)
    assert len(grouped.calls) == 3 * CHEM_KW["megastep"]
    rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    assert validate_rows(rows) == []
    dispatch = [r for r in rows if r.get("type") == "dispatch"]
    assert len(dispatch) == 3
    for row in dispatch:
        assert row["fused_groups"] == 2 and row["fleet_size"] == 2
        assert row["envelope"] == [fleet._env_k, fleet._env_rec]
        assert row["envelope"][0] == CHEM_KW["megastep"]
    assert lanes[2]._guard_row_extra()["fused_groups"] == 2
    fleet.flush()
    for lane in lanes:
        assert np.isfinite(np.asarray(lane.world.cell_molecules)).all()


def _planned(fleet) -> list:
    """The fusion planner's sets over the placed groups, as the worlds'
    admission indices."""
    fleet._place()
    live = [g for sib in fleet._groups.values() for g in sib if g.members()]
    index = {id(lane): i for i, lane in enumerate(fleet.lanes)}
    return sorted(
        sorted(index[id(lane)] for g in s for _, lane in g.members())
        for s in fleet._plan_fusion(live)
    )


@pytest.mark.parametrize("waste", [0.0, 0.3, 0.6, 0.9])
def test_auto_forms_the_jax_planners_sets(det, waste):
    # four rungs of different record footprints (k L): megastep and the
    # division and spawn budgets set the record, the map the capacity
    worlds = [
        (3, 16, dict(megastep=1)),
        (5, 16, dict(megastep=4)),
        (9, 32, dict(megastep=2)),
        (13, 32, dict(megastep=4, max_divisions=16, spawn_block=8)),
    ]
    jf = JFleet(block=2, fusion="auto", fusion_waste=waste)
    tf = mt.FleetScheduler(block=2, fusion="auto", fusion_waste=waste)
    for seed, m, kw in worlds:
        jf.admit(_world(ms, JCHEM, seed, m, n_cells=4), **dict(CHEM_KW, **kw))
        tf.admit(_tworld(seed, m, n_cells=4), **dict(CHEM_KW, **kw))
    want = _planned(jf)
    assert _planned(tf) == want
    # from every rung alone to the whole fleet as one set
    assert len(want) == {0.0: 4, 0.3: 4, 0.6: 2, 0.9: 1}[waste]


def test_envelope_is_grow_only_and_warm_admission_opens_no_group(det):
    fleet = mt.FleetScheduler(block=2, fusion="fleet")
    for s, m in ((7, 16), (11, 16), (17, 32)):
        fleet.admit(_tworld(s, m, n_cells=4), **CHEM_KW)
    fleet.step()
    env = (fleet._env_k, fleet._env_rec)
    groups = [g for sib in fleet._groups.values() for g in sib]
    # the 32x32 rung's free slot takes the next world of that rung
    lane = fleet.admit(_tworld(21, 32, n_cells=4), **CHEM_KW)
    fleet.step()
    assert [g for sib in fleet._groups.values() for g in sib] == groups
    assert lane._fleet_slot[0] is groups[1] and (fleet._env_k, fleet._env_rec) == env
    # a longer record widens the envelope; retiring it does not shrink it
    big = fleet.admit(_tworld(29, 32, n_cells=4), **dict(CHEM_KW, megastep=4))
    fleet.step()
    grown = (fleet._env_k, fleet._env_rec)
    assert grown[0] == 4 and grown[1] == env[1]
    fleet.retire(big)
    fleet.step()
    assert (fleet._env_k, fleet._env_rec) == grown
    fleet.flush()


def test_a_transient_fault_under_fusion_is_retried_with_the_same_bits(det):
    def run(spec):
        fleet = mt.FleetScheduler(block=2, fusion="fleet")
        ws = [_tworld(s, m) for s, m in SPEC]
        lanes = [fleet.admit(w, dispatch_retries=2, **KW) for w in ws]
        if spec:
            chaos.arm(spec)
        try:
            for _ in range(3):
                fleet.step()
        finally:
            chaos.disarm()
        fleet.flush()
        return ws, lanes

    clean, _ = run(None)
    faulty, lanes = run("dispatch:transient@1x1")
    assert lanes[0].stats["dispatch_retries"] == 1
    for a, b in zip(clean, faulty):
        _assert_same(a, b)


def test_fusion_settings_are_checked():
    with pytest.raises(ValueError, match="fusion must be"):
        mt.FleetScheduler(fusion="rungs")
    for waste in (-0.1, 1.0):
        with pytest.raises(ValueError, match="fusion_waste"):
            mt.FleetScheduler(fusion="auto", fusion_waste=waste)
    assert mt.FleetScheduler(fusion="auto", fusion_waste=0.25).fusion_waste == 0.25


def _group(B: int, c: int, p: int, s: int, seed: int, stride: int | None = None):
    rng = np.random.default_rng(seed)
    rows = stride or c
    d = dict(
        Ke=rng.uniform(0.1, 10, (B, rows, p)).astype(np.float32),
        Kmf=rng.uniform(0.1, 10, (B, rows, p)).astype(np.float32),
        Kmb=rng.uniform(0.1, 10, (B, rows, p)).astype(np.float32),
        Kmr=rng.uniform(0.1, 10, (B, rows, p, s)).astype(np.float32),
        Vmax=(30 * rng.uniform(0, 2, (B, rows, p))).astype(np.float32),
        N=rng.integers(-2, 3, (B, rows, p, s)).astype(np.int16),
        Nf=rng.integers(0, 3, (B, rows, p, s)).astype(np.int16),
        Nb=rng.integers(0, 3, (B, rows, p, s)).astype(np.int16),
        A=rng.integers(-2, 3, (B, rows, p, s)).astype(np.int16),
    )
    X = torch.from_numpy(rng.uniform(0, 4, (B, c, s)).astype(np.float32))
    params = params_from_numpy(d, "cpu")
    return X, CellParams(*(t[:, :c] for t in params))


def test_grouped_wrapper_on_the_cpu_is_the_plain_version_per_group():
    groups = [_group(2, 24, 8, 12, 0, stride=40), _group(1, 16, 32, 28, 1), _group(3, 8, 5, 7, 2)]
    before = (ci.launches, ci.grouped_launches)
    outs = ci.integrate_signals_cuda_grouped([X for X, _ in groups], [p for _, p in groups])
    assert (ci.launches, ci.grouped_launches) == before  # CPU tensors launch nothing
    for (X, params), out in zip(groups, outs):
        assert torch.equal(out, ci.integrate_signals_tiled(X, params, ci.TILE_C))
        for w in range(X.shape[0]):
            one = ci.integrate_signals_cuda(X[w : w + 1], CellParams(*(t[w : w + 1] for t in params)))
            assert torch.equal(one[0], out[w])
    names = ["cuda", "torch-det", "torch-fast"]
    got = backends.integrate_grouped(names, [X for X, _ in groups], [p for _, p in groups])
    for name, (X, params), out in zip(names, groups, got):
        assert torch.equal(out, backends.integrate(name, X, params))
    assert ci.integrate_signals_cuda_grouped([], []) == []
    with pytest.raises(ValueError, match="tile"):
        X, params = _group(1, 12, 4, 6, 3)
        ci.integrate_signals_cuda_grouped([X], [params])


@pytest.mark.cuda
def test_grouped_kernel_equals_each_groups_own_launch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    groups = [_group(2, 1024, 32, 28, 0, stride=1280), _group(1, 512, 64, 82, 1)]
    groups = [(X.cuda(), CellParams(*(t.cuda() for t in p))) for X, p in groups]
    before = ci.grouped_launches
    outs = ci.integrate_signals_cuda_grouped([X for X, _ in groups], [p for _, p in groups])
    torch.cuda.synchronize()
    assert ci.grouped_launches - before == 2  # the resident route and another
    for (X, params), out in zip(groups, outs):
        assert torch.equal(out, ci.integrate_signals_cuda(X, params))
