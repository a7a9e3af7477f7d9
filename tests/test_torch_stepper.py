"""
The port's pipelined stepper against the JAX package's:

- the packed step record: ``record_length`` and the bit packing equal the
  JAX package's;
- deterministic mode at a fixed lag: from one seed, on a 16x16 map with
  20 cells of 300-bp genomes and selection on, ``megastep`` 1 and 4 with
  ``overlap_evolution`` on and off, the two steppers end (after several
  dispatches and ``flush()``) with equal structure — cell count,
  positions, genomes, labels, lifetimes, divisions, the ``stats``
  counters — and bit-equal ``cell_molecules`` and ``molecule_map``;
- fast mode from matched state (the JAX stepper's device state carried in
  through ``interop``): equal structure, molecules under the fast
  contract;
- through a capacity growth (drain, flush, double, re-attach) too;
- the sentinel policies on a poisoned cell: warn counts, quarantine
  kills it at the next host boundary, rollback raises;
- token worlds (``genome_backend="token"``) at ``megastep`` 1 and 4, det
  mode: bit-equal to the JAX stepper over a token world, the stores'
  tensors included;
- ``World.step_many`` equals the serial calls, and what is not ported
  (meshes, cross-rung fusion) raises.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import random  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu import stepper as jstepper  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu_torch import stepper as tstepper  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.interop import device_state_from_numpy, load_world_arrays  # noqa: E402

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

# the counters that follow from the trajectory (the rest are timings)
STAT_KEYS = (
    "steps", "replayed", "compactions", "growths", "divisions",
    "division_drops", "division_blocked", "kills", "spawned", "spawn_drops",
    "pushes", "genome_changes", "sentinel_trips", "invariant_trips",
)


def _world(lib, chem, seed: int, grow: bool = False, **kw):
    w = lib.World(chemistry=chem, map_size=16, seed=seed, **kw)
    rng = random.Random(seed)
    w.spawn_cells([lib.random_genome(s=300, rng=rng) for _ in range(20)])
    if not grow:
        # room from the start: no capacity growth mid-run
        w._ensure_capacity(100)
    return w


def _assert_same_world(jw, tw) -> None:
    assert jw.n_cells == tw.n_cells > 0
    assert np.array_equal(jw.cell_positions, tw.cell_positions)
    assert jw.cell_genomes == tw.cell_genomes
    assert jw.cell_labels == tw.cell_labels
    assert np.array_equal(jw.cell_lifetimes, tw.cell_lifetimes)
    assert np.array_equal(jw.cell_divisions, tw.cell_divisions)
    assert np.array_equal(jw.cell_map, tw.cell_map)


@pytest.mark.parametrize("cap,md,sb", [(64, 64, 16), (128, 2048, 1024), (16384, 2048, 1024)])
def test_record_layout_matches_jax(cap, md, sb):
    assert tstepper.record_length(cap, md, sb) == jstepper.record_length(cap, md, sb)


def test_bit_packing_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 16, 37, 128):
        b = rng.random(n) < 0.5
        ref = np.asarray(jstepper._pack_bits(jnp.asarray(b)))
        out = tstepper._pack_bits(tstepper.to_device(b[None], "cpu"))[0].numpy()
        assert np.array_equal(ref, out)
        assert np.array_equal(tstepper._unpack_bits(out, n), b)


@pytest.mark.parametrize(
    "megastep,overlap,dispatches", [(1, True, 6), (1, False, 6), (4, True, 3), (4, False, 3)]
)
def test_det_stepper_matches_jax(monkeypatch, megastep, overlap, dispatches):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    jw = _world(ms, JCHEM, 3)
    tw = _world(mt, TCHEM, 3, device="cpu")
    assert (jw.integrator, tw.integrator) == ("xla-det", "torch-det")
    kw = dict(KW, megastep=megastep, overlap_evolution=overlap)
    js = ms.PipelinedStepper(jw, **kw)
    ts = mt.PipelinedStepper(tw, **kw)
    for _ in range(dispatches):
        js.step()
        ts.step()
    ts.drain()
    ts.check_consistency()
    js.flush()
    ts.flush()
    assert {k: ts.stats[k] for k in STAT_KEYS} == {k: js.stats[k] for k in STAT_KEYS}
    assert ts.stats["steps"] == megastep * dispatches
    assert ts.stats["divisions"] > 0 and ts.stats["kills"] > 0
    assert ts.stats["spawned"] > 0 and ts.stats["compactions"] > 0
    _assert_same_world(jw, tw)
    assert np.array_equal(np.asarray(jw.cell_molecules), tw.cell_molecules)
    assert np.array_equal(np.asarray(jw.molecule_map), tw.molecule_map.numpy())


def test_det_stepper_matches_jax_through_capacity_growth(monkeypatch):
    # 20 cells at capacity 64 crowd it at once: the first dispatch drains,
    # flushes, doubles the capacity and re-attaches
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    jw = _world(ms, JCHEM, 3, grow=True)
    tw = _world(mt, TCHEM, 3, grow=True, device="cpu")
    assert jw._capacity == tw._capacity == 64
    js = ms.PipelinedStepper(jw, **KW)
    ts = mt.PipelinedStepper(tw, **KW)
    for _ in range(4):
        js.step()
        ts.step()
    js.flush()
    ts.flush()
    assert ts.stats["growths"] == js.stats["growths"] >= 1
    assert {k: ts.stats[k] for k in STAT_KEYS} == {k: js.stats[k] for k in STAT_KEYS}
    assert tw._capacity == jw._capacity == 128
    _assert_same_world(jw, tw)
    assert np.array_equal(np.asarray(jw.cell_molecules), tw.cell_molecules)
    assert np.array_equal(np.asarray(jw.molecule_map), tw.molecule_map.numpy())


@pytest.mark.parametrize("megastep,dispatches", [(1, 12), (4, 3)])
def test_det_token_stepper_matches_jax(monkeypatch, megastep, dispatches):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    jw = _world(ms, JCHEM, 3, genome_backend="token")
    tw = _world(mt, TCHEM, 3, device="cpu", genome_backend="token")
    kw = dict(KW, megastep=megastep)
    js = ms.PipelinedStepper(jw, **kw)
    ts = mt.PipelinedStepper(tw, **kw)
    assert ts._evo_worker is None and ts._genomes is None  # evolution inline
    for _ in range(dispatches):
        js.step()
        ts.step()
    ts.drain()
    ts.check_consistency()
    js.flush()
    ts.flush()
    assert {k: ts.stats[k] for k in STAT_KEYS} == {k: js.stats[k] for k in STAT_KEYS}
    assert ts.stats["genome_changes"] > 0 and ts.stats["compactions"] > 0
    assert ts.stats["divisions"] > 0 and ts.stats["spawned"] > 0
    _assert_same_world(jw, tw)
    assert np.array_equal(np.asarray(jw.cell_molecules), tw.cell_molecules)
    assert np.array_equal(np.asarray(jw.molecule_map), tw.molecule_map.numpy())
    jstore, tstore = jw.genome_store, tw.genome_store
    assert np.array_equal(np.asarray(jstore.tokens), tstore.tokens.numpy())
    assert np.array_equal(np.asarray(jstore.lengths), tstore.lengths.numpy())
    n = tw.n_cells
    for name, t in tw.kinetics.params._asdict().items():
        assert np.array_equal(np.asarray(getattr(jw.kinetics.params, name))[:n], t[:n].numpy())


@pytest.mark.parametrize("policy", ["warn", "quarantine", "rollback"])
def test_sentinel_policies_on_a_poisoned_cell(monkeypatch, policy):
    from magicsoup_tpu_torch.guard.errors import SentinelTripped

    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    w = _world(mt, TCHEM, 9, device="cpu")
    st = mt.PipelinedStepper(w, **dict(KW, lag=1, sentinel_policy=policy))
    st.step()
    st.drain()
    # poison one live row on the device, as a diverged integrator would
    st._state.cm[0, 0, 3] = float("nan")
    if policy == "rollback":
        with pytest.raises(SentinelTripped, match="cm_nonfinite"):
            st.step()
            st.drain()
        return
    if policy == "warn":
        # counted and warned about once; the state is left as it is
        with pytest.warns(UserWarning, match="health sentinel"):
            st.step()
            st.drain()
        assert st.stats["sentinel_trips"] >= 1
        st.flush()
        assert not np.isfinite(w.cell_molecules).all()
        return
    st.step()
    st.drain()
    st.step()  # the quarantine runs at the next host boundary
    st.drain()
    assert st.stats["sentinel_trips"] >= 1 and st.stats["quarantined"] >= 1
    st.flush()
    assert np.isfinite(w.cell_molecules).all()


def _fast_contract(out: np.ndarray, ref: np.ndarray) -> None:
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    assert rel.max() < 0.15, rel.max()


def test_fast_stepper_from_matched_state(monkeypatch):
    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    jw = _world(ms, JCHEM, 5)
    tw = mt.World(chemistry=TCHEM, map_size=16, seed=6, device="cpu")
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
    tw._ensure_capacity(100)
    assert (jw.integrator, tw.integrator) == ("xla-fast", "torch-fast")
    assert tw._capacity == jw._capacity
    # no spawns and no evolution: those draw from each world's own seed
    kw = dict(KW, target_cells=None, p_mutation=0.0, p_recombination=0.0, lag=1)
    js = ms.PipelinedStepper(jw, **kw)
    ts = mt.PipelinedStepper(tw, **kw)
    ts._state = device_state_from_numpy(
        {f: np.asarray(getattr(js._state, f)) for f in tstepper.DeviceState._fields}, "cpu"
    )
    for _ in range(2):
        js.step()
        ts.step()
    js.flush()
    ts.flush()
    assert {k: ts.stats[k] for k in STAT_KEYS} == {k: js.stats[k] for k in STAT_KEYS}
    assert ts.stats["divisions"] > 0
    _assert_same_world(jw, tw)
    _fast_contract(tw.cell_molecules, np.asarray(jw.cell_molecules))
    _fast_contract(tw.molecule_map.numpy(), np.asarray(jw.molecule_map))


def test_token_flush_drops_refreshes_of_blanked_rows(monkeypatch):
    # two dispatches at megastep 4: refreshes are queued for rows that
    # die next and that the point-mutation program blanks (PAD tokens
    # beside the old length, ROADMAP C2); the JAX stepper's flush
    # decodes them and fails (ROADMAP C6), the port's drops them
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    from magicsoup_tpu_torch.check import audit_world

    kw = dict(KW, megastep=4)
    jw = _world(ms, JCHEM, 3, genome_backend="token")
    tw = _world(mt, TCHEM, 3, genome_backend="token", device="cpu")
    js = ms.PipelinedStepper(jw, **kw)
    ts = mt.PipelinedStepper(tw, **kw)
    for _ in range(2):
        js.step()
        ts.step()
    with pytest.raises(IndexError):
        js.flush()
    dropped = []
    drop = ts._drop_blanked
    ts._drop_blanked = lambda rows: (dropped.append(len(rows) - len(drop(rows))), drop(rows))[1]
    ts.flush()
    assert sum(dropped) > 0
    assert audit_world(tw) == []
    for _ in range(2):
        ts.step()
    ts.flush()
    ts.check_consistency()
    assert audit_world(tw) == []


def test_world_step_many_matches_serial_calls(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    fused, serial = (_world(mt, TCHEM, 13, device="cpu") for _ in range(2))
    fused.step_many(3)
    for _ in range(3):
        serial.enzymatic_activity()
        serial.degrade_and_diffuse_molecules()
        serial.increment_cell_lifetimes()
    assert np.array_equal(fused.molecule_map.numpy(), serial.molecule_map.numpy())
    assert np.array_equal(fused.cell_molecules, serial.cell_molecules)
    assert np.array_equal(fused.cell_lifetimes, serial.cell_lifetimes)
    with pytest.raises(ValueError, match="n_steps"):
        fused.step_many(0)


def test_what_is_not_ported_raises():
    w = _world(mt, TCHEM, 1, device="cpu")
    # dispatch retries and the recorder are ported now: a bad retry count
    # is refused, a world's recorder is shared
    with pytest.raises(ValueError, match="dispatch_retries"):
        mt.PipelinedStepper(w, dispatch_retries=-1)
    assert mt.PipelinedStepper(w, dispatch_retries=1).telemetry is w.telemetry
    with pytest.raises(ValueError, match="megastep"):
        mt.PipelinedStepper(w, megastep=0)
    w._mesh = object()
    with pytest.raises(ValueError, match="mesh"):
        mt.PipelinedStepper(w)
    del w._mesh
    # cross-rung fusion is ported: both modes are accepted, bad settings refused
    for fusion in ("fleet", "auto"):
        assert mt.FleetScheduler(fusion=fusion).fusion == fusion
    with pytest.raises(ValueError, match="fusion must be"):
        mt.FleetScheduler(fusion="rungs")
    with pytest.raises(ValueError, match="fusion_waste"):
        mt.FleetScheduler(fusion="auto", fusion_waste=1.0)
