"""
The port's runtime guard (:mod:`magicsoup_tpu_torch.analysis.runtime`:
``hot_path_guard``, ``GuardStats``, ``CompileBudgetExceeded``,
``sanctioned_transfer``) against the JAX package's on the same seeded
inputs:

- the compile budget: a world's first activity at a new rung exceeds a
  budget of 0 on both sides, a warmed window compiles 0;
- steady states pass ``hot_path_guard(0)`` with 0 compiles on both sides,
  and (deterministic mode) end in equal ``state_digest``s: the stepper of
  tests/fast/test_graftlint.py, the same with a recorder attached
  (tests/fast/test_telemetry.py), the fleet and the fused fleet
  (tests/fast/test_fleet.py);
- the transfer half's state machine (``torch.cuda.set_sync_debug_mode``
  is process-wide): guard modes stack and restore, also on an exception;
  ``fetch_host`` (and the token store's pinned snapshot) lifts the mode
  for its own copy, counted across threads;
  a mode changed under the window is reported.  On the CPU torch's sync
  debug mode is inert, so these run against a stand-in of its two calls;
- on a card (``cuda``-marked, skipped here): ``.item()`` inside a window
  raises, ``fetch_host`` passes, and ``.item()`` raises while the
  stepper's fetcher thread runs.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import random  # noqa: E402
import threading  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu.analysis import runtime as jrt  # noqa: E402
from magicsoup_tpu.check.differential import state_digest as jdigest  # noqa: E402
from magicsoup_tpu.fleet import FleetScheduler as JFleet  # noqa: E402
from magicsoup_tpu.stepper import PipelinedStepper as JStepper  # noqa: E402
from magicsoup_tpu_torch import util  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime as rt  # noqa: E402
from magicsoup_tpu_torch.check.differential import state_digest as tdigest  # noqa: E402


@pytest.fixture
def det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")


def _chem(lib, tag: str):
    mols = [lib.Molecule(f"{tag}-a", 10e3), lib.Molecule(f"{tag}-atp", 8e3, half_life=100_000)]
    return lib.Chemistry(molecules=mols, reactions=[([mols[0]], [mols[1]])])


#: one chemistry per scenario and side: a program shape of this file is
#: never one another test file of the same process warmed
CHEMS = {
    (lib.__name__, tag): _chem(lib, tag)
    for lib in (ms, mt)
    for tag in ("hpg-rung", "hpg-st", "hpg-tel", "hpg-fl", "hpg-fu")
}


def _world(lib, tag: str, seed: int, *, map_size=32, n_cells=40, genome_rng=None, **kw):
    if lib is mt:
        kw.setdefault("device", "cpu")
    w = lib.World(chemistry=CHEMS[(lib.__name__, tag)], map_size=map_size, seed=seed, **kw)
    rng = random.Random(seed if genome_rng is None else genome_rng)
    w.spawn_cells([lib.random_genome(s=250, rng=rng) for _ in range(n_cells)])
    return w


def _kw(tag: str, **kw) -> dict:
    cfg = dict(
        mol_name=f"{tag}-atp",
        kill_below=-1.0,  # nothing dies
        divide_above=1e30,  # nothing divides
        divide_cost=0.0,
        target_cells=None,  # nothing spawns
        genome_size=250,
        lag=2,
        p_mutation=0.0,
        p_recombination=0.0,
    )
    cfg.update(kw)
    return cfg


# ------------------------------------------------------ compile half
def test_first_activity_at_a_new_rung_exceeds_a_zero_budget():
    jw, tw = _world(ms, "hpg-rung", 5), _world(mt, "hpg-rung", 5)
    with pytest.raises(jrt.CompileBudgetExceeded, match="budget is 0"):
        with jrt.hot_path_guard(compile_budget=0, transfers="allow"):
            jw.enzymatic_activity()
    with pytest.raises(rt.CompileBudgetExceeded, match="budget is 0") as err:
        with rt.hot_path_guard(compile_budget=0):
            tw.enzymatic_activity()
    assert isinstance(err.value, AssertionError)
    assert "compiled 1 program(s)" in str(err.value)
    # warmed: the same rung again compiles nothing on either side
    with jrt.hot_path_guard(compile_budget=0, transfers="allow") as jstats:
        jw.enzymatic_activity()
    with rt.hot_path_guard(compile_budget=0) as stats:
        tw.enzymatic_activity()
    assert isinstance(stats, rt.GuardStats)
    assert stats.compiles == jstats.compiles == 0
    # a budget admits what it pins
    w2 = _world(mt, "hpg-rung", 6, n_cells=200)
    with rt.hot_path_guard(compile_budget=1) as stats:
        w2.enzymatic_activity()
    assert stats.compiles == 1


def test_stepper_steady_state_under_hot_path_guard(det):
    # the flagship contract (tests/fast/test_graftlint.py): after warm-up,
    # the pipelined steady state (no deaths, divisions, spawns or
    # mutations) dispatches with ZERO new compiles on both sides
    runs = {}
    for lib, Stepper, guard in ((ms, JStepper, jrt), (mt, mt.PipelinedStepper, rt)):
        world = _world(lib, "hpg-st", 11)
        st = Stepper(world, **_kw("hpg-st"))
        for _ in range(8):  # warm every variant the window will use
            st.step()
        st.drain()
        with guard.hot_path_guard(compile_budget=0) as stats:
            for _ in range(5):
                st.step()
            st.drain()
        st.flush()
        runs[lib] = (stats.compiles, world)
    assert runs[ms][0] == runs[mt][0] == 0
    assert tdigest(runs[mt][1]) == jdigest(runs[ms][1])


def test_steady_state_with_telemetry_passes_hot_path_guard(det, tmp_path):
    from magicsoup_tpu_torch.telemetry import read_jsonl

    runs = {}
    for lib, Stepper, guard in ((ms, JStepper, jrt), (mt, mt.PipelinedStepper, rt)):
        path = tmp_path / f"{lib.__name__}.jsonl"
        world = _world(lib, "hpg-tel", 11, telemetry=path)
        st = Stepper(world, **_kw("hpg-tel"))
        for _ in range(8):
            st.step()
        st.drain()
        with guard.hot_path_guard(compile_budget=0) as stats:
            for _ in range(5):
                st.step()
            st.drain()
        st.flush()
        runs[lib] = (stats.compiles, world, read_jsonl(path))
    assert runs[ms][0] == runs[mt][0] == 0
    assert tdigest(runs[mt][1]) == jdigest(runs[ms][1])
    for lib in (ms, mt):
        assert sum(r["type"] == "step" for r in runs[lib][2]) == 13


_FLEET_KW = dict(lag=1, megastep=2, genome_size=200)


@pytest.mark.parametrize(
    "fusion, worlds",
    [("rung", ((7, 16), (11, 16))), ("fleet", ((7, 16), (11, 16), (17, 32)))],
    ids=["fleet", "fused_fleet"],
)
def test_fleet_steady_state_passes_hot_path_guard(det, fusion, worlds):
    # tests/fast/test_fleet.py's warm chemistry-only fleet (block 4) and
    # mixed-rung fused fleet (block 2, fusion="fleet"): once warm, two
    # fleet steps and a drain compile nothing
    tag = "hpg-fl" if fusion == "rung" else "hpg-fu"
    block = 4 if fusion == "rung" else 2
    runs = {}
    for lib, Fleet, guard in ((ms, JFleet, jrt), (mt, mt.FleetScheduler, rt)):
        fleet = Fleet(block=block, fusion=fusion)
        members = []
        for s, m in worlds:
            w = _world(lib, tag, s, map_size=m, n_cells=24, genome_rng=99)
            members.append(w)
            fleet.admit(w, **_kw(tag, **_FLEET_KW))
        for _ in range(4):
            fleet.step()
        fleet.drain()
        with guard.hot_path_guard(compile_budget=0) as stats:
            fleet.step()
            fleet.step()
            fleet.drain()
        fleet.flush()
        runs[lib] = (stats.compiles, [tdigest(w) if lib is mt else jdigest(w) for w in members])
    assert runs[ms][0] == runs[mt][0] == 0
    assert runs[mt][1] == runs[ms][1]


# ----------------------------------------------------- transfer half
class _FakeSyncMode:
    """A stand-in for torch's two sync-debug-mode calls on a card."""

    def __init__(self):
        self.mode = 0
        self.sets = []

    def get(self):
        return self.mode

    def set(self, mode):
        mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.mode = mode
        self.sets.append(mode)


@pytest.fixture
def fake_card(monkeypatch):
    fake = _FakeSyncMode()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    yield fake
    assert util._sync_frames == [] and util._sync_lifted == 0


@pytest.mark.parametrize("transfers, mode", [("disallow", 2), ("log", 1), ("allow", 0)])
def test_transfers_map_onto_sync_debug_mode(fake_card, transfers, mode):
    with rt.hot_path_guard(compile_budget=0, transfers=transfers):
        assert fake_card.mode == mode
    assert fake_card.mode == 0


def test_guard_restores_the_mode_it_found_also_on_an_exception(fake_card):
    fake_card.mode = 1  # a caller's own "warn"
    with pytest.raises(KeyError, match="boom"):
        with rt.hot_path_guard(compile_budget=0):
            assert fake_card.mode == 2
            with rt.hot_path_guard(compile_budget=0, transfers="allow"):
                assert fake_card.mode == 2  # allow keeps the outer mode
            raise KeyError("boom")
    assert fake_card.mode == 1
    with pytest.raises(ValueError, match="transfers"):
        with rt.hot_path_guard(transfers="sometimes"):
            pass


def test_fetch_host_lifts_the_mode_for_its_own_copy(fake_card, monkeypatch):
    seen = []
    real = torch.Tensor.cpu

    def spy(self, *a, **k):
        seen.append(fake_card.mode)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    x = torch.arange(6, dtype=torch.float32)
    with rt.hot_path_guard(compile_budget=0):
        host = util.fetch_host(x)
        again = rt.sanctioned_transfer(x)
        assert fake_card.mode == 2
    assert seen == [0, 0]
    assert isinstance(host, np.ndarray) and np.array_equal(host, again)
    util.fetch_host(x)  # no guard open: nothing lifted
    assert seen == [0, 0, 0] and fake_card.sets == [2, 0, 2, 0, 2, 0]


def test_lifts_on_two_threads_restore_the_guard_mode_once(fake_card, monkeypatch):
    # a fetcher thread's copy in flight while the main thread fetches too:
    # the mode stays lifted until the LAST copy ends, then is the guard's
    inside, release = threading.Event(), threading.Event()
    real = torch.Tensor.cpu

    def slow(self, *a, **k):
        if threading.current_thread().name == "fetcher":
            inside.set()
            release.wait(10)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", slow)
    x = torch.ones(3)
    with rt.hot_path_guard(compile_budget=0):
        t = threading.Thread(target=util.fetch_host, args=(x,), name="fetcher")
        t.start()
        assert inside.wait(10)
        util.fetch_host(x)
        assert fake_card.mode == 0  # the fetcher's copy is still in flight
        release.set()
        t.join(10)
        assert fake_card.mode == 2


def test_a_guard_closing_while_a_fetch_is_in_flight(fake_card, monkeypatch):
    # the copy outlives the window: the mode after it is the one found
    inside, release = threading.Event(), threading.Event()
    real = torch.Tensor.cpu

    def slow(self, *a, **k):
        inside.set()
        release.wait(10)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", slow)
    t = None
    with rt.hot_path_guard(compile_budget=0):
        t = threading.Thread(target=util.fetch_host, args=(torch.ones(2),))
        t.start()
        assert inside.wait(10)
    assert fake_card.mode == 0
    release.set()
    t.join(10)
    assert fake_card.mode == 0 and util._sync_lifted == 0


def test_a_mode_changed_inside_the_window_is_reported(fake_card):
    with pytest.raises(AssertionError, match="sync debug mode changed"):
        with rt.hot_path_guard(compile_budget=0):
            torch.cuda.set_sync_debug_mode(0)
    assert fake_card.mode == 0


def test_transfer_half_is_inert_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only reading")
    x = torch.arange(4.0)
    with rt.hot_path_guard(compile_budget=0) as stats:
        host = rt.sanctioned_transfer(x)
        assert host.tolist() == [0.0, 1.0, 2.0, 3.0]
        assert x.sum().item() == 6.0  # no CUDA sync to see on the CPU
    assert stats.compiles == 0
    assert util._sync_frames == []


# ------------------------------------------------------------ on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch's sync debug mode only sees CUDA syncs")


@pytest.mark.cuda
def test_item_inside_a_window_raises_and_fetch_host_passes():
    from magicsoup_tpu_torch.genomes import _download

    _card()
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    with rt.hot_path_guard(compile_budget=100):
        with pytest.raises(RuntimeError, match="synchroniz"):
            x.sum().item()
        host = util.fetch_host(x)
        pinned = _download(x)  # the token store's sanctioned snapshot
    assert host.sum() == 28.0 and np.array_equal(host, pinned)
    assert torch.cuda.get_sync_debug_mode() == 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with rt.hot_path_guard(compile_budget=100, transfers="log"):
            x.sum().item()
    assert any("synchroniz" in str(w.message) for w in caught)


@pytest.mark.cuda
def test_item_raises_while_the_steppers_fetcher_runs():
    _card()
    world = mt.World(chemistry=CHEMS[("magicsoup_tpu_torch", "hpg-st")], map_size=32, seed=3)
    rng = random.Random(3)
    world.spawn_cells([mt.random_genome(s=250, rng=rng) for _ in range(40)])
    st = mt.PipelinedStepper(world, **_kw("hpg-st"))
    for _ in range(4):
        st.step()
    st.drain()
    probe = torch.ones(4, device="cuda")
    with rt.hot_path_guard(compile_budget=100):
        for _ in range(3):
            st.step()
        with pytest.raises(RuntimeError, match="synchroniz"):
            probe.sum().item()
        st.drain()
    st.flush()
