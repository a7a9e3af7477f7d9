"""
``World.kill_cells``' compaction of the live rows against the
full-capacity one it replaces.

The oracle is the compaction by a permutation over the whole capacity
(``ops/params.py::compact_rows``, which the stepper, the fleet and the
mesh still run): the survivors first, in order, every other row zero.
``kill_cells`` instead gathers only the survivors among the live rows
and zeroes only the rows the killed cells leave; each parameter tensor
goes into a spare of its shape, a tensor an earlier compaction replaced
(``Kinetics.compact_cells``; three spares for the nine tensors).  Every
parameter tensor, the cell molecules, the device and host positions, the
lifetimes, divisions, genomes, labels and the molecule map must equal
the oracle's, rows at and past ``n_cells`` stay zero through divide,
spawn and a growth of the protein axis, and the ``compaction.rows`` /
``compaction.capacity_rows`` counters add up.

On a card (``cuda`` marker; ``python -m pytest
tests/test_torch_kill_compaction.py -m cuda --noconftest``): classic steps
with a kill and a divide each run under ``hot_path_guard(0,
"disallow")``, so no upload of the step synchronizes.  This file imports
no JAX.
"""
import random

import numpy as np
import pytest
import torch

from magicsoup_tpu_torch import telemetry
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
from magicsoup_tpu_torch.ops.params import compact_rows
from magicsoup_tpu_torch.util import random_genome
from magicsoup_tpu_torch.world import World, _map_add

MAP = 16


def _world(n: int, seed: int, device="cpu", map_size: int = MAP) -> World:
    w = World(chemistry=CHEMISTRY, map_size=map_size, seed=seed, device=device)
    rng = random.Random(seed)
    w.spawn_cells([random_genome(s=300, rng=rng) for _ in range(n)])
    assert w.n_cells == n
    # distinct molecules and lifetimes per row, so a row moved wrong shows
    w.cell_molecules = np.random.default_rng(seed).random((n, w.n_molecules), dtype=np.float32)
    w.cell_lifetimes = np.arange(n, dtype=np.int32) + 1
    w.cell_divisions = np.arange(n, dtype=np.int32) % 7
    return w


def _snapshot(w: World) -> dict:
    return {
        "params": [t.clone() for t in w.kinetics.params],
        "cm": w._cell_molecules.clone(),
        "pos_dev": w._positions_dev.clone(),
        "mm": w._molecule_map.clone(),
        "pos": w._np_positions.copy(),
        "life": w._np_lifetimes.copy(),
        "div": w._np_divisions.copy(),
        "genomes": list(w.cell_genomes),
        "labels": list(w.cell_labels),
        "n": w.n_cells,
    }


def _oracle(s: dict, kill: list[int], cap: int) -> dict:
    """The parent's full-capacity compaction of a snapshot."""
    kill = np.array(sorted(set(kill)), dtype=np.int64)
    keep_mask = np.ones(cap, dtype=bool)
    keep_mask[kill] = False
    keep_mask[s["n"]:] = False
    perm = np.concatenate([np.nonzero(keep_mask)[0], np.nonzero(~keep_mask)[0]])
    n_keep = int(keep_mask.sum())
    perm_t = torch.from_numpy(perm)

    def host(a):
        out = a[perm]
        out[n_keep:] = 0
        return out

    pos = s["pos"][kill].astype(np.int64)
    dead = set(kill.tolist())
    return {
        "params": [compact_rows(t, perm_t, n_keep) for t in s["params"]],
        "cm": compact_rows(s["cm"], perm_t, n_keep),
        "pos_dev": compact_rows(s["pos_dev"], perm_t, n_keep),
        "mm": _map_add(s["mm"], torch.from_numpy(pos[:, 0]), torch.from_numpy(pos[:, 1]),
                       s["cm"][torch.from_numpy(kill)].T),
        "pos": host(s["pos"]),
        "life": host(s["life"]),
        "div": host(s["div"]),
        "genomes": [g for i, g in enumerate(s["genomes"]) if i not in dead],
        "labels": [g for i, g in enumerate(s["labels"]) if i not in dead],
        "n": n_keep,
    }


def _assert_matches(w: World, want: dict):
    got = _snapshot(w)
    assert got["n"] == want["n"]
    for name in ("cm", "pos_dev", "mm"):
        assert torch.equal(got[name], want[name]), name
    for i, (g, e) in enumerate(zip(got["params"], want["params"])):
        assert torch.equal(g, e), w.kinetics.params._fields[i]
    for name in ("pos", "life", "div"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["genomes"] == want["genomes"]
    assert got["labels"] == want["labels"]


def _assert_tail_zero(w: World):
    """Every per-cell store is zero at and past ``n_cells``, and the
    device positions are the host's."""
    n = w.n_cells
    for name, t in zip(w.kinetics.params._fields, w.kinetics.params):
        assert t.shape[0] == w._capacity
        assert not t[n:].any(), name
    assert not w._cell_molecules[n:].any()
    assert not w._positions_dev[n:].any()
    for a in (w._np_positions, w._np_lifetimes, w._np_divisions):
        assert not a[n:].any()
    np.testing.assert_array_equal(w._positions_dev.numpy(), w._np_positions.astype(np.int64))


def _kill_checked(w: World, kill: list[int]) -> tuple[int, int]:
    """Kill ``kill`` and hold the world to the oracle; returns what the
    two compaction counters gained."""
    want = _oracle(_snapshot(w), kill, w._capacity)
    before = telemetry.counter_totals()
    w.kill_cells(kill)
    after = telemetry.counter_totals()
    _assert_matches(w, want)
    _assert_tail_zero(w)
    return tuple(
        after.get(k, 0) - before.get(k, 0)
        for k in ("compaction.rows", "compaction.capacity_rows")
    )


#: name -> (cells spawned, the kill as a function of n_cells and a rng)
PATTERNS = {
    "first_row": (100, lambda n, rng: [0]),
    "last_live_row": (100, lambda n, rng: [n - 1]),
    "contiguous_run": (100, lambda n, rng: list(range(20, 45))),
    "every_cell": (100, lambda n, rng: list(range(n))),
    "random_3pct": (200, lambda n, rng: rng.choice(n, max(1, n * 3 // 100), replace=False).tolist()),
    "full_capacity": (128, lambda n, rng: rng.choice(n, 9, replace=False).tolist()),
}


#: the parameter tensors' shapes: Ke, Kmf, Kmb, Vmax; Kmr; N, Nf, Nb, A
SHAPES = 3
TENSORS = 9


def _rows(cap: int, n: int, spare_rows: int | None, n_keep: int) -> tuple[int, int]:
    """What a compaction of ``n`` live rows to ``n_keep`` writes, summed
    over the nine tensors, and the capacity rows: the first tensor of each
    shape goes into the spare the last compaction left (the whole
    capacity without one, else the rows it may hold), the next ones into
    the tensor just replaced, which holds ``n``."""
    first = cap if spare_rows is None else max(n_keep, spare_rows)
    return SHAPES * first + (TENSORS - SHAPES) * max(n_keep, n), TENSORS * cap


def _spare_rows(w: World) -> int | None:
    """The rows the held spares may hold nonzero; None where there are
    none (the next compaction makes one per shape)."""
    kin = w.kinetics
    assert kin._spares is not None and kin._spares[0] is kin.params
    rows = {r for _, r in kin._spares[1].values()}
    assert len(rows) <= 1
    return rows.pop() if rows else None


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_live_row_compaction_equals_the_full_capacity_one(pattern):
    n0, pick = PATTERNS[pattern]
    w = _world(n0, seed=sorted(PATTERNS).index(pattern) + 3)
    rng = np.random.default_rng(11)
    cap = w._capacity
    if pattern == "full_capacity":
        assert w.n_cells == cap
    _assert_tail_zero(w)

    # the first compaction has no spares yet
    n1 = w.n_cells
    kill1 = sorted(set(pick(n1, rng)))
    assert _kill_checked(w, kill1) == _rows(cap, n1, None, n1 - len(kill1))
    assert len(w.kinetics._spares[1]) == SHAPES and _spare_rows(w) == n1

    if w.n_cells:
        w.divide_cells(list(range(0, w.n_cells, 3)))
        _assert_tail_zero(w)
    rng_g = random.Random(5)
    w.spawn_cells([random_genome(s=300, rng=rng_g) for _ in range(10)])
    _assert_tail_zero(w)
    cap = w._capacity

    # the spares the first kill left, unless the spawn grew the capacity
    # or the protein axis (then there are none): only the rows they may
    # hold nonzero, the first kill's n_cells, are written again
    spare_rows = _spare_rows(w)
    n2 = w.n_cells
    kill2 = rng.choice(n2, max(1, n2 // 10), replace=False).tolist()
    assert _kill_checked(w, kill2) == _rows(cap, n2, spare_rows, n2 - len(kill2))

    # a wider protein axis frees the spares; the next kill makes new ones
    p = w.kinetics.params.Vmax.shape[1]
    w.kinetics.increase_max_proteins(2 * p)
    assert w.kinetics.params.Vmax.shape[1] == 2 * p
    assert _spare_rows(w) is None
    _assert_tail_zero(w)
    if w.n_cells:
        n3 = w.n_cells
        kill3 = sorted(set(pick(n3, rng)))
        assert _kill_checked(w, kill3) == _rows(cap, n3, None, n3 - len(kill3))


def test_later_kills_write_only_the_rows_the_spares_may_hold():
    """kill, divide, kill: the second kill gathers into the tensors the
    first replaced and zeroes their rows up to the first kill's
    ``n_cells``; the third up to the second's."""
    w = _world(150, seed=9)
    rng = np.random.default_rng(2)
    cap = w._capacity
    n1 = w.n_cells
    _kill_checked(w, rng.choice(n1, 30, replace=False).tolist())
    w.divide_cells([0, 5, 9])
    _assert_tail_zero(w)
    assert w._capacity == cap
    n2 = w.n_cells
    assert n2 > n1 - 30
    assert _kill_checked(w, [1, n2 - 1]) == _rows(cap, n2, n1, n2 - 2)
    n3 = w.n_cells
    assert _kill_checked(w, list(range(0, n3, 2))) == _rows(cap, n3, n2, n3 - (n3 + 1) // 2)


def test_kill_after_another_owner_replaces_the_params():
    """Parameter tensors put in place by another owner (a stepper's
    write-back, which may keep views of them) void the spares: the next
    compaction gathers every tensor into a new one, and writes neither
    the void spares nor the tensors it replaced."""
    w = _world(100, seed=2)
    rng = np.random.default_rng(1)
    _kill_checked(w, rng.choice(w.n_cells, 5, replace=False).tolist())
    kin = w.kinetics
    held = [t for t, _ in kin._spares[1].values()]
    before = [t.clone() for t in held]
    kin.params = theirs = type(kin.params)(*(t.clone() for t in kin.params))
    kept = [t.clone() for t in theirs]
    cap = w._capacity
    assert _kill_checked(w, [0, 3]) == (TENSORS * cap, TENSORS * cap)
    for t, b in zip(held + list(theirs), before + kept):
        assert torch.equal(t, b)
    assert _spare_rows(w) is None
    # the tensors it made are its own: the next kill chains them again
    n = w.n_cells
    assert _kill_checked(w, [1]) == _rows(cap, n, None, n - 1)
    assert _spare_rows(w) == n


def test_unpickled_kinetics_holds_no_spares():
    import pickle

    w = _world(80, seed=4)
    w.kill_cells([1, 2])
    assert _spare_rows(w) == 80
    kin = pickle.loads(pickle.dumps(w.kinetics))
    assert kin._spares[0] is kin.params and kin._spares[1] == {}
    for a, b in zip(kin.params, w.kinetics.params):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the guard's transfer half sees only CUDA syncs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_classic_steps_with_kill_and_divide_do_not_synchronize(card):
    """Three classic steps of a small world, each with a kill and a
    divide, under ``hot_path_guard(0, "disallow")``: the only syncs are
    the sanctioned fetches (the selection column)."""
    from magicsoup_tpu_torch.analysis import runtime

    w = _world(900, seed=7, device=card, map_size=64)
    atp = w.chemistry.molname_2_idx["ATP"]

    def step(i: int):
        w.enzymatic_activity(prefetch_column=atp)
        col = w.cell_molecule_column(atp)
        order = np.argsort(col, kind="stable")
        w.kill_cells(np.sort(order[:20]).tolist())
        w.divide_cells(list(range(i, w.n_cells, 50)))
        w.recombinate_cells(p=1e-7)
        w.mutate_cells(p=1e-5)
        w.degrade_and_diffuse_molecules()
        w.increment_cell_lifetimes()

    for i in range(4):
        step(i)
    w.prewarm_activity(has_col=True)
    torch.cuda.synchronize()
    with runtime.hot_path_guard(compile_budget=0, transfers="disallow"):
        for i in range(3):
            step(i)
    torch.cuda.synchronize()
    _assert_tail_zero_on(w)


def _assert_tail_zero_on(w: World):
    n = w.n_cells
    for t in w.kinetics.params:
        assert not bool(t[n:].any())
    assert not bool(w._cell_molecules[n:].any())
    pos = w._positions_dev.cpu().numpy()
    np.testing.assert_array_equal(pos, w._np_positions.astype(np.int64))
