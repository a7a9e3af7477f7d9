"""
The port's token genome backend (``magicsoup_tpu_torch/genomes.py`` and
the token paths of ``World``) against the JAX package's
(``magicsoup_tpu.genomes``), on the CPU:

- the host codec: encode, decode and content hashes equal;
- ``point_mutations_tokens`` at p 1e-4 and 1e-2 (1e-2 is indel-heavy),
  at (cap, G) (8, 64), (64, 256) and (256, 1024), with and without a
  ``live`` mask, seeds 0-4 (and one above 2**32, whose key keeps the
  seed's low 32 bits as jax's does): tokens, lengths and ``changed``
  bit-equal;
- ``recombinations_tokens`` with rows in several pairs (the last firing
  pair wins), a pair list padded to 256, and zero-length rows: bit-equal
  in det mode; in fast mode equal except for pairs whose fire draw lies
  within 4 ULP of their miss probability, where ``torch.exp`` and XLA's
  ``exp`` may round apart (such pairs' rows are left out and counted);
- the string-replay wrappers, and ``GenomeStore``'s ``set_rows``,
  ``copy_rows``, ``permute``, ``grow_capacity`` and ``maybe_regrow``;
- a token ``World`` against the JAX token ``World``: 50 cells on a 32x32
  map, 10 workload steps with raised mutation and recombination rates,
  det mode, genomes, structure and state bit-equal;
- ``convert_genome_backend`` both ways, a warmed token fleet that
  decodes nothing, and the genome-ops microbenchmark's rows at a tiny
  size.
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
from magicsoup_tpu import genomes as jg  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu_torch import genomes as tg  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.ops import prng  # noqa: E402

SHAPES = [(8, 64), (64, 256), (256, 1024)]


@pytest.fixture
def det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")


def _store_rows(cap: int, g: int, seed: int):
    """Host token rows at (cap, G): random lengths up to G - 16, a few
    rows empty, the last quarter unused (length 0)."""
    rng = random.Random(seed)
    n = max(cap - cap // 4, 1)
    seqs = [ms.random_genome(s=rng.randint(0, g - 16), rng=rng) for _ in range(n)]
    for i in range(0, n, 7):
        seqs[i] = ""
    return jg._encode_at_shape(seqs, cap, g)


def _same(a, b) -> None:
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())


def test_codec_equals_jax():
    rng = random.Random(3)
    seqs = [ms.random_genome(s=rng.randint(0, 700), rng=rng) for _ in range(40)] + [""]
    for cap in (None, 1024):
        jt, jl = jg.encode_genomes(seqs, length_cap=cap)
        tt, tl = tg.encode_genomes(seqs, length_cap=cap)
        assert np.array_equal(jt, tt) and np.array_equal(jl, tl)
        assert tg.decode_tokens(tt, tl) == jg.decode_tokens(jt, jl) == seqs
        assert tg.token_hashes(tt, tl) == jg.token_hashes(jt, jl)
        assert tg.token_hashes(tt, tl, [3, 1]) == jg.token_hashes(jt, jl, [3, 1])
    for n in (1, 63, 64, 65, 1000):
        assert tg.length_capacity(n) == jg.length_capacity(n)
    with pytest.raises(ValueError, match="non-TCGA"):
        tg.encode_genomes(["TCGN"])
    with pytest.raises(ValueError, match="length_cap"):
        tg.encode_genomes(["TCGA" * 20], length_cap=64)


@pytest.mark.parametrize("live", [False, True], ids=["all", "live-mask"])
@pytest.mark.parametrize("cap,g", SHAPES, ids=[f"{c}x{g}" for c, g in SHAPES])
@pytest.mark.parametrize("p", [1e-4, 1e-2])
def test_point_mutations_bit_equal(p, cap, g, live):
    tok, lens = _store_rows(cap, g, seed=cap + g)
    mask = (np.arange(cap) % 3 != 1) if live else None
    total = 0
    for seed in [0, 1, 2, 3, 4, 2**40 + 7]:
        ref = jg.point_mutations_tokens(
            jnp.asarray(tok), jnp.asarray(lens), p=p, seed=seed, live=mask
        )
        out = tg.point_mutations_tokens(
            torch.from_numpy(tok), torch.from_numpy(lens), p=p, seed=seed, live=mask
        )
        _same(ref, out)
        total += int(out[2].sum())
    # mutations happened wherever at least 3 events are expected
    assert total > 0 or p * int(lens.sum()) * 6 < 3


def _recomb_pairs(cap: int, seed: int) -> np.ndarray:
    """Pairs with rows in several pairs (each row pairs with 3 others)."""
    rng = np.random.default_rng(seed)
    a = np.repeat(np.arange(cap), 3)
    b = (a + rng.integers(1, cap, len(a))) % cap
    return np.stack([a, b], axis=1)


def _near_miss_rows(tok, lens, pairs, p: float, seed: int) -> set[int]:
    """Rows of pairs whose fire draw lies within 4 ULP of the miss
    probability (the port's draws, which equal the JAX package's)."""
    cap = tok.shape[0]
    npairs = len(tg.pad_idxs(pairs[:, 0], oob=cap))
    kf = prng.split(tg._as_key(seed, torch.device("cpu")), 3)[0]
    u = prng.uniform(kf, (npairs,))[: len(pairs)].numpy()
    total = (lens[pairs[:, 0]] + lens[pairs[:, 1]]).astype(np.float32)
    log1mp = np.float32(np.log1p(-p))
    miss = np.exp((total * log1mp).astype(np.float32)).astype(np.float32)
    ulp = np.spacing(miss)
    near = np.abs(u - miss) <= 4 * ulp
    return set(pairs[near].ravel().tolist())


@pytest.mark.parametrize("mode", ["det", "fast"])
@pytest.mark.parametrize("cap,g", SHAPES[:2], ids=[f"{c}x{g}" for c, g in SHAPES[:2]])
def test_recombinations_bit_equal(mode, cap, g):
    tok, lens = _store_rows(cap, g // 2, seed=cap)
    tok = np.pad(tok, ((0, 0), (0, g - tok.shape[1])), constant_values=tg.PAD)
    pairs = _recomb_pairs(cap, seed=cap)
    fired, left_out = 0, 0
    for seed in range(5):
        for p in (1e-3, 2e-2):
            ref = jg.recombinations_tokens(
                jnp.asarray(tok), jnp.asarray(lens), pairs, p=p, seed=seed, det=mode == "det"
            )
            out = tg.recombinations_tokens(
                torch.from_numpy(tok), torch.from_numpy(lens), pairs, p=p, seed=seed,
                det=mode == "det",
            )
            rows = np.arange(cap)
            if mode == "fast":
                near = _near_miss_rows(tok, lens, pairs, p, seed)
                left_out += len(near)
                rows = np.array([r for r in rows if r not in near], dtype=np.int64)
            for x, y in zip(ref, out):
                assert np.array_equal(np.asarray(x)[rows], y.numpy()[rows])
            fired += int(out[2].sum())
    assert fired > 0
    assert left_out <= cap  # near-miss pairs are rare; their rows left out


def test_recombination_last_firing_pair_wins():
    cap, g = 16, 64
    tok, lens = _store_rows(cap, 48, seed=9)
    tok = np.pad(tok, ((0, 0), (0, g - tok.shape[1])), constant_values=tg.PAD)
    lens[5] = 0  # a zero-length row in pairs
    # row 2 is in four pairs; p = 0.5 per bp fires every non-empty pair
    pairs = np.array([[2, 3], [1, 2], [2, 7], [5, 2], [4, 6], [5, 9]])
    for det in (False, True):
        ref = jg.recombinations_tokens(jnp.asarray(tok), jnp.asarray(lens), pairs, p=0.5,
                                       seed=1, det=det)
        out = tg.recombinations_tokens(torch.from_numpy(tok), torch.from_numpy(lens), pairs,
                                       p=0.5, seed=1, det=det)
        _same(ref, out)
        assert out[2][[1, 2, 3, 4, 5, 6, 7, 9]].all()


def test_string_replay_wrappers_equal_jax():
    rng = random.Random(5)
    seqs = [ms.random_genome(s=rng.randint(50, 200), rng=rng) for _ in range(30)]
    for seed in range(3):
        ref = jg.point_mutations_strings(seqs, p=1e-2, seed=seed, cap=64, length_cap=256)
        out = tg.point_mutations_strings(seqs, p=1e-2, seed=seed, cap=64, length_cap=256,
                                         device="cpu")
        assert out == ref and out
    pairs = np.array([[i, (i + 1) % 30] for i in range(30)])
    for det in (False, True):
        ref = jg.recombinations_indexed_strings(seqs, pairs, p=5e-3, seed=4, det=det)
        out = tg.recombinations_indexed_strings(seqs, pairs, p=5e-3, seed=4, det=det,
                                                device="cpu")
        assert out == ref and out
    assert tg.point_mutations_strings([], device="cpu") == []


def _host(store):
    return tuple(np.asarray(a) for a in (store.tokens, store.lengths))


def test_genome_store_ops_equal_jax():
    rng = random.Random(8)
    seqs = [ms.random_genome(s=rng.randint(10, 60), rng=rng) for _ in range(20)]
    js, ts = jg.GenomeStore(32), tg.GenomeStore(32, device="cpu")
    for s in (js, ts):
        s.set_rows(list(range(20)), seqs)
        s.set_rows([3, 7], ["TTGA", "C" * 100])  # grows G to 128
        s.copy_rows([0, 3], [20, 21])
        s.permute(np.r_[np.arange(1, 32), 0], 25)
    assert [a.tolist() for a in _host(js)] == [a.tolist() for a in _host(ts)]
    assert ts.length_cap == js.length_cap == 128
    assert ts.decoded(25) == js.decoded(25)
    assert ts.decode_row(6) == js.decode_row(6)
    assert ts.hashes([0, 6]) == js.hashes([0, 6])
    assert ts.max_length() == js.max_length() == 100
    clone = ts.clone()
    assert clone.tokens is ts.tokens  # shares tensors until either writes
    for s in (js, ts):
        s.grow_capacity(64)
        s.set_rows([1], ["A" * 124])  # into the slack band of G 128
        s.maybe_regrow()
    assert ts.length_cap == js.length_cap == 256 and ts.capacity == 64
    assert [a.tolist() for a in _host(js)] == [a.tolist() for a in _host(ts)]
    assert clone.length_cap == 128 and clone.capacity == 32  # untouched
    ts.set_all(seqs[:5])
    assert ts.decoded(5) == seqs[:5] and int(ts.lengths[5:].sum()) == 0


def _token_world(lib, chem, seed: int, **kw):
    return lib.World(chemistry=chem, map_size=32, seed=seed, genome_backend="token", **kw)


def _assert_same_world(jw, tw) -> None:
    assert jw.n_cells == tw.n_cells > 0
    assert jw.cell_genomes == tw.cell_genomes
    assert jw.cell_labels == tw.cell_labels
    assert np.array_equal(jw.cell_positions, tw.cell_positions)
    assert np.array_equal(jw.cell_lifetimes, tw.cell_lifetimes)
    assert np.array_equal(jw.cell_divisions, tw.cell_divisions)
    assert np.array_equal(np.asarray(jw.cell_molecules), tw.cell_molecules)
    assert np.array_equal(np.asarray(jw.molecule_map), tw.molecule_map.numpy())
    for name, t in tw.kinetics.params._asdict().items():
        ref = np.asarray(getattr(jw.kinetics.params, name))[: jw.n_cells]
        assert np.array_equal(ref, t[: tw.n_cells].numpy()), name
    js, ts = jw.genome_store, tw.genome_store
    assert (js.capacity, js.length_cap) == (ts.capacity, ts.length_cap)
    assert [a.tolist() for a in _host(js)] == [a.tolist() for a in _host(ts)]


def test_token_world_matches_jax_token_world(det):
    from magicsoup_tpu_torch.workload import sim_step as tstep
    from performance.workload import sim_step as jstep

    jw = _token_world(ms, JCHEM, 5)
    tw = _token_world(mt, TCHEM, 5, device="cpu")
    assert tw.genome_backend == "token" and tw.genome_store.device.type == "cpu"
    atp = TCHEM.molname_2_idx["ATP"]
    jr, tr = random.Random(1), random.Random(1)
    for step in range(10):
        jstep(jw, jr, n_cells=50, genome_size=300, atp_idx=atp)
        tstep(tw, tr, n_cells=50, genome_size=300, atp_idx=atp)
        for w in (jw, tw):
            w.recombinate_cells(p=1e-4)
            w.mutate_cells(p=2e-3)
        _assert_same_world(jw, tw)
    # a subset mutates; as in the JAX package, other rows come back PAD
    for w in (jw, tw):
        w.mutate_cells(cell_idxs=[0, 2, 4], p=1e-2)
    assert [a.tolist() for a in _host(jw.genome_store)] == [
        a.tolist() for a in _host(tw.genome_store)
    ]
    assert tw.genome_of(0) == jw.genome_of(0)


def test_token_world_matches_string_world_under_structural_churn(det):
    rng = random.Random(10)
    seqs = [mt.random_genome(s=150, rng=rng) for _ in range(12)]
    ws = mt.World(chemistry=TCHEM, map_size=16, seed=42, device="cpu")
    wt = mt.World(chemistry=TCHEM, map_size=16, seed=42, device="cpu", genome_backend="token")
    for w in (ws, wt):
        w.spawn_cells(seqs)
        w.update_cells([(seqs[0][:100], 2), (seqs[1] + "TCGA", 5), (seqs[3], 5)])
        w.divide_cells([0, 3])
        w.kill_cells([1, 4])
    assert wt.cell_genomes == ws.cell_genomes
    assert np.array_equal(wt.cell_molecules, ws.cell_molecules)
    for name, t in wt.kinetics.params._asdict().items():
        assert torch.equal(t, getattr(ws.kinetics.params, name)), name


def test_convert_genome_backend_roundtrip():
    seqs = [mt.random_genome(s=120, rng=random.Random(11)) for _ in range(8)]
    w = mt.World(chemistry=TCHEM, map_size=16, seed=3, device="cpu")
    w.spawn_cells(seqs)
    w.convert_genome_backend("token")
    assert w.genome_backend == "token" and w.genome_store is not None
    assert list(w.cell_genomes) == seqs
    w.convert_genome_backend("string")
    assert w.genome_backend == "string" and w.genome_store is None
    assert list(w.cell_genomes) == seqs
    with pytest.raises(ValueError, match="genome_backend"):
        w.convert_genome_backend("parquet")
    with pytest.raises(ValueError, match="genome_backend"):
        mt.World(chemistry=TCHEM, map_size=16, device="cpu", genome_backend="parquet")


def test_token_fleet_steady_state_decodes_nothing(det):
    def _w(seed):
        w = _token_world(mt, TCHEM, seed, device="cpu")
        w.spawn_cells([mt.random_genome(s=100, rng=random.Random(seed)) for _ in range(6)])
        return w

    kw = dict(mol_name="ATP", kill_below=-1.0, divide_above=1e30, divide_cost=0.0,
              target_cells=None, genome_size=100, lag=1, p_mutation=0.0,
              p_recombination=0.0, megastep=1)
    fleet = mt.FleetScheduler(block=2)
    for seed in (3, 5):
        fleet.admit(_w(seed), **kw)
    fleet.step()
    fleet.drain()
    d0 = runtime.genome_stats()["genome_decode_calls"]
    for _ in range(3):
        fleet.step()
    fleet.drain()
    assert runtime.genome_stats()["genome_decode_calls"] == d0
    fleet.flush()


def test_genome_ops_bench_rows_on_the_cpu():
    from magicsoup_tpu_torch.performance import genome_ops

    rows = genome_ops.bench([40, 64], s=120, r=2, p=1e-3, pb=1e-3, seed=0, device="cpu",
                            log=lambda line: None)
    keys = {"metric", "op", "value", "unit", "sd", "repeats", "n_cells", "genome_size",
            "backend", "device"}
    assert len(rows) == 12 and all(set(r) == keys for r in rows)
    assert {(r["op"], r["backend"]) for r in rows} == {
        (op, b) for op in ("mutate", "recombinate", "translate") for b in ("string", "token")
    }
    assert all(r["device"] == "cpu" and r["value"] >= 0 for r in rows)
