"""
The CUDA sources of the integrator kernel (``csrc/integrate.cu``), of
its ladder (``csrc/bisect.cu``), of the threefry draw
(``csrc/threefry.cu``) and of parameter assembly (``csrc/assemble.cu``),
compiled with g++ against a CPU stand-in
for the CUDA runtime (``torch_data/cuda_emu/cuda_runtime.h``: each CTA
runs as one thread per CUDA thread, with real barriers) and held against
their plain versions on the CPU.  So the kernels' logic -- the staging of
a tile's parameters, the launch plan's layouts, both lane mappings, the
tile's vote, the world stride, each cell's protein extent -- is tested
without a card, and the C side's shared-memory bytes against the Python
launch plan's.  On a ragged state (cells of 0 to a few proteins in a wide
protein axis, holes, regulation-only slots, a trailing slot with a NaN
Vmax) every entry of the integrator is bit-equal to itself on the same
cells with the axis cut to what they hold, and its slot counters are the
host's sums of the cells' extents and of each tile's widest.

glibc's expf/logf round differently from the card's, so the outputs are
held to the fast contract (the ladder's rungs to their own contracts);
bits are compared only between launches of the emulated kernels (every
residency mask, each world against its own launch, each group of a
grouped launch against its own launch, each ladder rung across the masks
the launch plan can pick for its groups, rung 11 against the kernel).  The threefry kernel's work is
integer only, so it is held bit-equal to its plain version
(``ops/prng.py``): both output modes, several keys, counts that are not
a multiple of the block, and one element.  The assembly kernel repeats
its plain version's arithmetic operation for operation, so it is held
bit-equal to ``ops/params.py::assemble_rows`` (the emulated threads flush
subnormals as the plain version does on the CPU), and a token or a row
outside the tables traps it.  On the card chip_smoke.py holds the kernels
themselves.
"""
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from magicsoup_tpu_torch.interop import params_from_numpy
from magicsoup_tpu_torch.ops import cuda_bisect as cb
from magicsoup_tpu_torch.ops import cuda_integrate as ci
from magicsoup_tpu_torch.ops import cuda_params, cuda_prng, prng
from magicsoup_tpu_torch.ops import params as plain_params
from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.performance import kernel_bisect as kb

EMU = Path(__file__).parent / "torch_data" / "cuda_emu"
LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?)<<<\s*([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(")
SHAPES = [(64, 8, 12), (32, 32, 28), (16, 64, 82), (16, 5, 7)]


def _build(src: Path, out_dir: Path) -> ctypes.CDLL:
    """``src`` with its shared-memory declaration and its launches
    rewritten for the stand-in runtime, built with g++ (no contraction of
    a multiply into an add, as nvcc --fmad=false)."""
    text = src.read_text().replace(
        "extern __shared__ __align__(16) unsigned char smem[];",
        "unsigned char* smem = emu_smem;",
    )
    text, n = LAUNCH.subn(r"emu_launch(\1, dim3(\2), \3, ", text)
    assert n > 0, f"no kernel launch found in {src.name}"
    cpp = out_dir / f"{src.stem}.cpp"
    cpp.write_text(text)
    lib = out_dir / f"lib{src.stem}.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         f"-I{EMU}", f"-I{src.parent}", str(cpp), "-o", str(lib)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    integrate, bisect = _build(ci.SRC, out), _build(cb.SRC, out)
    vp, cint, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    integrate.ms_integrate_signals.argtypes = [vp] * 11 + [cint] * 4 + [ctypes.c_longlong, cint, vp, vp]
    integrate.ms_integrate_signals.restype = cint
    integrate.ms_integrate_smem_bytes.argtypes = [cint] * 3
    integrate.ms_integrate_smem_bytes.restype = size
    integrate.ms_integrate_signals_grouped.argtypes = [cint, vp, vp, vp, vp, ctypes.POINTER(cint), vp]
    integrate.ms_integrate_signals_grouped.restype = cint
    bisect.ms_bisect_rung.argtypes = [cint] + [vp] * 11 + [cint] * 4 + [vp]
    bisect.ms_bisect_rung.restype = cint
    bisect.ms_bisect_smem_bytes.argtypes = [cint] * 4
    bisect.ms_bisect_smem_bytes.restype = size
    bisect.ms_bisect_rung_groups.argtypes = [cint]
    bisect.ms_bisect_rung_groups.restype = cint
    return integrate, bisect


def _inputs(c: int, p: int, s: int, seed: int):
    """Seeded inputs as performance/pallas_bisect.py draws them, Vmax
    scaled so that the equilibrium correction runs, with the edge cases
    and dead rows 8-15."""
    rng = np.random.default_rng(seed)
    d = dict(
        Ke=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmf=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmb=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmr=rng.uniform(0.1, 10, (c, p, s)).astype(np.float32),
        Vmax=(30 * rng.uniform(0, 2, (c, p))).astype(np.float32),
        N=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
        Nf=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        Nb=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        A=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
    )
    X = rng.uniform(0, 4, (c, s)).astype(np.float32)
    X[0] = 0.0
    d["A"][1] = 0
    d["A"][1, :, 0] = -2
    X[1, 0] = 0.0
    for k in d:
        d[k][8:16] = 0
    return torch.from_numpy(X)[None], CellParams(*(t[None] for t in params_from_numpy(d, "cpu")))


def _run(lib, X, params, mask: int, slots=None) -> torch.Tensor:
    """The emulated kernel; ``slots``, an int64 tensor of 2, gets its
    slot counters."""
    B, c, s = X.shape
    out = torch.empty_like(X)
    err = lib.ms_integrate_signals(
        X.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(),
        B, c, params.Ke.shape[-1], s, ci._check(X, params), mask,
        None if slots is None else slots.data_ptr(), None,
    )
    assert err == 0
    return out


def _ragged(c: int, p: int, s: int, cut: int, seed: int):
    """``_inputs`` with each cell's proteins cut to a few, in a protein
    axis of ``p`` whose slots from ``cut`` on are all inert, and the
    cells' extents (one past the last slot that is not inert) as the host
    reads them.  Tile 0 holds extents 0, 1 and 3 around a cell of extent
    ``cut``; tile 1 is dead rows; tile 2 a hole (an inert slot below a live
    one), a regulation-only slot past the last live one, a trailing slot
    with a NaN Vmax and zero integer rows (it must be walked) and one with
    a negative Kmr under A != 0 (walked too); the other tiles draw their
    extents.  Each inert slot keeps a random A, Vmax, Ke, Kmf, Kmb and a
    positive Kmr."""
    rng = np.random.default_rng(seed)
    X, params = _inputs(c, p, s, seed)
    d = {k: v[0].numpy().copy() for k, v in params._asdict().items()}
    rows = rng.integers(0, cut + 1, c)  # each cell's slots with integer rows
    rows[:8] = [0, 1, 3, cut, 2, 1, 0, cut - 1]
    rows[8:16] = 0  # dead rows: _inputs zeroes all their parameters
    rows[16:20] = [4, 2, 2, 2]
    n0 = d["N"][..., 0]
    n0[n0 == 0] = 1  # so every slot below a cell's rows is live
    for k in ("N", "Nf", "Nb"):
        d[k][np.arange(p) >= rows[:, None]] = 0
        d[k][16, 2] = 0  # a hole below cell 16's live slot 3
    d["A"][17, 2] = 2  # a regulation-only slot: inert
    d["Vmax"][18, 3] = np.nan
    d["A"][19, 2, 1], d["Kmr"][19, 2, 1] = -1, -0.5
    live = ((d["N"] != 0) | (d["Nf"] != 0) | (d["Nb"] != 0)).any(-1)
    live |= ~np.isfinite(d["Vmax"]) | ((d["A"] != 0) & (d["Kmr"] < 0)).any(-1)
    ext = np.where(live.any(1), p - np.argmax(live[:, ::-1], 1), 0)
    assert list(ext[:8]) == list(rows[:8]) and list(ext[16:20]) == [4, 2, 4, 3]
    assert ext.max() == cut and not ext[8:16].any()
    return X, CellParams(*(torch.from_numpy(v)[None] for v in d.values())), ext


def _cut(params: CellParams, p: int) -> CellParams:
    """The parameters with the protein axis cut to its first ``p`` slots."""
    def first(t):
        return t[:, :, :p].contiguous()

    return CellParams(*(first(t) for t in params))


def _slots(ext: np.ndarray) -> list[int]:
    """The slot counters of a launch over cells of extents ``ext``: their
    sum, and TILE_C times each tile's largest."""
    return [int(ext.sum()), int(ci.TILE_C * ext.reshape(-1, ci.TILE_C).max(1).sum())]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _assert_fast_contract(out: torch.Tensor, ref: torch.Tensor) -> None:
    out, ref = out.numpy(), ref.numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    assert np.quantile(rel, 0.99) < 1e-4 and rel.max() < 0.15, (np.quantile(rel, 0.99), rel.max())


@pytest.mark.parametrize("p,s", [(8, 20), (32, 28), (64, 82), (128, 82)])
def test_kernel_layout_is_the_launch_plans(libs, p, s):
    integrate, bisect = libs
    for mask in range(ci.ALL_RESIDENT + 1):
        assert integrate.ms_integrate_smem_bytes(p, s, mask) == ci.smem_bytes(p, s, mask)
        for rung in cb.RUNGS:  # every rung on the integrator's layout
            assert bisect.ms_bisect_smem_bytes(rung, p, s, mask) == ci.smem_bytes(p, s, mask)
    for rung in cb.RUNGS:
        assert bisect.ms_bisect_rung_groups(rung) == cb.group_bits(rung)
        how = ci.plan(p, s, ci.SMEM_LIMIT, cb.group_bits(rung))
        assert bisect.ms_bisect_smem_bytes(rung, p, s, how.mask) == how.smem_bytes


@pytest.mark.parametrize("c,p,s", SHAPES, ids=[f"c{c}-p{p}-s{s}" for c, p, s in SHAPES])
def test_emulated_kernel_holds_its_plain_version(libs, c, p, s):
    X, params = _inputs(c, p, s, seed=c + p + s)
    ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)
    plan = ci.plan(p, s)
    masks = {plan.mask, 0, 1 | 2 | 32, 8 | 16, ci.ALL_RESIDENT}
    outs = [_run(libs[0], X, params, m) for m in sorted(masks) if ci.smem_bytes(p, s, m) <= ci.SMEM_LIMIT]
    _assert_fast_contract(outs[0], ref)
    assert torch.equal(outs[0][0, 8:16], X[0, 8:16])  # dead rows are inert
    assert all(torch.equal(o, outs[0]) for o in outs[1:])  # residency changes no bit


def test_emulated_worlds_equal_their_own_launch(libs):
    worlds = [_inputs(40, 8, 12, seed=w) for w in range(3)]
    X = torch.cat([x[:, :24] for x, _ in worlds]).contiguous()
    params = CellParams(*(torch.cat(ts)[:, :24] for ts in zip(*(p for _, p in worlds))))
    assert ci._check(X, params) == 40  # the world stride: each a prefix
    out = _run(libs[0], X, params, ci.ALL_RESIDENT)
    _assert_fast_contract(out, ci.integrate_signals_tiled(X, params, ci.TILE_C))
    for w in range(3):
        solo = _run(libs[0], X[w : w + 1].contiguous(), CellParams(*(t[w : w + 1] for t in params)),
                    ci.ALL_RESIDENT)
        assert torch.equal(solo[0], out[w])


def _run_grouped(lib, Xs, params_list, masks, slots=None) -> tuple[list, int]:
    outs = [torch.empty_like(X) for X in Xs]
    args = ci.grouped_args(Xs, params_list, outs, masks,
                           [ci._check(X, p) for X, p in zip(Xs, params_list)])
    launched = ctypes.c_int(-1)
    assert lib.ms_integrate_signals_grouped(
        args.n, args.ptrs, args.dims, args.pstrides,
        None if slots is None else slots.data_ptr(), ctypes.byref(launched), None) == 0
    return outs, launched.value


def test_emulated_grouped_launch_equals_each_groups_own_launch(libs):
    # three groups of different (B, c, p, s): two on the resident route
    # (one the 24-row prefix of a 40-row stack), one on a partial route
    a = [_inputs(40, 8, 12, seed=w) for w in range(2)]
    Xa = torch.cat([x[:, :24] for x, _ in a]).contiguous()
    pa = CellParams(*(torch.cat(ts)[:, :24] for ts in zip(*(p for _, p in a))))
    Xb, pb = _inputs(16, 32, 28, seed=5)
    c = [_inputs(16, 5, 7, seed=6 + w) for w in range(2)]
    Xc = torch.cat([x for x, _ in c])
    pc = CellParams(*(torch.cat(ts) for ts in zip(*(p for _, p in c))))
    groups = [(Xa, pa, ci.ALL_RESIDENT), (Xb, pb, ci.ALL_RESIDENT), (Xc, pc, 8 | 16)]
    outs, launched = _run_grouped(libs[0], *zip(*groups))
    assert launched == 2  # one launch per route
    for (X, params, mask), out in zip(groups, outs):
        own = _run(libs[0], X, params, mask)
        assert torch.equal(out, own)
        _assert_fast_contract(out, ci.integrate_signals_tiled(X, params, ci.TILE_C))
        for w in range(X.shape[0]):
            solo = _run(libs[0], X[w : w + 1].contiguous(),
                        CellParams(*(t[w : w + 1] for t in params)), mask)
            assert torch.equal(solo[0], out[w])
    # more groups than one launch takes: ceil(17 / 16) launches
    many = [_inputs(8, 4, 6, seed=20 + g) for g in range(ci.MAX_GROUPS + 1)]
    outs, launched = _run_grouped(libs[0], [x for x, _ in many], [p for _, p in many],
                                  [ci.ALL_RESIDENT] * len(many))
    assert launched == 2
    for (X, params), out in zip(many, outs):
        assert torch.equal(out, _run(libs[0], X, params, ci.ALL_RESIDENT))


#: (p, s, the cut): Wood-Ljungdahl's 28 signals on the resident route,
#: co2_fixing's 82 on the partial route, and an odd p * s, whose extent
#: scan reads single entries
RAGGED = [(32, 28, 8), (64, 82, 8), (9, 7, 4)]


@pytest.mark.parametrize("p,s,cut", RAGGED, ids=[f"p{p}-s{s}" for p, s, _ in RAGGED])
def test_emulated_kernel_walks_each_cells_own_proteins(libs, p, s, cut):
    X, params, ext = _ragged(40, p, s, cut, seed=p + s)
    short = _cut(params, cut)
    masks = [m for m in range(ci.ALL_RESIDENT + 1) if ci.smem_bytes(p, s, m) <= ci.SMEM_LIMIT]
    assert ci.plan(p, s).mask in masks and len(masks) > 8
    want = _run(libs[0], X, short, ci.plan(cut, s).mask)
    for mask in masks:
        slots = torch.zeros(2, dtype=torch.int64)
        out = _run(libs[0], X, params, mask, slots)
        assert torch.equal(_bits(out), _bits(want)), mask  # the NaN cell's bits too
        assert slots.tolist() == _slots(ext), mask
    assert torch.isnan(want[0, 18]).any() and not torch.isnan(want[0, :18]).any()
    assert torch.equal(want[0, 8:16], X[0, 8:16])  # dead rows are inert
    _assert_fast_contract(want[:, :16], ci.integrate_signals_tiled(X, params, ci.TILE_C)[:, :16])
    # no counters: a null pointer, and the same bits
    assert torch.equal(_bits(_run(libs[0], X, params, ci.plan(p, s).mask)), _bits(want))


def _ragged_stack(p: int, s: int, cut: int, seed: int):
    """Three ragged worlds as the 24-row prefixes of a 40-row stack."""
    worlds = [_ragged(40, p, s, cut, seed=seed + w) for w in range(3)]
    X = torch.cat([x[:, :24] for x, _, _ in worlds]).contiguous()
    params = CellParams(*(torch.cat(ts)[:, :24] for ts in zip(*(q for _, q, _ in worlds))))
    return X, params, np.concatenate([e[:24] for _, _, e in worlds])


@pytest.mark.parametrize("p,s,cut", RAGGED[:2], ids=[f"p{p}-s{s}" for p, s, _ in RAGGED[:2]])
def test_emulated_worlds_walk_each_cells_own_proteins(libs, p, s, cut):
    X, params, ext = _ragged_stack(p, s, cut, seed=3)
    assert ci._check(X, params) == 40
    want = _run(libs[0], X, _cut(params, cut), ci.plan(cut, s).mask)
    for mask in sorted({ci.plan(p, s).mask, 0, ci.ALL_RESIDENT}):
        if ci.smem_bytes(p, s, mask) > ci.SMEM_LIMIT:
            continue
        slots = torch.zeros(2, dtype=torch.int64)
        out = _run(libs[0], X, params, mask, slots)
        assert torch.equal(_bits(out), _bits(want)), mask
        assert slots.tolist() == _slots(ext), mask


def test_emulated_grouped_launch_walks_each_cells_own_proteins(libs):
    # a B = 3 ragged stack on the resident route and a ragged world on
    # the partial route at 82 signals, in one grouped call
    Xa, pa, ea = _ragged_stack(32, 28, 8, seed=7)
    Xb, pb, eb = _ragged(40, 64, 82, 8, seed=8)
    masks = [ci.plan(32, 28).mask, ci.plan(64, 82).mask]
    assert masks[1] not in (0, ci.ALL_RESIDENT)  # partial
    slots = torch.zeros(2, dtype=torch.int64)
    outs, launched = _run_grouped(libs[0], [Xa, Xb], [pa, pb], masks, slots)
    assert launched == 2
    assert slots.tolist() == [a + b for a, b in zip(_slots(ea), _slots(eb))]
    for X, params, out, s in ((Xa, pa, outs[0], 28), (Xb, pb, outs[1], 82)):
        want = _run(libs[0], X, _cut(params, 8), ci.plan(8, s).mask)
        assert torch.equal(_bits(out), _bits(want))


def _rung_masks(rung: int, p: int, s: int) -> list[int]:
    """The residency masks the launch plan can pick for the rung's groups:
    the masks K1's emulation test walks, restricted to the rung's."""
    bits = cb.group_bits(rung)
    masks = {m & bits for m in (ci.plan(p, s).mask, 0, 1 | 2 | 32, 8 | 16, ci.ALL_RESIDENT)}
    return sorted(m for m in masks if ci.smem_bytes(p, s, m) <= ci.SMEM_LIMIT)


def _run_rung(lib, rung: int, X, params, mask: int) -> tuple[int, torch.Tensor]:
    """The emulated rung, with no pointer for a tensor the rung does not
    read, as the wrapper passes them (so staging one would fault)."""
    (c, s), p = X.shape, params.Ke.shape[-1]
    out = torch.empty(cb.out_shape(rung, X, params), dtype=torch.float32)
    ptrs = [t.data_ptr() if name in cb.RUNGS[rung].reads else None
            for name, t in zip(cb.ALL_PARAMS, params)]
    return lib.ms_bisect_rung(rung, X.data_ptr(), *ptrs, out.data_ptr(), c, p, s, mask, None), out


@pytest.mark.parametrize("c,p,s", SHAPES, ids=[f"c{c}-p{p}-s{s}" for c, p, s in SHAPES])
def test_emulated_ladder_rungs_hold_their_plain_versions(libs, c, p, s):
    X_np, d = kb.draw_inputs(c, p, s)  # the ladder's own inputs
    X, params = torch.from_numpy(X_np), params_from_numpy(d, "cpu")
    for rung in cb.RUNGS:
        ref = cb.plain_rung(rung, X, params)
        masks = _rung_masks(rung, p, s) if rung <= 8 else [ci.plan(p, s).mask]
        outs = []
        for mask in masks:
            err, out = _run_rung(libs[1], rung, X, params, mask)
            assert err == 0, (rung, mask)
            ok, got = cb.holds(cb.RUNGS[rung].contract, out, ref, cb.scale(rung, X, params, ref))
            assert ok, (rung, mask, got)
            outs.append(out)
        assert all(torch.equal(o, outs[0]) for o in outs[1:]), rung  # residency changes no bit
        # a mask with a group the rung does not read is refused
        for other in (1, 8, 16):
            if other & ~cb.group_bits(rung):
                assert _run_rung(libs[1], rung, X, params, other)[0] != 0, (rung, other)
    k1 = _run(libs[0], X[None], CellParams(*(t[None] for t in params)), ci.plan(p, s).mask)[0]
    assert torch.equal(outs[0], k1)  # rung 11 runs the kernel's body


@pytest.fixture(scope="module")
def threefry(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    lib = _build(cuda_prng.SRC, tmp_path_factory.mktemp("cuda_emu_threefry"))
    vp, cint = ctypes.c_void_p, ctypes.c_int
    lib.ms_threefry.argtypes = [vp, cint, ctypes.c_longlong, vp, cint, vp]
    lib.ms_threefry.restype = cint
    return lib


def _emulated_threefry(lib, keys: torch.Tensor, n: int, pair: bool) -> torch.Tensor:
    flat = keys.reshape(-1, 2).contiguous()
    out = torch.full(tuple(keys.shape[:-1]) + ((n, 2) if pair else (n,)), -1, dtype=torch.int64)
    assert lib.ms_threefry(flat.data_ptr(), flat.shape[0], n, out.data_ptr(), int(pair), None) == 0
    return out


@pytest.mark.parametrize("n", [1, 7, 256, 600])
@pytest.mark.parametrize("pair", [False, True], ids=["bits", "split"])
def test_emulated_threefry_is_bit_equal_to_its_plain_version(threefry, n, pair):
    keys = torch.stack([prng.prng_key(s) for s in (0, 42, 2**31 - 1, 2**40 + 3)])
    for k in (keys[1], keys, keys.reshape(2, 2, 2)):  # leading key axes
        out = _emulated_threefry(threefry, k, n, pair)
        ref = prng.hash_counters_plain(k, (n,), pair=pair)
        assert torch.equal(out, ref)
    assert (out >= 0).all() and (out <= 0xFFFFFFFF).all()


def test_emulated_threefry_refuses_what_it_does_not_take(threefry):
    keys = prng.prng_key(1)[None]
    out = torch.empty(4, dtype=torch.int64)
    assert threefry.ms_threefry(keys.data_ptr(), 1, 4, out.data_ptr(), 2, None) != 0
    assert threefry.ms_threefry(keys.data_ptr(), 1, 2**32, out.data_ptr(), 0, None) != 0


@pytest.fixture(scope="module")
def assemble(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    lib = _build(cuda_params.SRC, tmp_path_factory.mktemp("cuda_emu_assemble"))
    lib.ms_assemble_rows.argtypes = [ctypes.c_void_p] * 4
    lib.ms_assemble_rows.restype = ctypes.c_int
    lib.emu_set_flush_denormal(1)
    return lib


@pytest.mark.parametrize("p_r,d_r,P,s", [(16, 4, 16, 28), (16, 4, 32, 28), (8, 8, 8, 82), (7, 3, 12, 40)])
def test_emulated_assembly_is_bit_equal_to_its_plain_version(assemble, p_r, d_r, P, s):
    from test_torch_assemble import _abs_temp, _assert_bit_equal, _dense, _state, _tables

    tables = _tables(s, seed=s + P)
    dense = torch.from_numpy(_dense(5, p_r, d_r, seed=p_r * d_r))
    C = dense.shape[0] + 6
    rows = torch.randperm(C, generator=torch.Generator().manual_seed(P))[: dense.shape[0]]
    got, want = _state(C, P, s, seed=2), _state(C, P, s, seed=2)
    temp = _abs_temp()  # alive while the kernel reads it
    cuda_params._check(got, dense, tables, temp, rows)
    assert assemble.ms_assemble_rows(*cuda_params.launch_args(got, dense, tables, temp, rows),
                                     None) == 0
    plain_params.assemble_rows(want, dense, tables, temp, rows)
    _assert_bit_equal(got, want)


def test_emulated_assembly_refuses_a_rung_wider_than_the_state(assemble):
    from test_torch_assemble import _abs_temp, _dense, _state, _tables

    tables, dense = _tables(28, seed=1), torch.from_numpy(_dense(1, 16, 4, seed=1))
    state, rows, temp = _state(8, 8, 28, seed=1), torch.arange(5), _abs_temp()
    assert assemble.ms_assemble_rows(*cuda_params.launch_args(state, dense, tables, temp, rows),
                                     None) != 0


@pytest.mark.parametrize("fault", ["token", "row"])
def test_emulated_assembly_traps_on_a_token_or_row_outside_the_tables(assemble, fault):
    # a trap ends the emulated process, so the launch runs in a child
    script = f"""
import ctypes, sys
sys.path.insert(0, {str(Path(__file__).parent)!r})
import torch
from test_torch_assemble import _abs_temp, _dense, _state, _tables
from magicsoup_tpu_torch.ops import cuda_params
lib = ctypes.CDLL({assemble._name!r})
lib.ms_assemble_rows.argtypes = [ctypes.c_void_p] * 4
tables = _tables(28, seed=1)
dense = torch.from_numpy(_dense(1, 16, 4, seed=1))
state, rows, temp = _state(8, 16, 28, seed=1), torch.arange(5), _abs_temp()
if {fault!r} == "token":
    dense[0, 0, 0] = torch.tensor([1, 1, tables.km_weights.shape[0], 1, 1])
else:
    rows[1] = 8
print("returned", lib.ms_assemble_rows(*cuda_params.launch_args(state, dense, tables, temp, rows), None))
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).parents[1])
    assert proc.returncode != 0, proc.stdout
    assert "emulated __trap" in proc.stderr, proc.stderr[-2000:]
