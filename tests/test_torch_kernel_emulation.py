"""
The CUDA sources of the integrator kernel (``csrc/integrate.cu``), of
its ladder (``csrc/bisect.cu``) and of the threefry draw
(``csrc/threefry.cu``), compiled with g++ against a CPU stand-in
for the CUDA runtime (``torch_data/cuda_emu/cuda_runtime.h``: each CTA
runs as one thread per CUDA thread, with real barriers) and held against
their plain versions on the CPU.  So the kernels' logic -- the staging of
a tile's parameters, the launch plan's layouts, both lane mappings, the
tile's vote, the world stride -- is tested without a card, and the C
side's shared-memory bytes against the Python launch plan's.

glibc's expf/logf round differently from the card's, so the outputs are
held to the fast contract (the ladder's rungs to their own contracts);
bits are compared only between launches of the emulated kernels (every
residency mask, each world against its own launch, each group of a
grouped launch against its own launch, each ladder rung across the masks
the launch plan can pick for its groups, rung 11 against the kernel).  The threefry kernel's work is
integer only, so it is held bit-equal to its plain version
(``ops/prng.py``): both output modes, several keys, counts that are not
a multiple of the block, and one element.  On the card chip_smoke.py
holds the kernels themselves.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from magicsoup_tpu_torch.interop import params_from_numpy
from magicsoup_tpu_torch.ops import cuda_bisect as cb
from magicsoup_tpu_torch.ops import cuda_integrate as ci
from magicsoup_tpu_torch.ops import cuda_prng, prng
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
    integrate.ms_integrate_signals.argtypes = [vp] * 11 + [cint] * 4 + [ctypes.c_longlong, cint, vp]
    integrate.ms_integrate_signals.restype = cint
    integrate.ms_integrate_smem_bytes.argtypes = [cint] * 3
    integrate.ms_integrate_smem_bytes.restype = size
    integrate.ms_integrate_signals_grouped.argtypes = [cint, vp, vp, vp, ctypes.POINTER(cint), vp]
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


def _run(lib, X, params, mask: int) -> torch.Tensor:
    B, c, s = X.shape
    out = torch.empty_like(X)
    err = lib.ms_integrate_signals(
        X.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(),
        B, c, params.Ke.shape[-1], s, ci._check(X, params), mask, None,
    )
    assert err == 0
    return out


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


def _run_grouped(lib, Xs, params_list, masks) -> tuple[list, int]:
    outs = [torch.empty_like(X) for X in Xs]
    args = ci.grouped_args(Xs, params_list, outs, masks,
                           [ci._check(X, p) for X, p in zip(Xs, params_list)])
    launched = ctypes.c_int(-1)
    assert lib.ms_integrate_signals_grouped(
        args.n, args.ptrs, args.dims, args.pstrides, ctypes.byref(launched), None) == 0
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
