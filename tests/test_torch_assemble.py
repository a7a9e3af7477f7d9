"""
Cell-parameter assembly's CUDA kernel (``ops/cuda_params.py``,
``csrc/assemble.cu``) against the plain ``ops/params.py::assemble_rows``.

On the CPU: the wrapper routes a CPU state to the plain version and
launches nothing, refuses what the kernel does not take and rows outside
the state, and
``Kinetics.scatter_dense`` writes the plain version's bits and counts its
rows; the audit's oracle stays the plain ``compute_cell_params``.  On a
card (``cuda`` marker; ``python -m pytest tests/test_torch_assemble.py -m
cuda``): the kernel's nine tensors bit-equal to the plain version's on the
card over whole rows, pad columns included, at the main path's rungs, on
edge tokens and in a World.  This file imports no JAX: the card tests
compare with the plain PyTorch version.
"""
import random

import numpy as np
import pytest
import torch

from magicsoup_tpu_torch import telemetry
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
from magicsoup_tpu_torch.kinetics import Kinetics
from magicsoup_tpu_torch.ops import cuda_params
from magicsoup_tpu_torch.ops import params as P
from magicsoup_tpu_torch.ops.integrate import INT_PARAM_DTYPE, CellParams
from magicsoup_tpu_torch.util import random_genome
from magicsoup_tpu_torch.world import World

#: rungs (p_r, d_r) and state capacities P of the card tests
RUNGS = ((16, 4), (32, 8), (64, 8), (128, 16))
CAPACITIES = (64, 128)
#: Wood-Ljungdahl's signals, and a width past one warp's lanes
SIGNALS = (28, 82)
#: tokens of the synthetic tables: scalar and vector
N1, N2 = 61, 3904


def _tables(s: int, seed: int) -> P.TokenTables:
    """Token tables of ``s`` signals drawn as the factories draw them
    (row 0 the empty token), with edge tokens 1-5 set by hand: hill 1 is
    70 (two such domains saturate |A| >= 128), sign 2 is -1, Km 1, 2, 3
    are 2, 1 and 0.5 (the saturated power's three limits); effector 1 is
    signal 0, and reaction 1 moves signal 1, whose energy of 1e12 drives
    Ke to either clamp."""
    rng = np.random.default_rng(seed)

    def lognorm(lo, hi):
        w = np.exp(rng.uniform(np.log(lo), np.log(hi), N1 + 1)).astype(np.float32)
        w[0] = np.nan
        return w

    km, vmax = lognorm(1e-2, 100.0), lognorm(1e-3, 100.0)
    signs = rng.choice(np.array([-1, 1], dtype=np.int32), N1 + 1)
    hills = rng.integers(1, 6, N1 + 1).astype(np.int32)
    reactions = (rng.integers(-2, 3, (N2 + 1, s)) * (rng.random((N2 + 1, s)) < 0.15)).astype(np.int32)
    half = s // 2
    mol = rng.integers(0, half, N2 + 1)
    transports = np.zeros((N2 + 1, s), dtype=np.int32)
    transports[np.arange(N2 + 1), mol] = -1
    transports[np.arange(N2 + 1), mol + half] = 1
    effectors = np.zeros((N2 + 1, s), dtype=np.int32)
    effectors[np.arange(N2 + 1), rng.integers(0, s, N2 + 1)] = 1
    energies = np.tile(rng.uniform(-2e5, 2e5, half), 2).astype(np.float32)
    hills[1], signs[1], signs[2] = 70, 1, -1
    km[1:4] = (2.0, 1.0, 0.5)
    effectors[1] = 0
    effectors[1, 0] = 1
    reactions[1] = 0
    reactions[1, 1] = 1
    energies[1] = energies[1 + half] = 1e12
    for t in (signs, hills, reactions, transports, effectors):
        t[0] = 0
    return P.TokenTables(*(torch.from_numpy(a) for a in (
        km, vmax, signs, hills, reactions, transports, effectors, energies)))


def _dense(b: int, p_r: int, d_r: int, seed: int) -> np.ndarray:
    """A token batch ``(b + 4, p_r, d_r, 5)``: b random cells (each with
    its own number of proteins and domains, zeros beyond them, as packing
    leaves them), then four edge cells: all zero; regulatory only, with
    A at +-140 over Km 2, 1 and 0.5 and a small negative A; catalytic
    with Ke at both clamps and a NaN-only Vmax; one domain of every type."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b + 4, p_r, d_r, 5), dtype=np.int16)
    for c in range(b):
        n_p = rng.integers(0, p_r + 1)
        n_d = rng.integers(1, d_r + 1, n_p)
        for j in range(n_p):
            out[c, j, : n_d[j], 0] = rng.integers(1, 4, n_d[j])
            out[c, j, : n_d[j], 1:4] = rng.integers(0, N1 + 1, (n_d[j], 3))
            out[c, j, : n_d[j], 4] = rng.integers(0, N2 + 1, n_d[j])
    reg = out[b + 1]
    reg[0, :, 0] = 3
    reg[0, :, 1:] = rng.integers(1, N1 + 1, (d_r, 4))
    for j, (km, sign) in enumerate(((1, 1), (2, 1), (3, 1), (1, 2), (3, 2)), start=1):
        reg[j, :2] = (3, 1, km, sign, 1)
    reg[6, 0] = (3, 5, 3, 2, 1)
    cat = out[b + 2]
    cat[0, 0] = (1, 1, 1, 1, 1)
    cat[1, 0] = (1, 1, 1, 2, 1)
    cat[2, :2] = (1, 0, 0, 0, 1)
    out[b + 3, 0, :3] = ((1, 4, 4, 4, 9), (2, 5, 5, 5, 10), (3, 6, 6, 6, 11))
    return out


def _state(C: int, P_: int, s: int, seed: int, device="cpu") -> CellParams:
    """State tensors at capacity filled with noise, so rows and columns
    that a call must not touch show it if it does."""
    g = torch.Generator().manual_seed(seed)

    def f32(*shape):
        return torch.rand(shape, generator=g).to(device)

    def i16(*shape):
        return torch.randint(-9, 9, shape, generator=g, dtype=INT_PARAM_DTYPE).to(device)

    return CellParams(f32(C, P_), f32(C, P_), f32(C, P_), f32(C, P_, s), f32(C, P_),
                      i16(C, P_, s), i16(C, P_, s), i16(C, P_, s), i16(C, P_, s))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).cpu()


def _assert_bit_equal(got: CellParams, want: CellParams) -> None:
    for name, a, b in zip(CellParams._fields, got, want):
        assert torch.equal(_bits(a), _bits(b)), f"{name} differs"


def _abs_temp(device="cpu") -> torch.Tensor:
    return torch.tensor(310.0, dtype=torch.float32, device=device)


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("p_r,d_r,P_", [(16, 4, 64), (8, 8, 8)])
def test_wrapper_routes_cpu_tensors_to_the_plain_version(p_r, d_r, P_):
    tables = _tables(28, seed=1)
    dense = _dense(6, p_r, d_r, seed=2)
    rows = np.random.default_rng(3).permutation(20)[: len(dense)]
    got, want = _state(20, P_, 28, seed=4), _state(20, P_, 28, seed=4)
    before = cuda_params.launches
    cuda_params.assemble_rows(got, dense, tables, _abs_temp(), rows)
    assert cuda_params.launches == before
    P.assemble_rows(want, torch.from_numpy(dense), tables, _abs_temp(), torch.from_numpy(rows))
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("fault,error", [
    ("dense_dtype", TypeError),
    ("dense_tensor", TypeError),
    ("rows_dtype", TypeError),
    ("rows_length", ValueError),
    ("row_negative", IndexError),
    ("row_past_the_state", IndexError),
])
def test_the_wrapper_refuses_a_host_batch_it_does_not_take(fault, error):
    state, tables = _state(8, 16, 28, seed=4), _tables(28, seed=1)
    dense, rows = _dense(2, 16, 4, seed=2), np.arange(6)
    if fault == "dense_dtype":
        dense = dense.astype(np.int32)
    elif fault == "dense_tensor":
        dense = torch.from_numpy(dense)
    elif fault == "rows_dtype":
        rows = rows.astype(np.int32)
    elif fault == "rows_length":
        rows = rows[:-1]
    elif fault == "row_negative":
        rows[2] = -1
    elif fault == "row_past_the_state":
        rows[2] = 8
    want = CellParams(*(t.clone() for t in state))
    with pytest.raises(error):
        cuda_params.assemble_rows(state, dense, tables, _abs_temp(), rows)
    _assert_bit_equal(state, want)


def _refusal_case():
    tables = _tables(28, seed=1)
    dense = torch.from_numpy(_dense(2, 16, 4, seed=2))
    return _state(8, 16, 28, seed=4), dense, tables, _abs_temp(), torch.arange(6)


@pytest.mark.parametrize("fault,error", [
    ("dense_dtype", TypeError),
    ("dense_strided", ValueError),
    ("rows_dtype", TypeError),
    ("rows_length", ValueError),
    ("state_dtype", TypeError),
    ("state_strided", ValueError),
    ("table_width", ValueError),
    ("too_many_proteins", ValueError),
])
def test_the_kernel_wrapper_refuses_what_it_does_not_take(fault, error):
    state, dense, tables, temp, rows = _refusal_case()
    if fault == "dense_dtype":
        dense = dense.to(torch.int32)
    elif fault == "dense_strided":
        dense = dense.transpose(1, 2)
    elif fault == "rows_dtype":
        rows = rows.to(torch.int32)
    elif fault == "rows_length":
        rows = rows[:-1]
    elif fault == "state_dtype":
        state = state._replace(Ke=state.Ke.double())
    elif fault == "state_strided":
        state = state._replace(Kmr=state.Kmr.transpose(0, 1).contiguous().transpose(0, 1))
    elif fault == "table_width":
        tables = tables._replace(effectors=tables.effectors[:, :20].contiguous())
    elif fault == "too_many_proteins":
        state = _state(8, 8, 28, seed=4)
    with pytest.raises(error):
        cuda_params._check(state, dense, tables, temp, rows)


def test_the_wrapper_refuses_a_device_without_a_kernel():
    state, dense, tables, temp, rows = _refusal_case()
    meta = CellParams(*(t.to("meta") for t in state))
    with pytest.raises(ValueError, match="no assembly kernel"):
        cuda_params.assemble_rows(meta, dense.numpy(), tables, temp, rows.numpy())
    with pytest.raises(ValueError, match="no assembly kernel"):
        cuda_params.launch(state, dense, tables, temp, rows)


def test_the_kernel_builds_without_fused_multiply_add():
    # eager PyTorch rounds det_div's and det_exp's products and sums apart
    assert "--fmad=false" in cuda_params.NVCC_FLAGS
    assert "--use_fast_math" not in cuda_params.NVCC_FLAGS


def _kinetics(seed: int = 5) -> Kinetics:
    kin = Kinetics(chemistry=CHEMISTRY, device="cpu", seed=seed,
                   scalar_enc_size=N1, vector_enc_size=N2)
    kin.ensure_capacity(n_cells=40, n_proteins=64)
    kin.max_doms = 8
    return kin


@pytest.mark.parametrize("chunk", [None, 4])
def test_scatter_dense_on_the_cpu_writes_the_plain_versions_bits(chunk, monkeypatch):
    kin = _kinetics()
    if chunk is not None:
        monkeypatch.setattr(cuda_params, "_assembly_chunk", lambda p, d, s: chunk)
    dense = _dense(9, 16, 4, seed=6)
    rows = np.random.default_rng(7).permutation(40)[: len(dense)]
    want = CellParams(*(t.clone() for t in kin.params))
    P.assemble_rows(want, torch.from_numpy(dense), kin.tables, kin._abs_temp_t,
                    torch.from_numpy(rows))
    before = cuda_params.launches
    kin.scatter_dense(rows, dense)
    assert cuda_params.launches == before
    _assert_bit_equal(kin.params, want)


def test_scatter_dense_on_the_cpu_counts_rows_and_no_kernel_rows():
    kin = _kinetics()
    dense = _dense(5, 16, 4, seed=8)
    base = telemetry.counter_totals()
    kin.scatter_dense(np.arange(len(dense)), dense)
    kin.scatter_dense(np.arange(3), dense[:3])
    got = telemetry.counter_totals()
    assert got.get("assembly.rows", 0) - base.get("assembly.rows", 0) == len(dense) + 3
    for name in ("assembly.kernel_rows", "assembly.launches"):
        assert got.get(name, 0) == base.get(name, 0)


def _world(device: str, n: int = 40, seed: int = 11) -> World:
    rng = random.Random(seed)
    world = World(chemistry=CHEMISTRY, map_size=32, seed=seed, device=device)
    world.spawn_cells([random_genome(s=400, rng=rng) for _ in range(n)])
    return world


def test_the_audit_compares_with_the_plain_compute_cell_params(monkeypatch):
    from magicsoup_tpu_torch.check import audit_world

    world = _world("cpu")
    calls = []
    plain = P.compute_cell_params

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(P, "compute_cell_params", spy)
    before = cuda_params.launches
    assert audit_world(world, sample=world.n_cells) == []
    assert calls and cuda_params.launches == before


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the assembly kernel has no CPU mode")
    return torch.device("cuda")


def _on(x, device):
    return type(x)(*(t.to(device) for t in x))


@pytest.mark.cuda
@pytest.mark.parametrize("s", SIGNALS)
@pytest.mark.parametrize("P_", CAPACITIES)
@pytest.mark.parametrize("p_r,d_r", RUNGS)
def test_kernel_bit_equal_to_the_plain_version_on_the_card(card, p_r, d_r, P_, s):
    if p_r > P_:
        pytest.skip(f"a rung of {p_r} proteins does not fit a capacity of {P_}")
    tables = _on(_tables(s, seed=p_r + s), card)
    dense_np = _dense(60, p_r, d_r, seed=P_ + d_r)
    C = len(dense_np) + 17
    rows_np = np.random.default_rng(s).permutation(C)[: len(dense_np)]
    dense, rows = torch.from_numpy(dense_np).to(card), torch.from_numpy(rows_np).to(card)
    got, want = _state(C, P_, s, seed=1, device=card), _state(C, P_, s, seed=1, device=card)
    before = cuda_params.launches
    cuda_params.assemble_rows(got, dense_np, tables, _abs_temp(card), rows_np)
    assert cuda_params.launches == before + 1
    P.assemble_rows(want, dense, tables, _abs_temp(card), rows)
    torch.cuda.synchronize()
    _assert_bit_equal(got, want)
    # the edge cells reach what they were built for
    edge = rows[-3:-1].cpu()
    Ke = want.Ke[rows[-2]].cpu()
    assert Ke[0] == np.float32(1e-36) and Ke[1] == np.float32(1e36)
    assert want.Vmax[rows[-2], 2].item() == 0.0
    A = want.A[edge[0], :, 0].cpu()
    assert A[1] == 140 and A[4] == -140 and A[6] < 0
    Kmr = want.Kmr[edge[0], :, 0].cpu()
    assert Kmr[1] == float("inf") and Kmr[2] == 1.0 and Kmr[3] == 0.0
    assert Kmr[4] == 0.0 and Kmr[5] == float("inf")


@pytest.mark.cuda
def test_the_kernel_refuses_what_it_does_not_take_on_the_card(card):
    state, dense, tables, temp, rows = _refusal_case()
    state, tables, temp = _on(state, card), _on(tables, card), temp.to(card)
    host = dense.numpy(), rows.numpy()
    past = host[1].copy()
    past[0] = state.Vmax.shape[0]
    strided = state._replace(Kmr=state.Kmr.transpose(0, 1).contiguous().transpose(0, 1))
    before = cuda_params.launches
    for st, d, r, error in [
        (state, host[0].astype(np.int32), host[1], TypeError),
        (state, host[0], host[1].astype(np.int32), TypeError),
        (state, host[0], past, IndexError),
        (strided, *host, ValueError),
    ]:
        with pytest.raises(error):
            cuda_params.assemble_rows(st, d, tables, temp, r)
    dense, rows = dense.to(card), rows.to(card)
    for d, r, error in [
        (dense.to(torch.int32), rows, TypeError),
        (dense.transpose(1, 2), rows, ValueError),
        (dense, rows.to(torch.int32), TypeError),
        (dense.cpu(), rows, ValueError),
    ]:
        with pytest.raises(error):
            cuda_params.launch(state, d, tables, temp, r)
    assert cuda_params.launches == before


@pytest.mark.cuda
def test_a_world_on_the_card_holds_the_plain_versions_rows(card, monkeypatch):
    from magicsoup_tpu_torch.check import audit_world

    def evolve(world):
        for _ in range(3):
            world.mutate_cells(p=1e-3)
        world.recombinate_cells(p=1e-4)
        return world

    base = telemetry.counter_totals()
    before = cuda_params.launches
    kernel = evolve(_world("cuda", n=300))
    counts = telemetry.counter_totals()
    launched = cuda_params.launches - before
    assert launched >= 1
    assert counts["assembly.launches"] - base.get("assembly.launches", 0) == launched
    rows = counts["assembly.rows"] - base.get("assembly.rows", 0)
    assert counts["assembly.kernel_rows"] - base.get("assembly.kernel_rows", 0) == rows
    # the same world with every assembly through the plain version on the card
    def plain_rows(state, dense, tables, abs_temp, cell_idxs):
        P.assemble_rows(state, torch.from_numpy(dense).to(card), tables, abs_temp,
                        torch.from_numpy(cell_idxs).to(card))

    monkeypatch.setattr(cuda_params, "assemble_rows", plain_rows)
    plain = evolve(_world("cuda", n=300))
    assert cuda_params.launches - before == launched
    assert kernel.cell_genomes == plain.cell_genomes
    _assert_bit_equal(kernel.kinetics.params, plain.kinetics.params)
    assert audit_world(kernel, sample=kernel.n_cells) == []
