"""
Cell-parameter assembly in plain PyTorch: dense domain-token tensors ->
the 9 kinetic parameter tensors, plus the row scatter/copy/compaction
helpers used for slot-based state updates.

Counterpart of :mod:`magicsoup_tpu.ops.params`, with the same math:
Vmax nanmean over domains, allosteric A = sum(effector*sign*hill),
Kmr = nanmean(Km_reg per signal)^A, stoichiometry N split into Nf/Nb to
preserve zero-net cofactors, Ke = exp(-(N.E)/(R.T)) clamped, and the
Kmf/Kmb split that puts the sampled Km on the smaller side of the
equilibrium.  The assembly uses only the deterministic primitives of
:mod:`magicsoup_tpu_torch.ops.detmath`, so its result is bit-equal to the
JAX package's on the CPU.

The JAX package pads index batches to powers of two so that XLA compiles
few variants; PyTorch compiles nothing, so batches here keep their length
and need no out-of-bounds padding.  The one exception is the token genome
programs (:mod:`magicsoup_tpu_torch.genomes`): they draw random numbers
over the padded index list, so its length is part of their result, and
they pad with :func:`pad_idxs` as the JAX package does.
"""
from typing import NamedTuple

import numpy as np
import torch

from magicsoup_tpu_torch.constants import EPS, GAS_CONSTANT, MAX
from magicsoup_tpu_torch.ops.detmath import (
    det_div,
    det_exp,
    flush_denormal,
    ipow,
    sum_axis,
)
from magicsoup_tpu_torch.ops.integrate import INT_PARAM_DTYPE, CellParams

# floors of the per-cell assembly rung grid: cells are grouped by the pow2
# sizes that cover their proteome and assembled at that rung instead of
# the world's grow-only worst-case capacities
RUNG_P_MIN = 16
RUNG_D_MIN = 4

# live-row prefix quantum for integrator dispatches: the integrator runs
# over the live rows rounded up to this quantum, not the whole capacity
ROW_QUANTUM = 1024

# the JAX package folds rung groups smaller than its 256-row scatter floor
# into the full-capacity program; the port keeps the same grouping, so the
# same cells take the same (bit-identical) path
IDX_BLOCK = 256


class TokenTables(NamedTuple):
    """Token -> parameter lookup tables (row 0 = empty/zero token)."""

    km_weights: torch.Tensor  # (T1+1,) f32, NaN at 0
    vmax_weights: torch.Tensor  # (T1+1,) f32, NaN at 0
    signs: torch.Tensor  # (T1+1,) i32, 0 at 0
    hills: torch.Tensor  # (T1+1,) i32, 0 at 0
    reactions: torch.Tensor  # (T2+1, s) i32 signed stoichiometry vectors
    transports: torch.Tensor  # (T2+1, s) i32 in/out transport vectors
    effectors: torch.Tensor  # (T2+1, s) i32 one-hot effector vectors
    mol_energies: torch.Tensor  # (s,) f32 molecule energies (duplicated x2)


def pad_pow2(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum)"""
    m = max(n, minimum)
    return 1 << (m - 1).bit_length()


def pad_idxs(idxs: np.ndarray, oob: int, minimum: int = IDX_BLOCK) -> np.ndarray:
    """Pad an int index array to a power-of-two length (at least
    ``minimum``) with the out-of-bounds fill ``oob`` (int32)."""
    n = pad_pow2(len(idxs), minimum)
    out = np.full(n, oob, dtype=np.int32)
    out[: len(idxs)] = idxs
    return out


def quantize_rows(n: int, cap: int, quantum: int = ROW_QUANTUM) -> int:
    """Smallest multiple of ``quantum`` >= n, clamped to ``cap``."""
    if n >= cap:
        return cap
    return min(cap, max(quantum, -(-n // quantum) * quantum))


def next_rung(rung: int, cap: int) -> int:
    """The row-ladder rung above ``rung`` (== ``rung`` at the cap): the
    one rule for 'warm one rung ahead'."""
    return quantize_rows(rung + 1, cap) if rung < cap else rung


def rung_pow2(values: np.ndarray, minimum: int, cap: int) -> np.ndarray:
    """Vectorized pow2 rung per value, floored at ``minimum`` and clamped
    to ``cap`` — the group key of the rung-grouped assembly."""
    v = np.maximum(np.asarray(values, dtype=np.int64), 1)
    rung = np.power(2, np.ceil(np.log2(v)).astype(np.int64))
    return np.minimum(np.maximum(rung, minimum), cap).astype(np.int64)


def flat_to_dense(
    prot_counts: np.ndarray,
    prots: np.ndarray,
    doms: np.ndarray,
    n_prots_cap: int,
    n_doms_cap: int | None = None,
) -> tuple[np.ndarray, int]:
    """
    Vectorized scatter of the genome engine's flat buffers into one dense
    int16 tensor (b, n_prots_cap, n_doms_cap, 5) holding
    ``[dom_type, i0, i1, i2, i3]`` per domain (0 = padding).  Returns the
    dense tensor and the (possibly padded) domain capacity.
    """
    b = len(prot_counts)
    n_doms_per_prot = prots[:, 3] if len(prots) else np.zeros(0, dtype=np.int32)
    max_doms = int(n_doms_per_prot.max()) if len(prots) else 1
    if n_doms_cap is None:
        n_doms_cap = pad_pow2(max_doms, minimum=1)

    dense = np.zeros((b, n_prots_cap, n_doms_cap, 5), dtype=np.int16)
    if len(doms) == 0:
        return dense, n_doms_cap

    prot_cell = np.repeat(np.arange(b, dtype=np.int64), prot_counts)
    prot_starts = np.concatenate([[0], np.cumsum(prot_counts)])[:-1]
    prot_in_cell = np.arange(len(prots), dtype=np.int64) - np.repeat(
        prot_starts, prot_counts
    )
    dom_prot = np.repeat(np.arange(len(prots), dtype=np.int64), n_doms_per_prot)
    dom_starts = np.concatenate([[0], np.cumsum(n_doms_per_prot)])[:-1]
    dom_in_prot = np.arange(len(doms), dtype=np.int64) - np.repeat(
        dom_starts, n_doms_per_prot
    )

    dense[prot_cell[dom_prot], prot_in_cell[dom_prot], dom_in_prot] = doms[:, :5]
    return dense, n_doms_cap


def _nan_to(x: torch.Tensor, mask: torch.Tensor, value: float) -> torch.Tensor:
    return torch.where(mask, x, torch.full_like(x, value))


def _nanmean0(x: torch.Tensor, dim: int) -> torch.Tensor:
    """nanmean with all-NaN slices giving 0, from the fixed-order sum"""
    mask = ~torch.isnan(x)
    total = sum_axis(_nan_to(x, mask, 0.0), dim)
    count = mask.sum(dim)
    mean = det_div(total, torch.clamp(count, min=1).to(total.dtype))
    return torch.where(count > 0, mean, torch.zeros_like(mean))


_GAS: dict = {}


def _gas_constant(device: torch.device) -> torch.Tensor:
    """The gas constant as a float32 scalar on ``device``, made once: a
    host->device copy per assembly would synchronize the card's stream."""
    t = _GAS.get(device)
    if t is None:
        t = _GAS[device] = torch.tensor(GAS_CONSTANT, dtype=torch.float32, device=device)
    return t


def compute_cell_params(
    dense: torch.Tensor,  # (b, p, d, 5) i16 [dom_type, i0, i1, i2, i3]
    tables: TokenTables,
    abs_temp: torch.Tensor,
) -> CellParams:
    """
    Map domain tokens to concrete values and aggregate them into the 9
    per-cell parameter tensors for a batch of b cells.
    """
    with flush_denormal(dense.device):
        return _compute_cell_params(dense, tables, abs_temp)


def _compute_cell_params(dense, tables: TokenTables, abs_temp) -> CellParams:
    dense = dense.long()
    dom_types = dense[..., 0]
    idxs0 = dense[..., 1]
    idxs1 = dense[..., 2]
    idxs2 = dense[..., 3]
    idxs3 = dense[..., 4]

    # 1=catalytic, 2=transporter, 3=regulatory
    is_catal = dom_types == 1
    is_trnsp = dom_types == 2
    is_reg = dom_types == 3
    not_reg = (is_catal | is_trnsp).long()

    # scalar tokens; zeroed indices hit the empty row (NaN / 0)
    Vmaxs = tables.vmax_weights[idxs0 * not_reg]  # (b,p,d) f32
    Hills = tables.hills[idxs0 * is_reg.long()]  # (b,p,d) i32
    Kms = tables.km_weights[idxs1]  # (b,p,d) f32
    signs = tables.signs[idxs2]  # (b,p,d) i32

    # vector tokens
    reacts = tables.reactions[idxs3 * is_catal.long()]  # (b,p,d,s)
    trnspts = tables.transports[idxs3 * is_trnsp.long()]
    effectors = tables.effectors[idxs3 * is_reg.long()]

    # Vmax: average over defined domains
    Vmax = _nanmean0(Vmaxs, 2)  # (b,p)

    # allosteric exponents: effector vectors weighted by sign*hill
    A = (effectors * (signs * Hills)[..., None]).sum(2)  # (b,p,s)

    # regulatory Kms separated per effector signal, averaged over domains
    Kmr_d = _nan_to(Kms, is_reg, float("nan"))  # (b,p,d)
    Kmr_ds = effectors.to(torch.float32) * Kmr_d[..., None]  # (b,p,d,s)
    Kmr_ds = _nan_to(Kmr_ds, Kmr_ds != 0.0, float("nan"))  # effectors add 0s
    Kmr = _nanmean0(Kmr_ds, 2)  # (b,p,s)
    Kmr = ipow(Kmr, A)  # pre-exponentiated by hill

    # stoichiometry; Nf/Nb split keeps zero-net cofactors alive
    N_d = (reacts + trnspts) * signs[..., None]  # (b,p,d,s)
    zero = torch.zeros_like(N_d)
    N = N_d.sum(2)
    Nf = torch.where(N_d < 0, -N_d, zero).sum(2)
    Nb = torch.where(N_d > 0, N_d, zero).sum(2)

    # Km of catalytic/transporter domains
    Kmn = _nanmean0(_nan_to(Kms, ~is_reg, float("nan")), 2)  # (b,p)

    # energies -> equilibrium constant, clamped against Inf/0
    E = sum_axis(N.to(torch.float32) * tables.mol_energies, 2)
    Ke = torch.clamp(
        det_exp(det_div(det_div(-E, abs_temp), _gas_constant(E.device))), EPS, MAX
    )

    # sampled Km defines the smaller side of Ke = Kmf/Kmb
    is_fwd = Ke >= 1.0
    Kmf = torch.clamp(torch.where(is_fwd, Kmn, det_div(Kmn, Ke)), EPS, MAX)
    Kmb = torch.clamp(torch.where(is_fwd, Kmn * Ke, Kmn), EPS, MAX)

    def narrow(x: torch.Tensor) -> torch.Tensor:
        # saturating: domain sums only approach +-2^15 for ~80kb genomes
        return torch.clamp(x, -32768, 32767).to(INT_PARAM_DTYPE)

    return CellParams(
        Ke=Ke, Kmf=Kmf, Kmb=Kmb, Kmr=Kmr, Vmax=Vmax,
        N=narrow(N), Nf=narrow(Nf), Nb=narrow(Nb), A=narrow(A),
    )


def assemble_rows(
    state: CellParams,
    dense: torch.Tensor,
    tables: TokenTables,
    abs_temp: torch.Tensor,
    cell_idxs: torch.Tensor,
) -> None:
    """:func:`compute_cell_params` at the dense batch's OWN (p, d) rung,
    padded out to the state's protein capacity with the values an
    all-zero token slot gives (Ke=1, Kmf=Kmb=EPS, Kmr=1, the rest 0), then
    written into ``state`` rows ``cell_idxs`` in place — bit-identical to
    assembling every cell at the full capacities."""
    batch = compute_cell_params(dense, tables, abs_temp)
    pad = state.Vmax.shape[1] - batch.Vmax.shape[1]
    b = dense.shape[0]
    if pad:
        fills = compute_cell_params(
            torch.zeros((1, 1, 1, 5), dtype=dense.dtype, device=dense.device),
            tables,
            abs_temp,
        )
        batch = CellParams(
            *(
                torch.cat(
                    [x, f[:, :1].expand((b, pad) + tuple(x.shape[2:]))], dim=1
                )
                for x, f in zip(batch, fills)
            )
        )
    for s, x in zip(state, batch):
        s[cell_idxs] = x


def unset_rows(state: CellParams, cell_idxs: torch.Tensor) -> None:
    """Zero parameter rows at ``cell_idxs`` in place (a fill, which takes
    the zero as a kernel argument: ``s[idx] = 0`` would upload it, and on
    a card that copy synchronizes)."""
    for s in state:
        s.index_fill_(0, cell_idxs, 0)


def copy_rows(state: CellParams, from_idxs: torch.Tensor, to_idxs: torch.Tensor) -> None:
    """Copy parameter rows ``from_idxs`` -> ``to_idxs`` in place (the
    source rows are gathered before any row is written)."""
    for s in state:
        s[to_idxs] = s[from_idxs]


def compact_rows(arr: torch.Tensor, perm: torch.Tensor, n_keep) -> torch.Tensor:
    """Gather rows by a full-capacity permutation and zero rank >= n_keep —
    the one implementation of stable compaction-on-kill, shared by every
    per-cell tensor.  ``n_keep`` is an int or a device scalar (read
    without a host synchronization)."""
    out = arr[perm]
    if torch.is_tensor(n_keep):
        rank = torch.arange(perm.shape[0], device=arr.device)
        drop = (rank >= n_keep).view((-1,) + (1,) * (out.ndim - 1))
        return out.masked_fill(drop, 0)
    out[n_keep:] = 0
    return out


def gather_live_rows(dst: torch.Tensor, src: torch.Tensor, keep: torch.Tensor, dirty: int) -> int:
    """Stable compaction of the live rows into another buffer, the kill
    path of a world that knows its live count on the host: ``dst[j] =
    src[keep[j]]`` for ``j < len(keep)``, then rows ``len(keep)`` to
    ``dirty`` of ``dst`` zeroed.  Rows of ``dst`` from ``dirty`` on must be
    zero already, and stay untouched; so does ``src``.  Equal, over the
    rows it leaves, to :func:`compact_rows` by the permutation that puts
    ``keep`` first.  Returns the rows written."""
    n_keep = keep.shape[0]
    torch.index_select(src, 0, keep, out=dst[:n_keep])
    dst[n_keep:dirty].zero_()  # empty where dirty <= n_keep
    return max(n_keep, dirty)


def compact_live(arr: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """:func:`gather_live_rows` into a new tensor: the rows ``keep`` of
    ``arr`` first, zeros after them."""
    out = torch.empty_like(arr)
    gather_live_rows(out, arr, keep, arr.shape[0])
    return out


def permute_params(state: CellParams, perm, n_keep, mesh=None) -> CellParams:
    """:func:`compact_rows` over all nine parameter tensors.  Under a
    ``mesh`` ``state`` is this rank's slot block and ``perm`` the host
    permutation: a compacted row's new slot may lie on another rank, so
    the rows that cross a tile boundary travel between the ranks
    (:func:`magicsoup_tpu_torch.parallel.tiled.compact_block`)."""
    if mesh is not None:
        from magicsoup_tpu_torch.parallel.tiled import compact_block

        return CellParams(*(compact_block(mesh, s, perm, n_keep) for s in state))
    return CellParams(*(compact_rows(s, perm, n_keep) for s in state))


def write_new_rows(
    t: torch.Tensor, n_rows: torch.Tensor, values: torch.Tensor, count: torch.Tensor
) -> None:
    """Append rows at each world's high-water mark, in place and without
    a host synchronization: ``t[w, n_rows[w] + j] = values[w, j]`` for
    ``j < count[w]``, ``t`` being ``(B, cap, ...)``.  The JAX package
    scatters with out-of-bounds drops; here a window of ``D =
    values.shape[1] <= cap`` distinct rows starting at ``n_rows[w]``
    (wrapping mod cap) is written, its entries past ``count[w]`` with
    their row's own current value, so every write is unique and exact."""
    B, cap = t.shape[:2]
    D = values.shape[1]
    j = torch.arange(D, device=t.device)
    dst = (n_rows[:, None] + j) % cap
    bidx = torch.arange(B, device=t.device)[:, None].expand(B, D)
    keep = (j[None, :] < count[:, None]).view((B, D) + (1,) * (t.ndim - 2))
    t[bidx, dst] = torch.where(keep, values, t[bidx, dst])
