"""
Device-resident pipelined stepping: the whole selection workload step —
spawn, activity, threshold selection, kill, divide (with on-device child
placement), degradation/diffusion/permeation — runs on the device with no
host round trip, and the host replays each step's small packed output
record (selection masks, child/spawn placements) a few steps behind.
Counterpart of :mod:`magicsoup_tpu.stepper`.

The step body is written once over a leading WORLD axis ``B``: every state
tensor, parameter tensor and per-world constant carries it, placement
conflict tables and PRNG keys are per world, and nothing reduces across
worlds.  The solo :class:`PipelinedStepper` runs ``B = 1``; a fleet rung
group (:mod:`magicsoup_tpu_torch.fleet`) runs ``B = block``, so each phase
is one set of launches for the whole group and the integrator one launch
per simulated step.  In deterministic mode world w of a group is
bit-equal to the same world stepped alone.

The body is shape-static, as the JAX package's traced program is: no
``nonzero``, no boolean-mask indexing, no ``.item()`` and no Python branch
on a device value, so enqueueing a dispatch never waits for the card.
Out-of-bounds "drop" scatters of the JAX package become scatters into one
spare sink row or pixel, sliced off after; ``jnp.nonzero(size=...)`` is a
cumsum-and-scatter of static size.  Host inputs reach the card through
pinned memory without a synchronization, and the record comes back
through a non-blocking copy into pinned memory, waited on through a CUDA
event on the fetch thread.

Semantics against the serial loop are the JAX package's (phenotype lag,
spawn-decision lag, slot indices between flushes, bounded placement);
with ``lag`` an integer a seed reproduces its trajectory exactly.

A token world (``genome_backend="token"``) keeps its genomes on the
device: the stepper checks out a clone of the world's
:class:`~magicsoup_tpu_torch.genomes.GenomeStore`, replays spawns,
divisions and compactions as store programs, runs evolution inline as the
token programs (no evolution worker; the draws are threefry kernel
launches on the card), and hands the store's tensors back at ``flush()``.

The guard and telemetry planes ride the host half only, as in the JAX
package: the stepper shares the world's
:class:`~magicsoup_tpu_torch.telemetry.TelemetryRecorder` (a ``dispatch``
row per dispatch, a ``step`` row per replayed record, built from the
record's host scalars and host bookkeeping, so the enqueue stays
sync-free), retries a transient dispatch failure (``dispatch_retries``)
only while nothing of the dispatch has been enqueued, probes the
``dispatch`` and ``fetch`` fault points of
:mod:`~magicsoup_tpu_torch.guard.chaos`, and bounds each record fetch by
``MAGICSOUP_GUARD_FETCH_TIMEOUT``.  Attaching a recorder or arming a fault
leaves the device program unchanged.

Left out of this port: mesh-placed worlds.
"""
import contextlib
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from magicsoup_tpu_torch.analysis import runtime as _runtime
from magicsoup_tpu_torch.check.invariants import MASS_DRIFT_RTOL as _MASS_DRIFT_RTOL
from magicsoup_tpu_torch.guard import chaos as _chaos
from magicsoup_tpu_torch.guard.sentinel import NEG_EPS as _SENTINEL_NEG_EPS
from magicsoup_tpu_torch.native import engine as _engine
from magicsoup_tpu_torch.ops import backends as _backends
from magicsoup_tpu_torch.ops import detmath as _detmath
from magicsoup_tpu_torch.ops import diffusion as _diff
from magicsoup_tpu_torch.ops import prng as _prng
from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.telemetry import TelemetryRecorder
from magicsoup_tpu_torch.telemetry import metrics as _metrics
from magicsoup_tpu_torch.telemetry.recorder import note_fetch
from magicsoup_tpu_torch.ops.params import (
    compact_rows,
    compute_cell_params,
    permute_params,
    quantize_rows,
    write_new_rows,
)
from magicsoup_tpu_torch.util import (
    fetch_host,
    moore_pairs,
    random_genome,
    randstr,
    register_exit_join,
)


class StepOutputs(NamedTuple):
    """The per-step device->host record, as host numpy after unpacking."""

    kill: Any  # (cap,) bool — rows killed this step
    parents: Any  # (max_div,) rows that divided (cap = none)
    child_pos: Any  # (max_div, 2) child pixels
    n_placed: int  # successful divisions
    n_candidates: int  # division candidates before the budget clamp
    n_attempted: int  # candidates after the budget clamp (cost payers)
    spawn_ok: Any  # (spawn_block,) bool — which queued spawns landed
    spawn_pos: Any  # (spawn_block, 2) spawn pixels
    n_rows: int  # high-water row count after the step
    n_alive: int  # live cells after the step
    n_occupied: int  # occupied map pixels after the step
    mm_mass: float  # total molecule mass on the map
    cm_mass: float  # total intracellular molecule mass
    health: int = 0  # health flag word (guard.sentinel layout)
    bad_cells: Any = None  # (cap,) bool rows with bad concentrations
    invariants: int = 0  # invariant flag word (check.invariants layout)
    mass_drift: float = 0.0  # absolute mass drift across the physics phase


_BITS = 16  # bits packed per i32 word (16 keeps every value positive)
# leading scalar words of the packed record: [n_placed, n_candidates,
# n_attempted, n_rows, n_alive, n_occupied, mm_mass(f32 bits),
# cm_mass(f32 bits), health_flags, invariant_flags, mass_drift(f32 bits)]
_HEADER_WORDS = 11
HEALTH_WORD = 8
INVARIANT_WORD = 9


def _pack_bits(b: torch.Tensor) -> torch.Tensor:
    """(B, n) bool -> (B, ceil(n/16)) i32 words (little-endian bit order)."""
    B, n = b.shape
    pad = (-n) % _BITS
    if pad:
        b = torch.cat([b, b.new_zeros((B, pad))], dim=1)
    w = b.reshape(B, -1, _BITS).to(torch.int32)
    shifts = torch.arange(_BITS, dtype=torch.int32, device=b.device)
    return (w << shifts).sum(-1, dtype=torch.int32)


def _unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`_pack_bits` on host numpy."""
    bits = (words.astype(np.int64)[:, None] >> np.arange(_BITS)) & 1
    return bits.reshape(-1)[:n].astype(bool)


def record_length(cap: int, max_divisions: int, spawn_block: int) -> int:
    """Words in a packed step record for a given stepper config — the one
    layout formula the device pack and the host unpack agree on."""
    nw_k = -(-cap // _BITS)  # kill / bad-cell bitmask words
    nw_s = -(-spawn_block // _BITS)  # spawn-ok bitmask words
    return (
        _HEADER_WORDS
        + nw_k  # kill bitmask
        + max_divisions  # division parent rows
        + 2 * max_divisions  # division child positions
        + nw_s  # spawn-ok bitmask
        + 2 * spawn_block  # spawn positions
        + nw_k  # bad-cell bitmask
    )


def crop_fused_record(records, k: int, length: int) -> np.ndarray:
    """A lane's native ``(k, record)`` view out of its world-row of a
    cross-rung fused fetch buffer.  The fused dispatch pads every rung's
    ``(B_r, k_r, L_r)`` records to the fleet's grow-only ``(k_env,
    rec_env)`` envelope so the whole fleet comes back in one fetch; the
    envelope lives only in that buffer (``_unpack_outputs`` still holds
    each record to the lane's own :func:`record_length`).  ``records`` is
    one world's ``(k_env, rec_env)`` slice; raises ``ValueError`` when the
    native record does not fit it."""
    arr = np.asarray(records)
    if arr.shape[0] < k or arr.shape[1] < length:
        raise ValueError(
            f"fused record envelope {arr.shape} cannot hold a native "
            f"({k}, {length}) megastep record: the grow-only envelope "
            "contract was violated"
        )
    return arr[:k, :length]


class DeviceState(NamedTuple):
    """All device-resident simulation state, with a leading world axis."""

    mm: torch.Tensor  # (B, mols, m, m) f32 molecule maps
    cm: torch.Tensor  # (B, cap, mols) f32 intracellular molecules
    pos: torch.Tensor  # (B, cap, 2) i64 positions
    occ: torch.Tensor  # (B, m, m) bool pixel occupancy
    alive: torch.Tensor  # (B, cap) bool
    n_rows: torch.Tensor  # (B,) i64 high-water row counts
    key: torch.Tensor  # (B, 2) i64 threefry key words


class StepConsts(NamedTuple):
    """Per-world constants of the step, with a leading world axis (the
    token tables and temperatures as one entry per world: each world's
    kinetics draws its own token maps)."""

    kernels: torch.Tensor  # (B, mols, 3, 3) diffusion kernels
    perm_factors: torch.Tensor  # (B, mols)
    degrad_factors: torch.Tensor  # (B, mols)
    mol_idx: torch.Tensor  # (B,) i64 selection molecule column
    kill_below: torch.Tensor  # (B,) f32
    divide_above: torch.Tensor  # (B,) f32
    divide_cost: torch.Tensor  # (B,) f32
    tables: tuple  # B x TokenTables (None for an empty fleet slot)
    abs_temp: tuple  # B x f32 scalar tensors (None for an empty slot)


class DispatchInputs(NamedTuple):
    """The host's inputs to one dispatch, on the device.  Spawn batches
    and parameter pushes ride the dispatch's first step only."""

    spawn_block: int  # static spawn budget (the record's spawn lanes)
    spawn_valid: Any  # (B, spawn_block) bool, or None: no spawns at all
    spawn_dense: tuple  # B x ((n, p, d, 5) i16 token rows, or None)
    push: tuple  # B x ((dense (n, p, d, 5) i16, rows (n,) i64), or None)
    div_budget: torch.Tensor  # (B,) i64 per-step division budgets


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host numpy -> ``device`` without a stream synchronization: through
    pinned memory and a non-blocking copy on a CUDA device."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# --------------------------------------------------------------------- #
# device-side helpers (every tensor carries the world axis)             #
# --------------------------------------------------------------------- #


def _moore_offsets(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The 8 Moore offsets in the JAX package's order, built on the
    device (dx, dy = k // 3 - 1, k % 3 - 1 for k in 0..8 without 4)."""
    k = torch.arange(8, device=device)
    k = k + (k >= 4).to(k.dtype)
    return k // 3 - 1, k % 3 - 1


def _pixels(mm: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """Gather ``(B, n, mols)`` map values at flat pixel indices ``lin``
    ``(B, n)`` of ``mm`` ``(B, mols, m, m)``."""
    B, M = mm.shape[:2]
    flat = mm.reshape(B, M, -1)
    return flat.gather(2, lin[:, None, :].expand(B, M, lin.shape[1])).transpose(1, 2)


def _add_pixels(mm: torch.Tensor, lin: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``mm.at[:, xs, ys].add(vals)`` per world, out of place; ``vals``
    ``(B, n, mols)``.  Live cells hold unique pixels and every other row
    adds an exact zero, so the sum is the same in any order."""
    B, M = mm.shape[:2]
    flat = mm.reshape(B, M, -1).clone()
    flat.scatter_add_(2, lin[:, None, :].expand(B, M, lin.shape[1]), vals.transpose(1, 2))
    return flat.view(mm.shape)


def _set_flat(t: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, value) -> torch.Tensor:
    """``t`` ``(B, n, ...)`` with entries ``idx`` (B, k) set to ``value``
    where ``mask``; masked-out entries go to a sink slot that is sliced
    off (the JAX package's ``mode="drop"``)."""
    B, n = t.shape[:2]
    buf = torch.cat([t, t[:, :1]], dim=1)
    tgt = torch.where(mask, idx, n)
    src = value if torch.is_tensor(value) else torch.full_like(tgt, value, dtype=t.dtype)
    if t.ndim == 2:
        buf.scatter_(1, tgt, src)
    else:
        tail = t.shape[2:]
        buf.scatter_(
            1,
            tgt.view((B, -1) + (1,) * len(tail)).expand((B, tgt.shape[1]) + tail),
            src,
        )
    return buf[:, :n]


def _occupy(occ: torch.Tensor, win: torch.Tensor, tx, ty, value: bool) -> torch.Tensor:
    """Set (or clear) occupancy at the winners' pixels."""
    B, m, _ = occ.shape
    return _set_flat(occ.reshape(B, m * m), tx * m + ty, win, value).view(B, m, m)


def _resolve_conflicts(want: torch.Tensor, tx, ty, m: int) -> torch.Tensor:
    """Among concurrent requests for target pixels the lowest slot wins
    (the host path's sorted sequential semantics), per world."""
    B, n = want.shape
    slots = torch.arange(n, device=want.device).expand(B, n)
    target = tx * m + ty
    winner = torch.full((B, m * m + 1), n, dtype=torch.int64, device=want.device)
    winner.scatter_reduce_(
        1,
        torch.where(want, target, m * m),
        torch.where(want, slots, n),
        reduce="amin",
        include_self=True,
    )
    return want & (winner.gather(1, target) == slots)


def _occupied(occ: torch.Tensor, tx, ty) -> torch.Tensor:
    B, m, _ = occ.shape
    return occ.reshape(B, m * m).gather(1, (tx * m + ty).reshape(B, -1)).view(tx.shape)


def _place_moore(key, occ, pos, cand, n_rounds: int):
    """Place one free Moore-neighborhood pixel per candidate row, no two on
    the same pixel, in ``n_rounds`` vectorized rounds.  Returns
    ``(placed, child_pos, occ)``."""
    B, cap = cand.shape
    m = occ.shape[-1]
    dx, dy = _moore_offsets(cand.device)
    placed = torch.zeros_like(cand)
    cpos = torch.zeros_like(pos)
    nx = (pos[..., 0:1] + dx) % m  # (B, cap, 8)
    ny = (pos[..., 1:2] + dy) % m
    for _ in range(n_rounds):
        keys = _prng.split(key)
        key, sub = keys[:, 0], keys[:, 1]
        pending = cand & ~placed
        free = ~_occupied(occ, nx, ny) & pending[..., None]
        n_free = free.sum(-1)
        r = (_prng.uniform(sub, (cap,)) * n_free).to(torch.int64)
        opt_rank = free.cumsum(-1) - 1
        sel = (free & (opt_rank == r[..., None])).to(torch.uint8).argmax(-1, keepdim=True)
        tx = nx.gather(-1, sel)[..., 0]
        ty = ny.gather(-1, sel)[..., 0]
        want = pending & (n_free > 0)
        win = _resolve_conflicts(want, tx, ty, m)
        occ = _occupy(occ, win, tx, ty, True)
        cpos = torch.where(win[..., None], torch.stack([tx, ty], -1), cpos)
        placed = placed | win
    return placed, cpos, occ


def _place_global(key, occ, valid, n_rounds: int):
    """Place each valid slot on a uniformly random free pixel (rejection
    sampling over the torus); slots still conflicted after the last round
    are dropped.  Returns ``(placed, spawn_pos, occ)``."""
    B, b = valid.shape
    m = occ.shape[-1]
    placed = torch.zeros_like(valid)
    spos = torch.zeros((B, b, 2), dtype=torch.int64, device=valid.device)
    for _ in range(n_rounds):
        keys = _prng.split(key)
        key, sub = keys[:, 0], keys[:, 1]
        xy = _prng.randint(sub, (b, 2), 0, m)
        tx, ty = xy[..., 0], xy[..., 1]
        want = valid & ~placed & ~_occupied(occ, tx, ty)
        win = _resolve_conflicts(want, tx, ty, m)
        occ = _occupy(occ, win, tx, ty, True)
        spos = torch.where(win[..., None], xy, spos)
        placed = placed | win
    return placed, spos, occ


def _first_true(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` per world: the
    first ``size`` indices where ``mask`` holds, ascending, padded with
    ``fill`` — a cumsum-and-scatter of static size."""
    B, n = mask.shape
    rank = mask.cumsum(-1) - 1
    tgt = torch.where(mask & (rank < size), rank, size)
    buf = torch.full((B, size + 1), fill, dtype=torch.int64, device=mask.device)
    buf.scatter_(1, tgt, torch.arange(n, device=mask.device).expand(B, n))
    return buf[:, :size]


def _world_sum(x: torch.Tensor, det: bool) -> torch.Tensor:
    """Total of each world's tensor: the fixed float64 tree in
    deterministic mode."""
    flat = x.reshape(x.shape[0], -1)
    return _detmath.sum_axis(flat, 1) if det else flat.sum(1)


class _Phases:
    """Profiler ranges over the step body's phases (the JAX package's
    ``jax.named_scope`` names): ``phase(name)`` closes the open range and
    opens the next, ``phase(None)`` closes the last.  A range costs a few
    microseconds of host time, and nothing on the device."""

    def __init__(self):
        self._open = None

    def __call__(self, name: str | None) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if name is not None:
            self._open = torch.profiler.record_function(name)
            self._open.__enter__()


class StepCarry(NamedTuple):
    """What one step's pre-activity phases hand the rest of the step: the
    state after push and spawn and the values the later phases read."""

    state: DeviceState  # after push and spawn, its key advanced
    k_div: torch.Tensor  # (B, 2) the division placement's key
    mol_onehot: torch.Tensor  # (B, mols) the selection molecule
    spawn_ok: Any  # (B, spawn_block) bool, or None: no spawn this step
    spawn_pos: Any  # (B, spawn_block, 2), or None
    lin_q: torch.Tensor  # (B, q) flat pixels of the live-row prefix
    ext: torch.Tensor  # (B, q, mols) their map values before the activity
    q: int  # the live-row prefix


def step_pre_activity(
    state: DeviceState,
    params: CellParams,
    consts: StepConsts,
    inputs: DispatchInputs,
    *,
    first: bool,
    n_rounds: int,
    q: int,
) -> tuple[StepCarry, torch.Tensor, CellParams]:
    """The phases of one step before the activity (push, spawn) for B
    worlds; returns the carry, the integrator's signals ``X0`` (B, q, s)
    and its parameters (the q-row prefixes of ``params``).  The parameter
    tensors are written in place."""
    phase = _Phases()
    mm, cm, pos, occ, alive, n_rows, key = state
    B, cap, n_mols = cm.shape
    m = occ.shape[-1]
    dev = cm.device
    q = min(q, cap)
    keys = _prng.split(key, 3)
    key, k_spawn, k_div = keys[:, 0], keys[:, 1], keys[:, 2]
    mol_onehot = (
        torch.arange(n_mols, device=dev)[None, :] == consts.mol_idx[:, None]
    ).to(torch.float32)

    # ---- -1. parameter pushes riding this dispatch (first step only) ----
    phase("ms:push_params")
    if first:
        for w, push in enumerate(inputs.push):
            if push is None:
                continue
            dense, prow = push
            batch = compute_cell_params(dense, consts.tables[w], consts.abs_temp[w])
            for t, v in zip(params, batch):
                t[w, prow] = v

    # ---- 0. spawn queued newcomers (first step only) ----
    phase("ms:spawn")
    spawn_valid = inputs.spawn_valid if first else None
    if spawn_valid is not None:
        budget = q - n_rows
        valid = spawn_valid & ((spawn_valid.cumsum(-1) - 1) < budget[:, None])
        spawn_ok, spawn_pos, occ = _place_global(k_spawn, occ, valid, n_rounds)
        srank = spawn_ok.cumsum(-1) - 1
        srow = n_rows[:, None] + srank
        slin = spawn_pos[..., 0] * m + spawn_pos[..., 1]
        pickup = _pixels(mm, slin) * 0.5 * spawn_ok[..., None].to(torch.float32)
        mm = _add_pixels(mm, slin, -pickup)
        cm = _set_flat(cm, srow, spawn_ok, pickup)
        pos = _set_flat(pos, srow, spawn_ok, spawn_pos)
        alive = _set_flat(alive, srow, spawn_ok, True)
        n_ok = spawn_ok.sum(-1)
        # the j-th landed spawn of each world takes row n_rows + j
        order = torch.sort((~spawn_ok).to(torch.int32), dim=1, stable=True).indices
        for w, dense in enumerate(inputs.spawn_dense):
            if dense is None:
                continue
            n_w = dense.shape[0]
            batch = compute_cell_params(dense, consts.tables[w], consts.abs_temp[w])
            idx = order[w, : min(n_w, cap)].clamp(max=n_w - 1)
            for t, v in zip(params, batch):
                write_new_rows(t[w : w + 1], n_rows[w : w + 1], v[idx][None], n_ok[w : w + 1])
        n_rows = n_rows + n_ok
    else:
        spawn_ok = spawn_pos = None

    # ---- 1. enzymatic activity (live-row prefix only): its inputs ----
    phase("ms:activity")
    lin_q = pos[:, :q, 0] * m + pos[:, :q, 1]
    ext = _pixels(mm, lin_q)  # (B, q, mols)
    X0 = torch.cat([cm[:, :q], ext], dim=-1).contiguous()
    phase(None)
    carry = StepCarry(
        state=DeviceState(mm=mm, cm=cm, pos=pos, occ=occ, alive=alive, n_rows=n_rows, key=key),
        k_div=k_div,
        mol_onehot=mol_onehot,
        spawn_ok=spawn_ok,
        spawn_pos=spawn_pos,
        lin_q=lin_q,
        ext=ext,
        q=q,
    )
    return carry, X0, CellParams(*(t[:, :q] for t in params))


def step_post_activity(
    carry: StepCarry,
    X1: torch.Tensor,
    params: CellParams,
    consts: StepConsts,
    inputs: DispatchInputs,
    *,
    det: bool,
    max_div: int,
    n_rounds: int,
    compact: tuple = (),
) -> tuple[DeviceState, CellParams, torch.Tensor]:
    """The phases of one step after the activity (select and kill,
    divide, physics, metric and guard lanes, compaction of the worlds in
    ``compact``, the packed record), given the integrator's output ``X1``
    (B, q, s); returns the new state and parameters and the ``(B,
    record)`` packed output.  The parameter tensors are written in
    place."""
    phase = _Phases()
    mm, cm, pos, occ, alive, n_rows, key = carry.state
    k_div, mol_onehot = carry.k_div, carry.mol_onehot
    spawn_ok, spawn_pos = carry.spawn_ok, carry.spawn_pos
    lin_q, ext, q = carry.lin_q, carry.ext, carry.q
    B, cap, n_mols = cm.shape
    m = occ.shape[-1]
    dev = cm.device
    bidx = torch.arange(B, device=dev)
    rows = torch.arange(cap, device=dev)

    # ---- 1. enzymatic activity: its outputs merged back ----
    phase("ms:activity")
    alive_q = alive[:, :q, None]
    cm = torch.cat([torch.where(alive_q, X1[..., :n_mols], cm[:, :q]), cm[:, q:]], dim=1)
    mm = _add_pixels(
        mm, lin_q, torch.where(alive_q, X1[..., n_mols:] - ext, torch.zeros_like(ext))
    )

    # ---- 2. selection + kill ----
    phase("ms:select_kill")
    lin = pos[..., 0] * m + pos[..., 1]
    atp = (cm * mol_onehot[:, None, :]).sum(-1)
    kill = alive & (atp < consts.kill_below[:, None])
    spill = torch.where(kill[..., None], cm, torch.zeros_like(cm))
    mm = _add_pixels(mm, lin, spill)
    cm = torch.where(kill[..., None], torch.zeros_like(cm), cm)
    occ = _occupy(occ, kill, pos[..., 0], pos[..., 1], False)
    alive = alive & ~kill

    # ---- 3. divide ----
    phase("ms:divide")
    cand = alive & (atp > consts.divide_above[:, None])
    n_candidates = cand.sum(-1)
    budget = torch.minimum(inputs.div_budget.clamp(max=max_div), q - n_rows)
    cand = cand & ((cand.cumsum(-1) - 1) < budget[:, None])
    n_attempted = cand.sum(-1)
    # every attempting candidate pays the division cost, placed or not
    cost = torch.where(cand, consts.divide_cost[:, None], 0.0)
    cm = cm - cost[..., None] * mol_onehot[:, None, :]
    placed, cpos, occ = _place_moore(k_div, occ, pos, cand, n_rounds)
    crow = n_rows[:, None] + placed.cumsum(-1) - 1
    half = torch.where(placed[..., None], cm * 0.5, cm)
    buf = torch.cat([half, torch.zeros_like(half[:, :1])], dim=1)
    buf.scatter_add_(
        1,
        torch.where(placed, crow, cap)[..., None].expand(B, cap, n_mols),
        torch.where(placed[..., None], half, torch.zeros_like(half)),
    )
    cm = buf[:, :cap]
    pos = _set_flat(pos, crow, placed, cpos)
    alive = _set_flat(alive, crow, placed, True)
    p_idx = _first_true(placed, max_div, cap)
    n_placed = placed.sum(-1)
    d = min(max_div, cap)
    src = p_idx[:, :d].clamp(max=cap - 1)
    bsrc = bidx[:, None].expand(B, d)
    values = CellParams(*(t[bsrc, src] for t in params))
    for t, v in zip(params, values):
        write_new_rows(t, n_rows, v, n_placed)
    n_rows = n_rows + n_placed

    # ---- 4. degrade + diffuse + permeate ----
    phase("ms:physics")
    mm = mm * consts.degrad_factors[:, :, None, None]
    cm = cm * consts.degrad_factors[:, None, :]
    mass_pre = _world_sum(mm, det) + _world_sum(cm, det)
    M = n_mols
    mm = _diff.diffuse(
        mm.reshape(B * M, m, m), consts.kernels.reshape(B * M, 3, 3), det=det
    ).view(B, M, m, m)
    lin = pos[..., 0] * m + pos[..., 1]
    ext = _pixels(mm, lin)
    new_cm, new_ext = _diff.permeate(cm, ext, consts.perm_factors[:, None, :], det=det)
    alive_c = alive[..., None]
    cm = torch.where(alive_c, new_cm, cm)
    mm = _add_pixels(mm, lin, torch.where(alive_c, new_ext - ext, torch.zeros_like(ext)))

    # ---- 4.5 metric lanes (before compaction) ----
    phase("ms:lanes")
    mm_mass = _world_sum(mm, det)
    cm_mass = _world_sum(cm, det)
    n_occupied = occ.reshape(B, -1).sum(-1)

    # ---- 4.6 health sentinel lanes ----
    mm_flat = mm.reshape(B, -1)
    mm_nonfin = ~torch.isfinite(mm_flat).all(-1)
    mm_neg = (mm_flat < -_SENTINEL_NEG_EPS).any(-1)
    alive_rows = alive[..., None]
    cm_nonfin_rows = (~torch.isfinite(cm) & alive_rows).any(-1)
    cm_neg_rows = ((cm < -_SENTINEL_NEG_EPS) & alive_rows).any(-1)
    bad_cells = cm_nonfin_rows | cm_neg_rows
    health = (
        mm_nonfin.to(torch.int32)
        | (mm_neg.to(torch.int32) << 1)
        | (cm_nonfin_rows.any(-1).to(torch.int32) << 2)
        | (cm_neg_rows.any(-1).to(torch.int32) << 3)
    )

    # ---- 4.7 invariant lanes ----
    occ_alive_mismatch = n_occupied != alive.sum(-1)
    pos_unoccupied = (alive & ~_occupied(occ, pos[..., 0], pos[..., 1])).any(-1)
    pix = torch.zeros((B, m * m + 1), dtype=torch.int32, device=dev)
    pix.scatter_add_(
        1, torch.where(alive, lin, m * m), torch.ones_like(lin, dtype=torch.int32)
    )
    dup_position = (pix[:, : m * m] > 1).any(-1)
    dead = rows[None, :] >= n_rows[:, None]
    dead_cm_residue = (dead[..., None] & (cm != 0.0)).any(-1).any(-1)
    row_has_params = torch.zeros((B, cap), dtype=torch.bool, device=dev)
    for t in params:
        row_has_params = row_has_params | (t != 0).reshape(B, cap, -1).any(-1)
    dead_param_residue = (dead & row_has_params).any(-1)
    mass_drift = (mm_mass + cm_mass - mass_pre).abs()
    drift_denom = torch.clamp(mass_pre.abs(), min=1.0)
    mass_drifted = mass_drift > _MASS_DRIFT_RTOL * drift_denom
    invariants = (
        occ_alive_mismatch.to(torch.int32)
        | (pos_unoccupied.to(torch.int32) << 1)
        | (dup_position.to(torch.int32) << 2)
        | (dead_cm_residue.to(torch.int32) << 3)
        | (dead_param_residue.to(torch.int32) << 4)
        | (mass_drifted.to(torch.int32) << 5)
    )

    # ---- 5. compaction of the listed worlds ----
    phase("ms:compact")
    child_pos_out = cpos.gather(1, p_idx.clamp(max=cap - 1)[..., None].expand(B, max_div, 2))
    if compact:
        cm, pos, alive, n_rows = cm.clone(), pos.clone(), alive.clone(), n_rows.clone()
        for w in compact:
            # stable sort of ~alive: live rows keep order, dead fold out;
            # the host replay's np.argsort(~alive, kind="stable") gives
            # the identical permutation
            perm = torch.sort((~alive[w]).to(torch.int32), stable=True).indices
            n_keep = alive[w].sum()
            cm[w] = compact_rows(cm[w], perm, n_keep)
            pos[w] = compact_rows(pos[w], perm, n_keep)
            for t in params:
                t[w] = compact_rows(t[w], perm, n_keep)
            alive[w] = rows < n_keep
            n_rows[w] = n_keep

    # ---- one packed i32 record per world = one device->host transfer ----
    phase("ms:pack_record")
    if spawn_ok is None:
        sb = inputs.spawn_block
        spawn_ok = torch.zeros((B, sb), dtype=torch.bool, device=dev)
        spawn_pos = torch.zeros((B, sb, 2), dtype=torch.int64, device=dev)
    header = torch.stack(
        [
            n_placed,
            n_candidates,
            n_attempted,
            n_rows,
            alive.sum(-1),
            n_occupied,
            mm_mass.to(torch.float32).view(torch.int32).to(torch.int64),
            cm_mass.to(torch.float32).view(torch.int32).to(torch.int64),
            health.to(torch.int64),
            invariants.to(torch.int64),
            mass_drift.to(torch.float32).view(torch.int32).to(torch.int64),
        ],
        dim=1,
    ).to(torch.int32)
    out = torch.cat(
        [
            header,
            _pack_bits(kill),
            p_idx.to(torch.int32),
            child_pos_out.reshape(B, -1).to(torch.int32),
            _pack_bits(spawn_ok),
            spawn_pos.reshape(B, -1).to(torch.int32),
            _pack_bits(bad_cells),
        ],
        dim=1,
    )
    phase(None)
    new_state = DeviceState(
        mm=mm, cm=cm, pos=pos, occ=occ, alive=alive, n_rows=n_rows, key=key
    )
    return new_state, params, out


def _step_body(
    state: DeviceState,
    params: CellParams,
    consts: StepConsts,
    inputs: DispatchInputs,
    *,
    first: bool,
    det: bool,
    max_div: int,
    n_rounds: int,
    q: int,
    integrator: str,
    compact: tuple = (),
) -> tuple[DeviceState, CellParams, torch.Tensor]:
    """One fused workload step for B worlds (push -> spawn -> activity ->
    select -> kill -> divide -> degrade/diffuse/permeate [-> compact]),
    returning the new state and parameters and the ``(B, record)`` packed
    output.  ``q`` bounds the live-row prefix the integrator reads and
    the rows spawn and divide may allocate.  The parameter tensors are
    written in place; every other state tensor is replaced.  ``compact``
    lists the worlds whose rows fold at the end of this step.  It is
    :func:`step_pre_activity`, one integrator call and
    :func:`step_post_activity`; a fused fleet step interleaves the pieces
    of several rungs around one grouped integrator launch."""
    carry, X0, params_q = step_pre_activity(
        state, params, consts, inputs, first=first, n_rounds=n_rounds, q=q
    )
    with torch.profiler.record_function("ms:activity"):
        X1 = _backends.integrate(integrator, X0, params_q)
    return step_post_activity(
        carry, X1, params, consts, inputs,
        det=det, max_div=max_div, n_rounds=n_rounds, compact=compact,
    )


def det_scope(det: bool, device):
    """The scope of a det dispatch's work: subnormals flushed on the CPU,
    as XLA flushes them (nothing for fast mode)."""
    return _detmath.flush_denormal(device) if det else contextlib.nullcontext()


def megastep(
    state: DeviceState,
    params: CellParams,
    consts: StepConsts,
    inputs: DispatchInputs,
    *,
    k: int,
    det: bool,
    max_div: int,
    n_rounds: int,
    q: int,
    integrator: str,
    compact: tuple = (),
) -> tuple[DeviceState, CellParams, torch.Tensor]:
    """``k`` fused steps enqueued back to back with no host wait, their
    records stacked into one ``(B, k, record)`` buffer.  Spawn batches and
    parameter pushes ride step 0; ``compact`` applies to the last step
    only.  In deterministic mode on the CPU the whole dispatch flushes
    subnormals, as XLA does."""
    outs = []
    with det_scope(det, state.cm.device):
        for i in range(k):
            state, params, out = _step_body(
                state,
                params,
                consts,
                inputs,
                first=i == 0,
                det=det,
                max_div=max_div,
                n_rounds=n_rounds,
                q=q,
                integrator=integrator,
                compact=compact if i == k - 1 else (),
            )
            outs.append(out)
    return state, params, torch.stack(outs, dim=1)


# --------------------------------------------------------------------- #
# host side                                                             #
# --------------------------------------------------------------------- #


def dispatch_inputs(
    slots: list,
    *,
    spawn_block: int,
    max_proteins: int,
    max_doms: int,
    device: torch.device,
    budget_cache: dict,
) -> DispatchInputs:
    """Densify the planned spawn batches and parameter pushes of B slots
    (``slots[w]`` is ``(stepper, plan)``, or None for an empty fleet slot)
    at one token capacity, and upload them without a synchronization.
    Each slot's recorder gets its ``spawn``, ``push`` and
    ``param_assembly`` spans."""
    B = len(slots)
    spawn_dense: list = [None] * B
    push: list = [None] * B
    valid = np.zeros((B, spawn_block), dtype=bool)
    budgets = []
    for w, item in enumerate(slots):
        if item is None:
            budgets.append(0)
            continue
        st, plan = item
        budgets.append(plan.div_budget)
        if plan.spawn_entries is not None:
            dense = st.world.phenotypes.dense_rows(
                plan.spawn_entries, max_proteins, max_doms
            )
            spawn_dense[w] = to_device(dense, device)
            valid[w, : len(plan.spawn)] = True
            st.telemetry.note("spawn", time.perf_counter() - plan.t_spawn0)
        if plan.ride is not None:
            entries, rows = plan.ride
            with st.telemetry.span("push"):
                dense = st.world.phenotypes.dense_rows(entries, max_proteins, max_doms)
                push[w] = (
                    to_device(dense, device),
                    to_device(np.asarray(rows, dtype=np.int64), device),
                )
        st.telemetry.note("param_assembly", time.perf_counter() - plan.t_asm0)
    budgets = tuple(budgets)
    dev_budget = budget_cache.get(budgets)
    if dev_budget is None:
        if len(budget_cache) > 256:
            budget_cache.clear()
        dev_budget = budget_cache[budgets] = to_device(
            np.asarray(budgets, dtype=np.int64), device
        )
    return DispatchInputs(
        spawn_block=spawn_block,
        spawn_valid=to_device(valid, device) if valid.any() else None,
        spawn_dense=tuple(spawn_dense),
        push=tuple(push),
        div_budget=dev_budget,
    )


class _Worker:
    """One daemon thread running queued callables in FIFO order; closed
    when its owner is collected and joined (bounded) at exit."""

    def __init__(self, name: str):
        import queue
        import threading

        self._q: Any = queue.SimpleQueue()
        self._closed = False
        self._lock = threading.Lock()
        self._t = threading.Thread(target=self._run, daemon=True, name=name)
        self._t.start()
        register_exit_join(self)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            try:
                fut.set_result(fn())
            except BaseException as exc:  # noqa: BLE001 - delivered to result()
                fut.set_exception(exc)

    def submit(self, fn):
        from concurrent.futures import Future

        fut: Future = Future()
        with self._lock:
            closed = self._closed or not self._t.is_alive()
            if not closed:
                self._q.put((fn, fut))
        if closed:
            # after close() the queue is never drained: resolve inline
            try:
                fut.set_result(fn())
            except BaseException as exc:  # noqa: BLE001
                fut.set_exception(exc)
        return fut

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._q.put(None)

    def exit_join(self, timeout: float | None = None) -> None:
        self.close()
        if self._t.is_alive():
            self._t.join(timeout)


class _Fetcher(_Worker):
    """:class:`_Worker` bringing packed step records to the host in
    dispatch order.  The copy is enqueued on the dispatching thread (a
    non-blocking copy into pinned memory plus a CUDA event, so the
    dispatch never waits); the worker thread waits on the event, then
    fires ``on_ready`` (the device-time bracket) before the record is
    handed to any reader."""

    def __init__(self):
        super().__init__(name="ms-stepper-fetch")

    def submit(self, arr, on_ready=None):
        host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
        host.copy_(arr, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def _wait():
            done.synchronize()
            note_fetch(host.numpy().nbytes)
            if on_ready is not None:
                on_ready()
            return host.numpy()

        return super().submit(_wait)


class _LazyFetch:
    """Inline stand-in for a fetch future on the CPU, where a record is
    ready when its dispatch returns.  ``on_ready`` fires once, at the
    first ``result()``: on this path the device-time bracket closes at
    replay, an upper bound."""

    __slots__ = ("_arr", "_on_ready")

    def __init__(self, arr, on_ready=None):
        self._arr = arr
        self._on_ready = on_ready

    def done(self) -> bool:
        return True

    def result(self, timeout=None):
        value = fetch_host(self._arr)
        if self._on_ready is not None:
            self._on_ready, cb = None, self._on_ready
            cb()
        return value


class _Pending(NamedTuple):
    """One dispatched step (or megastep) awaiting host replay."""

    out: Any  # future of the packed (k, record) i32 output
    spawn_genomes: list  # genomes queued into this dispatch
    spawn_labels: list
    compacted: bool  # final record of this dispatch compacted
    change_seq: int  # genome-change counter at dispatch time
    div_budget: int  # total division cap of this dispatch (k x per-step)
    k: int  # fused steps in this dispatch


class _DispatchPlan(NamedTuple):
    """Host-side decisions for one dispatch, made by
    :meth:`PipelinedStepper._prepare_dispatch` before any input is
    densified; the fleet prepares every lane first, then densifies the
    group at its unified token capacity."""

    t_start: float  # perf_counter at step entry
    fetch0: float  # _fetch_acc at step entry
    t_asm0: float  # start of the param_assembly span (noted at densify)
    t_spawn0: float  # start of the spawn span (noted at densify)
    spawn: list  # [(genome, label)] taken off the spawn queue
    spawn_entries: Any  # phenotype-cache entries for ``spawn`` (or None)
    ride: Any  # (entries, rows) push refresh riding this dispatch
    compact: bool  # this dispatch's final record compacts
    div_budget: int  # per-step division budget
    k: int  # fused steps in this dispatch


class PipelinedStepper:
    """
    Pipelined stepping of the canonical selection workload over a
    :class:`~magicsoup_tpu_torch.world.World` (see the module docstring).

    Parameters (as :class:`magicsoup_tpu.PipelinedStepper`):
        world: The world to drive; its population is the starting state.
        mol_name: Molecule whose intracellular amount drives selection.
        kill_below: Kill cells below this amount.
        divide_above: Divide cells above this amount...
        divide_cost: ...at this cost, paid before sharing.
        target_cells: Population to top up to with random genomes
            (``None`` disables spawning).
        genome_size: Size of top-up genomes.
        lag: Pipeline depth in dispatches.  An integer fixes the schedule
            (seed-exact); ``"auto"`` replays records as they arrive,
            bounded by ``max_lag``.
        megastep: Fused steps per dispatch (``K``): each :meth:`step`
            enqueues K step bodies back to back and returns their K
            records in one buffer.  Spawns and parameter pushes enter at
            the first step of a dispatch.
        max_divisions: Static per-step division budget.
        spawn_block: Static per-step spawn budget.
        push_block: Size of the parameter-refresh batch riding a dispatch;
            bigger change sets are applied on their own.
        n_rounds: Conflict-resolution rounds of on-device placement.
        p_mutation / p_indel / p_del / p_recombination: Mutation rates.
        compact_headroom: Compact when fewer free rows than this are
            estimated to remain (default 256).
        compact_dead_slack: Also compact once this many dead rows piled up.
        auto_grow: Double the world's capacity (a full pipeline drain) when
            the live population crowds it.
        overlap_evolution: Run recombination and point mutations on a
            worker thread, overlapping the next dispatch; at fixed lag the
            resulting pushes ride the second-next dispatch (seed-exact, but
            a different trajectory than with the flag off).  Token worlds
            run evolution inline whatever the flag, as the JAX package's
            do: their programs already run on the device.
        sentinel_policy: Host reaction to the health and invariant lanes:
            ``"warn"``, ``"quarantine"`` or ``"rollback"``.
        dispatch_retries: Transient dispatch failures to absorb with
            bounded exponential backoff (``guard.retry``); a retry happens
            only while nothing of the dispatch has been enqueued, so it
            re-sends the same inputs.  0 (default) propagates the error.
        fetch_timeout: Seconds one record fetch may take before a
            :class:`~magicsoup_tpu_torch.guard.errors.WatchdogTimeout`;
            ``None`` reads ``MAGICSOUP_GUARD_FETCH_TIMEOUT`` (default 300,
            a malformed value raises ``GuardConfigError`` naming it).
    """

    def __init__(
        self,
        world,
        *,
        mol_name: str = "ATP",
        kill_below: float = 1.0,
        divide_above: float = 5.0,
        divide_cost: float = 4.0,
        target_cells: int | None = None,
        genome_size: int = 500,
        lag: int | str = "auto",
        max_lag: int = 8,
        megastep: int = 1,
        max_divisions: int = 2048,
        spawn_block: int = 1024,
        push_block: int = 256,
        n_rounds: int = 4,
        p_mutation: float = 1e-6,
        p_indel: float = 0.4,
        p_del: float = 0.66,
        p_recombination: float = 1e-7,
        compact_headroom: int | None = None,
        compact_dead_slack: int = 768,
        auto_grow: bool = True,
        overlap_evolution: bool = True,
        sentinel_policy: str = "warn",
        dispatch_retries: int = 0,
        fetch_timeout: float | None = None,
    ):
        from magicsoup_tpu_torch.guard.sentinel import SENTINEL_POLICIES
        from magicsoup_tpu_torch.guard.watchdog import fetch_timeout as _ft

        if getattr(world, "_mesh", None) is not None:
            raise ValueError("mesh-placed worlds are not ported; use one device")
        if not isinstance(dispatch_retries, int) or dispatch_retries < 0:
            raise ValueError("dispatch_retries must be an int >= 0")
        if lag != "auto" and (not isinstance(lag, int) or lag < 0):
            raise ValueError("lag must be 'auto' or a non-negative int")
        if not isinstance(megastep, int) or megastep < 1:
            raise ValueError("megastep must be an int >= 1")
        if sentinel_policy not in SENTINEL_POLICIES:
            raise ValueError(f"sentinel_policy must be one of {SENTINEL_POLICIES}")
        self.world = world
        self.kin = world.kinetics
        self.mol_idx = world.chemistry.molname_2_idx[mol_name]
        self.kill_below = float(kill_below)
        self.divide_above = float(divide_above)
        self.divide_cost = float(divide_cost)
        self.target_cells = target_cells
        self.genome_size = genome_size
        self.lag = lag
        self.max_lag = max_lag if lag == "auto" else max(int(lag), 1)
        self.megastep = megastep
        self.max_divisions = max_divisions
        self.spawn_block = spawn_block
        self.push_block = push_block
        self.n_rounds = n_rounds
        self.p_mutation = p_mutation
        self.p_indel = p_indel
        self.p_del = p_del
        self.p_recombination = p_recombination
        self.compact_headroom = compact_headroom if compact_headroom is not None else 256
        self.compact_dead_slack = compact_dead_slack
        self.auto_grow = auto_grow
        self.sentinel_policy = sentinel_policy
        self.dispatch_retries = dispatch_retries
        self._fetch_timeout = float(fetch_timeout) if fetch_timeout is not None else _ft()
        self._fault_dispatch = 0  # armed by guard.faults
        self._quarantine_pending = False
        self._sentinel_warned = False
        self._invariant_warned = False
        self.stats = {
            "steps": 0,
            "replayed": 0,
            "compactions": 0,
            "growths": 0,
            "divisions": 0,
            "division_drops": 0,  # budget clamps (a pipeline delta)
            "division_blocked": 0,  # no free Moore pixel (classic too)
            "kills": 0,
            "spawned": 0,
            "spawn_drops": 0,
            "pushes": 0,
            "genome_changes": 0,  # mutated/recombined genomes applied
            "fetch_ms": 0,
            "dispatch_ms": 0,
            "step_ms": 0,
            "sentinel_trips": 0,
            "quarantined": 0,
            "dispatch_retries": 0,
            "invariant_trips": 0,
        }
        # share the world's recorder, so one JSONL stream carries both; a
        # detached recorder costs a dict update per phase and emits nothing
        self.telemetry = TelemetryRecorder.coerce(getattr(world, "telemetry", None))
        dev = world.device
        self._consts = StepConsts(
            kernels=world._diff_kernels[None],
            perm_factors=world._perm_factors[None],
            degrad_factors=world._degrad_factors[None],
            mol_idx=torch.full((1,), self.mol_idx, dtype=torch.int64, device=dev),
            kill_below=torch.full((1,), self.kill_below, dtype=torch.float32, device=dev),
            divide_above=torch.full(
                (1,), self.divide_above, dtype=torch.float32, device=dev
            ),
            divide_cost=torch.full((1,), self.divide_cost, dtype=torch.float32, device=dev),
            tables=(self.kin.tables,),
            abs_temp=(self.kin._abs_temp_t,),
        )
        self._rng = np.random.default_rng(world._rng.randrange(2**63))
        self.trace: list[dict] = []  # per-dispatch timing/diagnostic records
        self._fetch_acc = 0.0  # seconds blocked on record fetches
        self._budget_cache: dict = {}
        # a CUDA world's records come back on a fetch thread; on the CPU a
        # record is ready when its dispatch returns
        if dev.type == "cuda":
            import weakref

            self._fetcher = _Fetcher()
            weakref.finalize(self, self._fetcher.close)
        else:
            self._fetcher = None
        if overlap_evolution and world._genome_store is None:
            import weakref

            self._evo_worker = _Worker("ms-stepper-evo")
            weakref.finalize(self, self._evo_worker.close)
        else:
            self._evo_worker = None
        self._evo_future = None
        self._pending: list[_Pending] = []
        self._spawn_queue: list[tuple[str, str]] = []  # (genome, label)
        # deferred pushes (genomes, rows, change seq) held while a
        # compaction is in flight
        self._push_buffer: list[tuple[list[str], list[int], int]] = []
        # refreshes ready to ride the next dispatch
        self._push_queue: list[tuple[list[str], list[int], int]] = []
        self._compact_outstanding = False
        self._growth_hist: list[int] = []  # recent per-step row growth
        self._change_seq = 0  # bumps on every genome-change batch created
        self._dispatched_seq = 0  # highest batch seq actually dispatched
        self._attach(
            to_device(_prng.prng_key(world._rng.randrange(2**31)).numpy()[None], dev)
        )
        self._needs_attach = False

    def _attach(self, key: torch.Tensor) -> None:
        """(Re)build device and replay state from the attached world — at
        construction, after a flush and after a capacity growth.  The
        device leaves are copies: the world keeps its own."""
        w = self.world
        dev = w.device
        self._cap = w._capacity
        self._state = DeviceState(
            mm=w._molecule_map.clone()[None],
            cm=w._cell_molecules.clone()[None],
            pos=w._positions_dev.clone()[None],
            occ=to_device(w._np_cell_map[None], dev),
            alive=(torch.arange(self._cap, device=dev) < w.n_cells)[None],
            n_rows=torch.full((1,), w.n_cells, dtype=torch.int64, device=dev),
            key=key,
        )
        # a token world's genomes stay on the device: the stepper checks out
        # a tensor-sharing clone of its store (no decode, no copy) and
        # replays genome events as store programs; the host list is None
        if w._genome_store is not None:
            self._token_store = w._genome_store.clone()
            self._genomes = None
        else:
            self._token_store = None
            self._genomes = list(w.cell_genomes) + [""] * (self._cap - w.n_cells)
        self._labels: list = list(w.cell_labels) + [""] * (self._cap - w.n_cells)
        self._lifetimes = np.zeros(self._cap, dtype=np.int32)
        self._lifetimes[: w.n_cells] = w.cell_lifetimes
        self._divisions = np.zeros(self._cap, dtype=np.int32)
        self._divisions[: w.n_cells] = w.cell_divisions
        self._positions = w._np_positions.copy()
        self._alive = np.zeros(self._cap, dtype=bool)
        self._alive[: w.n_cells] = True
        self._n_rows = w.n_cells
        # per row: change counter of the last genome change whose params
        # older in-flight dispatches may not have had (-1 = in sync)
        self._last_change = np.full(self._cap, -1, dtype=np.int64)

    def _grow_capacity(self) -> None:
        """Drain, sync into the world, double its capacity, reattach."""
        self.flush()
        key = self._state.key
        self.world._ensure_capacity(self.world._capacity + 1)
        self._attach(key)
        self._needs_attach = False
        self.stats["growths"] += 1

    def _params_b(self) -> CellParams:
        """The kinetic parameters with a world axis of 1 (views: the step
        body's in-place row writes land in ``kin.params``)."""
        return CellParams(*(t[None] for t in self.kin.params))

    # -------------------------------------------------------------- #
    # dispatch side                                                  #
    # -------------------------------------------------------------- #

    def step(self) -> None:
        """Dispatch one workload step (``megastep`` fused device steps)
        and replay any arrived records: ``_prepare_dispatch`` (host
        decisions), ``_finalize_inputs`` (densify and upload), the
        dispatch, ``_commit_dispatch`` (bookkeeping).  The fleet reuses
        the same pieces around one dispatch for a whole group."""
        plan = self._prepare_dispatch()
        inputs, q = self._finalize_inputs(plan)
        t_dispatch0 = time.perf_counter()
        self._state, params, out = self._dispatch_with_retry(
            lambda: megastep(
                self._state,
                self._params_b(),
                self._consts,
                inputs,
                k=plan.k,
                det=self.world.deterministic,
                max_div=self.max_divisions,
                n_rounds=self.n_rounds,
                q=q,
                integrator=self.world.integrator,
                compact=(0,) if plan.compact else (),
            )
        )
        self.kin.params = CellParams(*(t[0] for t in params))
        t_dispatched = time.perf_counter()
        # one dispatch ran its k integrator steps through this backend
        _runtime.note_integrator_dispatch(self.world.integrator)
        self._commit_dispatch(
            plan,
            self._fetch(out[0], self._device_ready(t_dispatched, [self])),
            q=q,
            t_dispatch0=t_dispatch0,
            t_dispatched=t_dispatched,
        )

    def _dispatch_with_retry(self, launch, *, lane_faults: bool = True):
        """Run one dispatch's ``launch``, absorbing up to
        ``dispatch_retries`` transient failures with bounded exponential
        backoff.

        The armed faults (``guard.faults.inject_dispatch_failures`` when
        ``lane_faults``, and the chaos plane's ``dispatch`` site) fire
        before ``launch`` enqueues anything.  The step body writes the
        parameter rows in place (pushes, spawns, compaction), so once
        ``launch`` has started a failure is never retried: a retry would
        re-run a half-enqueued step on half-written parameters.  Only
        transient errors (``guard.retry``'s classification; never a CUDA
        error) are retried, so a retried dispatch sends the same inputs
        and gives the same bits as a first-try success."""
        from magicsoup_tpu_torch.guard.retry import is_transient_error, retry_call

        started = False

        def attempt():
            nonlocal started
            if lane_faults and self._fault_dispatch > 0:
                from magicsoup_tpu_torch.guard.faults import consume_dispatch_fault

                consume_dispatch_fault(self)
            fault = _chaos.site("dispatch")
            if fault is not None:
                from magicsoup_tpu_torch.guard.errors import TransientDispatchError

                raise TransientDispatchError(
                    "injected fault: UNAVAILABLE: chaos dispatch fault "
                    f"#{fault.index}"
                )
            started = True
            return launch()

        if self.dispatch_retries <= 0:
            return attempt()

        def _retryable(exc: BaseException) -> bool:
            return not started and is_transient_error(exc)

        def _note(attempt_no: int, exc: BaseException) -> None:
            self.stats["dispatch_retries"] += 1
            self.telemetry.note("dispatch_retry", 1.0)

        return retry_call(
            attempt, retries=self.dispatch_retries, retry_if=_retryable, on_retry=_note
        )

    @staticmethod
    def _device_ready(t_dispatched: float, lanes):
        """The device-time bracket of one physical dispatch: a callback,
        fired when the dispatch's record fetch resolves (on the fetch
        thread on a card, at the first ``result()`` on the CPU), that
        feeds the process census (``telemetry.metrics.note_device_time``)
        once and the ``"device"`` phase of every rider's recorder, so the
        span lands on the next dispatch row as the fetch and replay spans
        do.  No synchronization and no transfer of its own."""
        recorders = tuple(lane.telemetry for lane in lanes)

        def _ready():
            dt = time.perf_counter() - t_dispatched
            _metrics.note_device_time(dt)
            for rec in recorders:
                rec.note("device", dt)

        return _ready

    def _fetch(self, out: torch.Tensor, on_ready=None):
        """Start bringing a dispatch's records to the host."""
        if self._fetcher is not None:
            return self._fetcher.submit(out, on_ready=on_ready)
        return _LazyFetch(out, on_ready=on_ready)

    def _prepare_dispatch(self) -> _DispatchPlan:
        """Host half of one dispatch: drain, growth and compaction
        decisions, spawn and push batch selection, token-capacity growth
        — everything that must settle before inputs are densified."""
        t_start = time.perf_counter()
        fetch0 = self._fetch_acc
        if self._quarantine_pending:
            # at the next safe host boundary: drain and sync first
            self._quarantine_pending = False
            self.flush()
            from magicsoup_tpu_torch.guard.sentinel import quarantine_world

            self.stats["quarantined"] += quarantine_world(self.world)
        if self._needs_attach:
            # after a flush the world may have been changed through the
            # classic API: re-pull its state
            self.world._ensure_capacity(self.world.n_cells + 1)
            self._attach(self._state.key)
            self._needs_attach = False
        self._drain(block=False)

        # compaction is scheduled on a projection: the replayed row count
        # lags the device, so project with the recent per-step growth
        g_est = max(self._growth_hist[-8:], default=0)
        g_est = max(g_est, 32)

        # when the LIVE population crowds the capacity, grow
        if self.auto_grow:
            grow_at = max(2 * min(g_est, 256), self._cap // 8)
            if self._cap - int(self._alive.sum()) < grow_at:
                self.drain()
                if self._cap - int(self._alive.sum()) < grow_at:
                    self._grow_capacity()

        # outstanding STEPS: each pending megastep holds p.k steps
        pend_steps = sum(p.k for p in self._pending) + self.megastep
        projected = self._n_rows + pend_steps * 2 * g_est + len(self._spawn_queue)
        dead_est = self._n_rows - int(self._alive.sum())
        compact = not self._compact_outstanding and (
            projected + self.compact_headroom > self._cap
            or dead_est > self.compact_dead_slack
        )

        # the param_assembly and spawn spans are noted when the batches are
        # densified (dispatch_inputs)
        t_asm0 = time.perf_counter()
        spawn = self._spawn_queue[: self.spawn_block]
        self._spawn_queue = self._spawn_queue[len(spawn) :]
        t_spawn0 = time.perf_counter()
        spawn_entries = (
            self.world.phenotypes.lookup([g for g, _ in spawn]) if spawn else None
        )
        ride = self._take_ride_push()
        if compact and self._push_queue:
            # refreshes not riding this compacting dispatch would reach
            # the device with pre-compaction row ids: park them until the
            # compaction's replay gives the permutation
            self._push_buffer += self._push_queue
            self._push_queue = []
        for ent in (spawn_entries, ride[0] if ride else None):
            if ent:
                self._grow_tokens(
                    max(e.n_prots for e in ent), max(e.max_doms for e in ent)
                )

        # adaptive division budget (recent demand x2), quantized to 64
        div_budget = int(min(self.max_divisions, -(-(2 * g_est + 64) // 64) * 64))
        return _DispatchPlan(
            t_start=t_start,
            fetch0=fetch0,
            t_asm0=t_asm0,
            t_spawn0=t_spawn0,
            spawn=spawn,
            spawn_entries=spawn_entries,
            ride=ride,
            compact=compact,
            div_budget=div_budget,
            k=self.megastep,
        )

    def _grow_tokens(self, n_prots: int, n_doms: int) -> None:
        """Grow the kinetics token capacities for a planned batch (split
        out so a fleet lane can check its params out of the group stack
        first)."""
        self.kin.ensure_token_limits(n_prots, n_doms)

    def _finalize_inputs(self, plan: _DispatchPlan):
        """Densify and upload the planned batches at the current token
        capacities, and pick the live-row prefix ``q``: an exact upper
        bound on the device's row count (replayed rows + each outstanding
        step's division budget + spawn batch), quantized."""
        inputs = dispatch_inputs(
            [(self, plan)],
            spawn_block=self.spawn_block,
            max_proteins=self.kin.max_proteins,
            max_doms=self.kin.max_doms,
            device=self.world.device,
            budget_cache=self._budget_cache,
        )
        upper = self._n_rows + plan.k * plan.div_budget + len(plan.spawn)
        for p in self._pending:
            upper += p.div_budget + len(p.spawn_genomes)
        return inputs, quantize_rows(upper, self._cap)

    def _commit_dispatch(
        self,
        plan: _DispatchPlan,
        out_fut,
        *,
        q: int,
        t_dispatch0: float,
        t_dispatched: float,
        extra_row: dict | None = None,
    ) -> None:
        """Post-dispatch bookkeeping: queue the pending replay, drain,
        update stats and trace, and emit the telemetry ``dispatch`` row.
        The fleet calls it once per lane with that lane's slice of the
        group's shared fetch (``extra_row`` carries the fleet slot and
        size)."""
        k = plan.k
        self._pending.append(
            _Pending(
                out=out_fut,
                spawn_genomes=[g for g, _ in plan.spawn],
                spawn_labels=[lab for _, lab in plan.spawn],
                compacted=plan.compact,
                # what the device saw: only DISPATCHED pushes
                change_seq=self._dispatched_seq,
                div_budget=k * plan.div_budget,
                k=k,
            )
        )
        if plan.compact:
            self._compact_outstanding = True
        self.stats["steps"] += k
        self._drain(block=False)
        t_end = time.perf_counter()
        self.stats["fetch_ms"] += (self._fetch_acc - plan.fetch0) * 1e3
        self.stats["dispatch_ms"] += (t_dispatched - t_dispatch0) * 1e3
        self.stats["step_ms"] += (t_end - plan.t_start) * 1e3
        if len(self.trace) >= 4096:
            del self.trace[:2048]
        self.trace.append(
            {
                "t": t_end - plan.t_start,
                "dispatch": t_dispatched - t_dispatch0,
                "fetch": self._fetch_acc - plan.fetch0,
                "q": q,
                "rows": self._n_rows,
                "alive": int(self._alive.sum()),
                "compact": plan.compact,
                "k": k,
                "push": 0 if plan.ride is None else len(plan.ride[1]),
                "spawn": len(plan.spawn),
                "pend": len(self._pending),
            }
        )
        # per-dispatch phase attribution and one JSONL row: take_dispatch()
        # drains the window since the previous row, so the fetch, replay
        # and device spans noted since land on this one
        rec = self.telemetry
        rec.note("dispatch", t_dispatched - t_dispatch0)
        if rec.attached:
            row = {
                "type": "dispatch",
                "phases": rec.take_dispatch(),
                "k": k,
                "q": q,
                "rows": self._n_rows,
                "pending": len(self._pending),
                # eager PyTorch compiles no program: no dispatch is cold
                "cold": False,
                "compact": bool(plan.compact),
            }
            if extra_row:
                row.update(extra_row)
            rec.emit(row)

    def prewarm(self, *, q: int | None = None, compact: bool = False) -> None:
        """A no-op: eager PyTorch compiles no step program (kept for the
        JAX package's API)."""

    def wait_warm(self, timeout: float | None = None) -> None:
        """A no-op, like :meth:`prewarm`."""

    # -------------------------------------------------------------- #
    # replay side                                                    #
    # -------------------------------------------------------------- #

    @property
    def population(self) -> int:
        """Live cells as of the last REPLAYED step."""
        return int(self._alive.sum())

    def drain(self) -> None:
        """Block until every dispatched step has been replayed."""
        self._drain(block=True)

    def _unpack_outputs(self, arr: np.ndarray) -> StepOutputs:
        """Host-side inverse of the step body's record packing."""
        md = self.max_divisions
        sb = self.spawn_block
        nw_k = -(-self._cap // _BITS)
        nw_s = -(-sb // _BITS)
        assert arr.shape[0] == record_length(self._cap, md, sb), (
            "step record length drifted from stepper.record_length"
        )
        off = _HEADER_WORDS
        kill = _unpack_bits(arr[off : off + nw_k], self._cap)
        off += nw_k
        parents = arr[off : off + md]
        off += md
        child_pos = arr[off : off + 2 * md].reshape(md, 2)
        off += 2 * md
        spawn_ok = _unpack_bits(arr[off : off + nw_s], sb)
        off += nw_s
        spawn_pos = arr[off : off + 2 * sb].reshape(sb, 2)
        off += 2 * sb
        bad_cells = _unpack_bits(arr[off : off + nw_k], self._cap)
        # f32 totals travel as their bits: re-view, do not cast
        masses = np.ascontiguousarray(arr[6:8]).view(np.float32)
        drift = np.ascontiguousarray(arr[10:11]).view(np.float32)
        return StepOutputs(
            kill=kill,
            parents=parents,
            child_pos=child_pos,
            n_placed=int(arr[0]),
            n_candidates=int(arr[1]),
            n_attempted=int(arr[2]),
            spawn_ok=spawn_ok,
            spawn_pos=spawn_pos,
            n_rows=int(arr[3]),
            n_alive=int(arr[4]),
            n_occupied=int(arr[5]),
            mm_mass=float(masses[0]),
            cm_mass=float(masses[1]),
            health=int(arr[HEALTH_WORD]),
            bad_cells=bad_cells,
            invariants=int(arr[INVARIANT_WORD]),
            mass_drift=float(drift[0]),
        )

    def _drain(self, block: bool) -> None:
        while self._pending:
            if self.lag == "auto":
                must = block or len(self._pending) > self.max_lag
                if not must and not self._pending[0].out.done():
                    break
            elif not block and len(self._pending) < max(self.lag, 1):
                # fixed lag: replay on schedule only, never on readiness
                # (push timing is part of the trajectory)
                break
            self._replay(self._pending.pop(0))
        if block:
            self._join_evolution()

    def _replay(self, pend: _Pending) -> None:
        from concurrent.futures import TimeoutError as _FuturesTimeout

        from magicsoup_tpu_torch.guard.errors import WatchdogTimeout

        t0 = time.perf_counter()
        # the one fetch per dispatch, bounded by the watchdog budget, so a
        # dead worker or a wedged transfer surfaces as stack dumps and a
        # typed error instead of a silent hang
        try:
            fault = _chaos.site("fetch")
            if fault is not None:
                # a chaos "delay" stands in for a wedged transfer: hold the
                # fetch for the delay, capped at the budget; a delay past
                # the budget raises the TimeoutError a real result() would
                delay = float(fault.arg or 0.0)
                time.sleep(min(delay, self._fetch_timeout))
                if delay >= self._fetch_timeout:
                    raise TimeoutError(
                        f"chaos-injected fetch delay of {delay}s tripped "
                        f"the {self._fetch_timeout}s watchdog"
                    )
            arr = np.atleast_2d(np.asarray(pend.out.result(timeout=self._fetch_timeout)))
        except (TimeoutError, _FuturesTimeout) as exc:
            from magicsoup_tpu_torch.guard.watchdog import dump_diagnostics

            dump_diagnostics(
                "stepper fetch timed out",
                {
                    "phase": "fetch",
                    "timeout_s": self._fetch_timeout,
                    "pending": len(self._pending),
                    "replayed": self.stats["replayed"],
                },
            )
            raise WatchdogTimeout(
                f"step-record fetch exceeded {self._fetch_timeout:.0f}s "
                "(wedged transfer or dead fetch worker); diagnostics "
                "dumped to stderr",
                phase="fetch",
                seconds=self._fetch_timeout,
            ) from exc
        dt_fetch = time.perf_counter() - t0
        self._fetch_acc += dt_fetch
        self.telemetry.note("fetch", dt_fetch)
        t1 = time.perf_counter()
        for i in range(pend.k):
            # record 0 carries the dispatch's spawn batch; only the last
            # can be the compacting one
            self._replay_record(
                self._unpack_outputs(arr[i]),
                spawn_genomes=pend.spawn_genomes if i == 0 else [],
                spawn_labels=pend.spawn_labels if i == 0 else [],
                compacted=pend.compacted and i == pend.k - 1,
                change_seq=pend.change_seq,
            )
        self.telemetry.note("replay", time.perf_counter() - t1)

    def _guard_row_extra(self) -> dict:
        """Extra keys of the guard telemetry rows (sentinel and invariant
        trips); a fleet lane adds its slot and the group size."""
        return {}

    def _policy_trip(self, kind: str, message: str, error) -> None:
        """The shared host policy over a tripped flag word."""
        if self.sentinel_policy == "rollback":
            raise error
        if self.sentinel_policy == "quarantine":
            self._quarantine_pending = True
        elif not getattr(self, f"_{kind}_warned"):
            setattr(self, f"_{kind}_warned", True)
            import warnings

            warnings.warn(f"{message}; policy=warn — counting trips in stats")

    def _handle_sentinel(self, out: StepOutputs) -> None:
        """Host policy over a tripped health flag word."""
        from magicsoup_tpu_torch.guard.errors import SentinelTripped
        from magicsoup_tpu_torch.guard.sentinel import decode_health

        flags = decode_health(out.health)
        n_bad = int(out.bad_cells.sum()) if out.bad_cells is not None else 0
        step = self.stats["replayed"]
        self.stats["sentinel_trips"] += 1
        names = ", ".join(k for k, v in flags.items() if v)
        if self.telemetry.attached:
            self.telemetry.emit(
                {
                    "type": "sentinel",
                    "step": step,
                    "flags": int(out.health),
                    "n_bad_cells": n_bad,
                    "policy": self.sentinel_policy,
                    **flags,
                    **self._guard_row_extra(),
                }
            )
        msg = f"health sentinel tripped at replayed step {step}: {names} ({n_bad} bad cells)"
        self._policy_trip(
            "sentinel",
            msg,
            SentinelTripped(msg, flags=out.health, step=step, n_bad_cells=n_bad),
        )

    def _handle_invariant(self, out: StepOutputs) -> None:
        """Host policy over a tripped invariant flag word (the same
        ``sentinel_policy``)."""
        from magicsoup_tpu_torch.check.invariants import decode_invariants
        from magicsoup_tpu_torch.guard.errors import InvariantTripped

        flags = decode_invariants(out.invariants)
        step = self.stats["replayed"]
        self.stats["invariant_trips"] += 1
        names = ", ".join(k for k, v in flags.items() if v)
        if self.telemetry.attached:
            self.telemetry.emit(
                {
                    "type": "invariant",
                    "step": step,
                    "flags": int(out.invariants),
                    "mass_drift": float(out.mass_drift),
                    "policy": self.sentinel_policy,
                    **flags,
                    **self._guard_row_extra(),
                }
            )
        msg = (
            f"state invariant tripped at replayed step {step}: {names}"
            f" (mass drift {out.mass_drift:.3g})"
        )
        self._policy_trip(
            "invariant", msg, InvariantTripped(msg, flags=out.invariants, step=step)
        )

    def _replay_record(
        self,
        out: StepOutputs,
        *,
        spawn_genomes: list,
        spawn_labels: list,
        compacted: bool,
        change_seq: int,
    ) -> None:
        """Replay ONE per-step record — the serial unit."""
        # the previous record's evolution lands before anything here
        # touches genomes, positions or the push queues
        self._join_evolution()
        if out.health:
            self._handle_sentinel(out)
        if out.invariants:
            self._handle_invariant(out)
        kill = out.kill
        n_placed = out.n_placed

        # 0. spawns (allocation order matches the device: queue order)
        n_spawned = 0
        if spawn_genomes:
            tok_rows: list[int] = []
            tok_genomes: list[str] = []
            for i, (g, lab) in enumerate(zip(spawn_genomes, spawn_labels)):
                if not out.spawn_ok[i]:
                    continue
                row = self._n_rows + n_spawned
                n_spawned += 1
                if self._token_store is not None:
                    tok_rows.append(row)
                    tok_genomes.append(g)
                else:
                    self._genomes[row] = g
                self._labels[row] = lab
                self._lifetimes[row] = 0
                self._divisions[row] = 0
                self._positions[row] = out.spawn_pos[i]
                self._alive[row] = True
            if tok_rows:
                # one encode and scatter per record (the token replay's
                # string import boundary)
                self._token_store.set_rows(tok_rows, tok_genomes)
            self._n_rows += n_spawned
            self.stats["spawned"] += n_spawned
            self.stats["spawn_drops"] += len(spawn_genomes) - n_spawned

        # 1. kills
        self._alive[kill] = False
        n_kills = int(kill.sum())
        self.stats["kills"] += n_kills

        # 2. divisions (parents ascending, children appended in order).
        # The device copied the parent's params as of the dispatch; if
        # the parent's genome changed since, the child needs its own push
        # (token mode: the value is None, the store row is the content)
        repush: dict[int, str | None] = {}
        div_parents: list[int] = []
        div_children: list[int] = []
        for i in range(n_placed):
            p = int(out.parents[i])
            row = self._n_rows + i
            if self._token_store is not None:
                div_parents.append(p)
                div_children.append(row)
            else:
                self._genomes[row] = self._genomes[p]
            self._labels[row] = self._labels[p]
            self._divisions[p] += 1
            self._divisions[row] = self._divisions[p]
            self._lifetimes[p] = 0
            self._lifetimes[row] = 0
            self._positions[row] = out.child_pos[i]
            self._alive[row] = True
            if self._last_change[p] > change_seq:
                repush[row] = None if self._genomes is None else self._genomes[row]
            else:
                self._last_change[row] = self._last_change[p]
        if div_children:
            # parent -> child genome copies stay on the device
            self._token_store.copy_rows(div_parents, div_children)
        self._n_rows += n_placed
        self.stats["divisions"] += n_placed
        self.stats["division_drops"] += out.n_candidates - out.n_attempted
        self.stats["division_blocked"] += out.n_attempted - n_placed

        # 3. lifetimes
        self._lifetimes[: self._n_rows][self._alive[: self._n_rows]] += 1

        # 4. compaction replay (the device's stable permutation)
        if compacted:
            perm = np.argsort(~self._alive, kind="stable")
            n_keep = int(self._alive.sum())
            self._apply_perm(perm, n_keep)
            self._compact_outstanding = False
            self.stats["compactions"] += 1
            inv = np.empty(self._cap, dtype=np.int64)
            inv[perm] = np.arange(self._cap)
            repush = {int(inv[r]): g for r, g in repush.items()}
            for genomes, rows, seq in self._push_buffer:
                self._dispatch_push(genomes, [int(inv[r]) for r in rows], seq)
            self._push_buffer = []

        self.stats["replayed"] += 1
        # drops count as demand, so a clamp raises the next budget
        dropped = max(0, out.n_candidates - out.n_attempted)
        self._growth_hist.append(n_spawned + n_placed + dropped)
        if len(self._growth_hist) > 64:
            del self._growth_hist[:32]

        # 5. evolution on the replayed state (+ stale-child refreshes)
        self._submit_evolution(repush)

        # 6. population top-up (reacts with pipeline lag)
        if self.target_cells is not None:
            missing = (
                self.target_cells
                - int(self._alive.sum())
                - len(self._spawn_queue)
                - sum(len(p.spawn_genomes) for p in self._pending)
            )
            if missing > 0:
                rng = self.world._rng
                self._spawn_queue.extend(
                    (random_genome(s=self.genome_size, rng=rng), randstr(n=12, rng=rng))
                    for _ in range(missing)
                )

        # 7. the telemetry step row: the metric lanes rode the record's
        # one fetch and are host scalars already, so this touches no
        # device state
        if self.telemetry.attached:
            self.telemetry.emit(self._step_row(out, n_kills, n_placed, n_spawned))

    def _step_row(
        self, out: StepOutputs, n_kills: int, n_divided: int, n_spawned: int
    ) -> dict:
        """One JSONL ``step`` row (schema: ``telemetry/summary.py``)."""
        if self._token_store is not None:
            # the store's length vector, one 4-byte-per-row fetch cached
            # per store version (no whole-store snapshot, no decode)
            lens = self._token_store.host_lengths()[np.nonzero(self._alive)[0]]
        else:
            # one C-level pass over the row list (a Python loop over the
            # live rows costs ~2x as much at 10k cells)
            lens = np.fromiter(map(len, self._genomes), dtype=np.int64, count=len(self._genomes))
            lens = lens[np.nonzero(self._alive)[0]]
        n = len(lens)
        return {
            "type": "step",
            "step": self.stats["replayed"],
            "alive": out.n_alive,
            "rows": out.n_rows,
            "occupied": out.n_occupied,
            "mm_mass": out.mm_mass,
            "cm_mass": out.cm_mass,
            "kills": n_kills,
            "divisions": n_divided,
            "spawned": n_spawned,
            "genome_len_mean": round(int(lens.sum()) / n, 3) if n else 0.0,
            "genome_len_max": int(lens.max()) if n else 0,
            "total_kills": self.stats["kills"],
            "total_divisions": self.stats["divisions"],
            "total_spawned": self.stats["spawned"],
            "total_mutations": self.stats["genome_changes"],
        }

    def _apply_perm(self, perm: np.ndarray, n_keep: int) -> None:
        if self._token_store is not None:
            self._token_store.permute(perm, n_keep)
        else:
            self._genomes = [self._genomes[i] for i in perm]
        self._labels = [self._labels[i] for i in perm]
        self._lifetimes = self._lifetimes[perm]
        self._divisions = self._divisions[perm]
        self._positions = self._positions[perm]
        self._last_change = self._last_change[perm]
        self._alive = np.zeros(self._cap, dtype=bool)
        self._alive[:n_keep] = True
        for i in range(n_keep, self._cap):
            if self._genomes is not None:
                self._genomes[i] = ""
            self._labels[i] = ""
        self._lifetimes[n_keep:] = 0
        self._divisions[n_keep:] = 0
        self._positions[n_keep:] = 0
        self._last_change[n_keep:] = -1
        self._n_rows = n_keep

    def _evolution_compute(
        self, rows: np.ndarray, pos_rows: np.ndarray, repush: dict[int, str]
    ) -> dict[int, str]:
        """Recombination + point mutations over the live rows, returning
        the changed-genome dict.  Reads shared state but writes none, so it
        can run on the evolution worker; all draws come from
        ``self._rng``, which only this phase uses."""
        changed: dict[int, str] = dict(repush)
        if len(rows) > 1 and self.p_recombination > 0:
            pairs_k = moore_pairs(pos_rows, self.world.map_size)
            if len(pairs_k):
                pair_rows = rows[pairs_k]
                seed = int(self._rng.integers(2**63))
                for g0, g1, k in _engine.recombinations_indexed(
                    self._genomes, pair_rows, p=self.p_recombination, seed=seed
                ):
                    r0, r1 = pair_rows[k]
                    changed[int(r0)] = g0
                    changed[int(r1)] = g1
        if len(rows) and self.p_mutation > 0:
            seqs = [changed.get(int(r), self._genomes[int(r)]) for r in rows]
            seed = int(self._rng.integers(2**63))
            for g, i in _engine.point_mutations(
                seqs, p=self.p_mutation, p_indel=self.p_indel, p_del=self.p_del, seed=seed
            ):
                changed[int(rows[i])] = g
        return changed

    def _evolution_compute_tokens(
        self, rows: np.ndarray, pos_rows: np.ndarray, repush_rows
    ) -> list[int]:
        """Token-mode evolution: the phase of :meth:`_evolution_compute`
        as two store programs on the device, run inline; returns the
        changed rows (their content lives in the store).  The seeds are
        drawn from ``self._rng`` in the string path's order
        (recombination first), so both backends consume it alike."""
        from magicsoup_tpu_torch import genomes as _genomes

        store = self._token_store
        changed_rows: set[int] = {int(r) for r in repush_rows}
        det = self.world.deterministic
        if len(rows) > 1 and self.p_recombination > 0:
            pairs_k = moore_pairs(pos_rows, self.world.map_size)
            if len(pairs_k):
                pair_rows = rows[pairs_k]
                seed = int(self._rng.integers(2**63))
                store.ensure_length_cap(_genomes.length_capacity(2 * store.max_length()))
                t, lens, ch = _genomes.recombinations_tokens(
                    store.tokens, store.lengths, pair_rows,
                    p=self.p_recombination, seed=seed, det=det,
                )
                store.apply(t, lens)
                changed_rows.update(np.nonzero(fetch_host(ch))[0].tolist())
        if len(rows) and self.p_mutation > 0:
            store.maybe_regrow()
            live = np.zeros(store.capacity, dtype=bool)
            live[rows] = True
            seed = int(self._rng.integers(2**63))
            t, lens, ch = _genomes.point_mutations_tokens(
                store.tokens, store.lengths, p=self.p_mutation, p_indel=self.p_indel,
                p_del=self.p_del, seed=seed, live=to_device(live, store.device), det=det,
            )
            store.apply(t, lens)
            changed_rows.update(np.nonzero(fetch_host(ch))[0].tolist())
        return sorted(changed_rows)

    def _submit_evolution(self, repush: dict[int, "str | None"]) -> None:
        """Start the evolution phase on the just-replayed state: on the
        worker when overlap is on, inline otherwise; a token world's
        always inline."""
        from functools import partial

        rows = np.nonzero(self._alive)[0]
        pos_rows = self._positions[rows]
        if self._token_store is not None:
            # the store already holds the new rows: only their refresh is
            # queued, its content read from the store when it is dispatched
            self._queue_refresh(None, self._evolution_compute_tokens(rows, pos_rows, list(repush)))
            return
        if self._evo_worker is not None:
            self._evo_future = self._evo_worker.submit(
                partial(self._evolution_compute, rows, pos_rows, repush)
            )
        else:
            self._apply_evolution(self._evolution_compute(rows, pos_rows, repush))

    def _join_evolution(self) -> None:
        """Wait for (and apply) the in-flight evolution phase, if any."""
        fut = self._evo_future
        if fut is None:
            return
        self._evo_future = None
        self._apply_evolution(fut.result(timeout=300.0))

    def _apply_evolution(self, changed: dict[int, str]) -> None:
        """Write the changed genomes and queue their phenotype refresh."""
        for r, g in changed.items():
            self._genomes[r] = g
        rows_c = sorted(changed)
        self._queue_refresh([changed[r] for r in rows_c], rows_c)

    def _queue_refresh(self, genomes: list[str] | None, rows: list[int]) -> None:
        """Queue the phenotype refresh of changed rows (held in the push
        buffer while a compaction is in flight); ``genomes=None`` is the
        token spelling: the content is read from the store when the push
        is dispatched, so a row changed twice pushes its final content."""
        if not rows:
            return
        self.stats["genome_changes"] += len(rows)
        self._change_seq += 1
        self._last_change[rows] = self._change_seq
        if self._compact_outstanding:
            self._push_buffer.append((genomes, rows, self._change_seq))
        else:
            self._dispatch_push(genomes, rows, self._change_seq)

    def _dispatch_push(self, genomes: list[str], rows: list[int], seq: int) -> None:
        """Queue a phenotype refresh; it rides the next dispatch."""
        self._push_queue.append((genomes, rows, seq))

    def _apply_push_now(self, genomes: list[str] | None, rows: list[int], seq: int) -> None:
        """Apply one refresh batch on its own (oversized bursts, flush);
        ``genomes=None`` is the token spelling (content from the store)."""
        if genomes is None:
            rows = self._drop_blanked(rows)
        if rows:
            entries = self._push_entries(genomes, rows)
            self.kin.set_cell_params_cached(rows, entries, self.world.phenotypes)
        self._dispatched_seq = max(self._dispatched_seq, seq)
        self.stats["pushes"] += 1

    def _drop_blanked(self, rows: list[int]) -> list[int]:
        """A token refresh without the rows that died after their change
        was queued and that the point-mutation program has blanked since
        (it returns PAD tokens outside its live mask and keeps the old
        length, ROADMAP C2): such a row has no genome to translate, and
        its refresh is moot.  The JAX stepper decodes them and fails
        (ROADMAP C6); every other refresh is kept as it is."""
        from magicsoup_tpu_torch.genomes import PAD

        tokens, lengths = self._token_store.host_arrays()
        return [
            r for r in rows
            if self._alive[r] or lengths[r] == 0 or tokens[r, 0] != PAD
        ]

    def _push_entries(self, genomes: list[str] | None, rows: list[int]):
        """Phenotype entries for one refresh batch: string-keyed on the
        string backend, hash-keyed from the store on the token backend
        (no decode unless a row misses)."""
        if genomes is not None:
            return self.world.phenotypes.lookup(genomes)
        tokens, lengths = self._token_store.host_arrays()
        return self.world.phenotypes.lookup_tokens(tokens, lengths, rows)

    def _take_ride_push(self):
        """Pop queued refreshes (in order) up to the riding block; returns
        their phenotype entries and rows, or None.  A batch bigger than
        the block is applied on its own; for a row changed twice the
        newest genome lands last."""
        taken: list = []
        total = 0
        while self._push_queue:
            g, r, seq = self._push_queue[0]
            if len(r) > self.push_block:
                if taken:
                    break  # keep order; the burst goes next dispatch
                self._push_queue.pop(0)
                self._apply_push_now(g, r, seq)
                continue
            if total + len(r) > self.push_block:
                break
            taken.append(self._push_queue.pop(0))
            total += len(r)
        if not taken:
            return None
        # a row in several batches: the last queued genome wins; token
        # batches carry no content (the store row is final), so for them
        # this is a union of rows
        merged: dict[int, str | None] = {}
        top_seq = self._dispatched_seq
        for g, r, seq in taken:
            merged.update(zip(r, g if g is not None else [None] * len(r)))
            top_seq = max(top_seq, seq)
        rows = sorted(merged)
        genomes = None if self._token_store is not None else [merged[r] for r in rows]
        if genomes is None:
            rows = self._drop_blanked(rows)
        self._dispatched_seq = top_seq
        self.stats["pushes"] += 1
        if not rows:
            return None
        return self._push_entries(genomes, rows), rows

    def _flush_push_queue(self) -> None:
        """Apply every queued refresh on its own (before a flush sync)."""
        for genomes, rows, seq in self._push_queue:
            self._apply_push_now(genomes, rows, seq)
        self._push_queue = []

    # -------------------------------------------------------------- #
    # flush                                                          #
    # -------------------------------------------------------------- #

    def flush(self) -> None:
        """Drain the pipeline, compact, and sync everything back into the
        attached world (dense indices again)."""
        self._drain(block=True)
        # refreshes queued by the final replays have no dispatch to ride
        self._flush_push_queue()
        n_keep = int(self._alive.sum())
        if self._n_rows != n_keep or not self._alive[:n_keep].all():
            perm = np.argsort(~self._alive, kind="stable")
            with self.telemetry.span("compact"):
                perm_t = to_device(perm.astype(np.int64), self.world.device)
                st = self._state
                self._state = st._replace(
                    cm=compact_rows(st.cm[0], perm_t, n_keep)[None],
                    pos=compact_rows(st.pos[0], perm_t, n_keep)[None],
                    alive=(torch.arange(self._cap, device=perm_t.device) < n_keep)[None],
                    n_rows=torch.full_like(st.n_rows, n_keep),
                )
                self.kin.params = permute_params(self.kin.params, perm_t, n_keep)
            self._apply_perm(perm, n_keep)

        w = self.world
        w.n_cells = n_keep
        if self._token_store is not None:
            # hand the tensors back wholesale: no decode, no encode
            w._genome_store.adopt(self._token_store.tokens, self._token_store.lengths)
        else:
            w.cell_genomes = [self._genomes[i] for i in range(n_keep)]
        w.cell_labels = [self._labels[i] for i in range(n_keep)]
        w._np_positions = self._positions.copy()
        w._np_lifetimes = self._lifetimes.copy()
        w._np_divisions = self._divisions.copy()
        cmap = np.zeros((w.map_size, w.map_size), dtype=bool)
        live = self._positions[:n_keep]
        cmap[live[:, 0], live[:, 1]] = True
        w._np_cell_map = cmap
        w._molecule_map = self._state.mm[0]
        w._cell_molecules = self._state.cm[0]
        w._positions_dev = self._state.pos[0]
        w._mm_cache = None
        w._cm_cache = None
        # the world is the source of truth now; the next step re-pulls it
        self._needs_attach = True
        # a flush is a reporting boundary: a counters row (a fresh "last"
        # for the summary's deltas), then the buffered rows go to disk
        self.telemetry.emit_counters()
        self.telemetry.flush()

    def check_consistency(self) -> None:
        """Assert device and replayed host state agree (a test helper; it
        fetches whole tensors)."""
        st = self._state
        occ = fetch_host(st.occ[0])
        pos = fetch_host(st.pos[0])
        alive_dev = fetch_host(st.alive[0])
        n_rows_dev = int(fetch_host(st.n_rows)[0])
        assert n_rows_dev == self._n_rows, (n_rows_dev, self._n_rows)
        assert (alive_dev == self._alive).all()
        live = np.nonzero(self._alive)[0]
        assert (pos[live] == self._positions[live]).all()
        want_occ = np.zeros_like(occ)
        want_occ[self._positions[live, 0], self._positions[live, 1]] = True
        assert (occ == want_occ).all()
        enc = self._positions[live, 0].astype(np.int64) * occ.shape[0] + self._positions[live, 1]
        assert len(np.unique(enc)) == len(live)
