"""
The fleet's device program: B independent worlds, one set of launches.
Counterpart of :mod:`magicsoup_tpu.fleet.batch`.

The JAX package scans its solo step body over the world axis, so inside
its fleet every world runs the solo integrator grid.  Here the step body
is written over the world axis to begin with
(:func:`magicsoup_tpu_torch.stepper.megastep`): a group step enqueues each
phase once for all B worlds, and the integrator is ONE launch of the
batched kernel grid per simulated step — the counterpart of "one program
for B worlds" when no compiled program holds them.  Nothing reduces across
worlds and a kernel tile never crosses one, so world w computes what it
computes alone (bit-equal in deterministic mode).

Compaction is decided per world on the host (each lane's plan), so only
the worlds that compact pay the row sort; the JAX package computes it for
every world and selects, with the same values.

Inactive slots hold all-zero state, parameters and constants: an exact
no-op through every phase (no live row, no spawn, zero diffusion kernels).

Cross-rung fusion (:func:`fused_step_program`) steps several rung groups
as one dispatch: at each simulated step every rung runs its pre-activity
phases at its native shapes, then ONE grouped integrator launch serves
all of them (:func:`magicsoup_tpu_torch.ops.backends.integrate_grouped`),
then every rung runs its post-activity phases.  No state is padded, so
each world's arithmetic and its threefry draws are those of its own
group step; only the records are padded to the fleet's envelope and
concatenated into one fetch buffer.
"""
import torch
import torch.nn.functional as F

from magicsoup_tpu_torch import telemetry as _telemetry
from magicsoup_tpu_torch.ops import backends as _backends
from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.stepper import (
    DeviceState,
    StepConsts,
    det_scope,
    megastep,
    step_post_activity,
    step_pre_activity,
)

__all__ = [
    "extract_world",
    "fleet_step_program",
    "fused_step_program",
    "insert_world",
    "lane_consts",
    "stack_worlds",
    "zeros_world_like",
]


def lane_consts(stepper) -> StepConsts:
    """One lane's constants (world axis of 1), with its current tables."""
    return stepper._consts._replace(
        tables=(stepper.kin.tables,), abs_temp=(stepper.kin._abs_temp_t,)
    )


def stack_consts(consts: list) -> StepConsts:
    """Stack B lanes' constants (None = an empty slot, all zeros)."""
    ref = next(c for c in consts if c is not None)
    zero = StepConsts(
        *(torch.zeros_like(t) for t in ref[:7]), tables=(None,), abs_temp=(None,)
    )
    rows = [zero if c is None else c for c in consts]
    return StepConsts(
        *(torch.cat(ts) for ts in zip(*(r[:7] for r in rows))),
        tables=tuple(r.tables[0] for r in rows),
        abs_temp=tuple(r.abs_temp[0] for r in rows),
    )


def fleet_step_program(
    fstate: DeviceState,
    fparams: CellParams,
    consts: StepConsts,
    inputs,
    *,
    det: bool,
    max_div: int,
    n_rounds: int,
    k: int,
    integrator: str,
    compact: tuple = (),
) -> tuple[DeviceState, CellParams, torch.Tensor]:
    """One group megastep: ``k`` steps of every world over its full
    capacity, the worlds in ``compact`` folding their rows at the last
    step.  Returns the stacked next state and parameters and the
    ``(B, k, record)`` packed records."""
    return megastep(
        fstate,
        fparams,
        consts,
        inputs,
        k=k,
        det=det,
        max_div=max_div,
        n_rounds=n_rounds,
        q=fstate.cm.shape[1],
        integrator=integrator,
        compact=compact,
    )


def fused_step_program(
    states: tuple,
    params: tuple,
    rest: tuple,
    *,
    statics: tuple,
    k_env: int,
    rec_env: int,
) -> tuple[tuple, tuple, torch.Tensor]:
    """One fused megastep of several rung groups, the counterpart of the
    JAX package's one fused program.

    ``states`` and ``params`` hold each rung's stacked state and
    parameters, ``rest`` each rung's ``(consts, inputs, compact)`` and
    ``statics`` its ``(det, max_div, n_rounds, k, integrator)``.
    Simulated step i runs every rung with ``k_r > i`` through
    :func:`~magicsoup_tpu_torch.stepper.step_pre_activity`, then one
    :func:`~magicsoup_tpu_torch.ops.backends.integrate_grouped` call over
    their live-row prefixes (one grouped kernel launch for the ``cuda``
    rungs), then :func:`~magicsoup_tpu_torch.stepper.step_post_activity`;
    each rung's ``compact`` worlds fold at its own last step, and its
    spawns and pushes ride its first.  Each rung's ``(B_r, k_r, L_r)``
    records are zero-padded to ``(k_env, rec_env)`` and concatenated on
    the world axis.  Returns the rungs' new states and parameters and the
    ``(sum B_r, k_env, rec_env)`` record buffer."""
    states, params = list(states), list(params)
    outs: list[list] = [[] for _ in states]
    for i in range(max(st[3] for st in statics)):
        active = [r for r, st in enumerate(statics) if st[3] > i]
        carries, X0s, pqs = {}, [], []
        for r in active:
            det, _, n_rounds, _, _ = statics[r]
            consts, inputs, _ = rest[r]
            with det_scope(det, states[r].cm.device):
                carries[r], X0, pq = step_pre_activity(
                    states[r], params[r], consts, inputs,
                    first=i == 0, n_rounds=n_rounds, q=states[r].cm.shape[1],
                )
            X0s.append(X0)
            pqs.append(pq)
        with _telemetry.span("ms:activity"):
            X1s = _backends.integrate_grouped([statics[r][4] for r in active], X0s, pqs)
        for r, X1 in zip(active, X1s):
            det, max_div, n_rounds, k, _ = statics[r]
            consts, inputs, compact = rest[r]
            with det_scope(det, states[r].cm.device):
                states[r], params[r], out = step_post_activity(
                    carries[r], X1, params[r], consts, inputs,
                    det=det, max_div=max_div, n_rounds=n_rounds,
                    compact=compact if i == k - 1 else (),
                )
            outs[r].append(out)
    records = [
        F.pad(torch.stack(o, dim=1), (0, rec_env - o[0].shape[1], 0, k_env - len(o)))
        for o in outs
    ]
    return tuple(states), tuple(params), torch.cat(records, dim=0)


def stack_worlds(trees: list):
    """Stack per-world tuples of tensors on a new leading world axis."""
    return type(trees[0])(*(torch.stack(ts) for ts in zip(*trees)))


def extract_world(tree, slot: int):
    """A copy of one world's slice of a stacked tuple of tensors."""
    return type(tree)(*(t[slot].clone() for t in tree))


def insert_world(tree, slot: int, sub) -> None:
    """Write one world's tensors into slot ``slot`` of a stack, in place."""
    for t, s in zip(tree, sub):
        t[slot] = s


def zeros_world_like(tree):
    """All-zero tensors shaped like one world's: the inactive-slot filler."""
    return type(tree)(*(torch.zeros_like(t) for t in tree))
