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
"""
import torch

from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.stepper import DeviceState, StepConsts, megastep

__all__ = [
    "extract_world",
    "fleet_step_program",
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
