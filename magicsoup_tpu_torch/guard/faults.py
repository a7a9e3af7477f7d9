"""
Fault injection: the hooks that make each guard mechanism's failure
happen on demand.  Counterpart of :mod:`magicsoup_tpu.guard.faults`, over
the port's objects.

- :func:`flip_byte` corrupts a checkpoint file in place (the digest check
  and ``load_latest``'s walk-back),
- :func:`inject_nan` poisons live device state (the health sentinel
  lanes and the quarantine and rollback policies),
- :func:`inject_dispatch_failures` makes the next N step dispatches raise
  a transient error (the bounded retry),
- :func:`desync_cell_map`, :func:`inject_dead_residue` and
  :func:`corrupt_params_row` seed the three corruptions the deep audit
  (``check.audit_world``) must each reject with a typed violation,
- :func:`poison_world_mm` and :func:`corrupt_world_params` are their
  fleet twins: they poison one world of a running
  :class:`~magicsoup_tpu_torch.fleet.FleetScheduler`, writing into that
  world's slice of the group's stacked tensors while the lane is
  resident.

A device tensor is never written in place here: the poisoned value goes
into a copy that replaces the original, as the JAX package's functional
``.at[].set`` does, so a tensor shared with the world (after a flush) is
left as it was.
"""
import os
from pathlib import Path

from magicsoup_tpu_torch.guard.errors import TransientDispatchError


def _with(t, idx, value=None, add=None):
    """A copy of tensor ``t`` with ``t[idx]`` set to ``value`` (or
    increased by ``add``)."""
    out = t.clone()
    if add is not None:
        out[idx] += add
    else:
        out[idx] = value
    return out


def flip_byte(path, offset: int | None = None, *, rng=None) -> int:
    """Flip one byte of ``path`` in place; returns the offset flipped.

    The default offset is the first payload byte (past the magic and the
    header line), so the corruption exercises the digest check rather
    than the header parse.  Pass ``rng`` (``random.Random``) to pick a
    random payload offset reproducibly.
    """
    path = Path(path)
    data = bytearray(path.read_bytes())
    if len(data) == 0:
        raise ValueError(f"cannot flip a byte of empty file {path}")
    if offset is None:
        start = data.find(b"\n", data.find(b"\n") + 1) + 1
        if start <= 0 or start >= len(data):
            start = 0
        if rng is not None:
            offset = rng.randrange(start, len(data))
        else:
            offset = start
    offset = int(offset) % len(data)
    data[offset] ^= 0xFF
    # deliberately not atomic: this stands in for on-disk corruption of
    # an already complete file, not a torn write
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    return offset


def inject_nan(target, *, row: int = 0, mol: int = 0) -> None:
    """Poison one concentration with NaN.

    ``target`` is a ``PipelinedStepper`` (poisons its device state, so
    the next step's sentinel lanes see it; a fleet lane is checked out of
    its group stack first, where its device truth lives, and goes back
    in at the next fleet step) or a ``World`` (poisons the cell-molecule
    tensor the classic step integrates).
    """
    if hasattr(target, "_state"):
        st = target
        if getattr(st, "_fleet_resident", False):
            st._checkout()
        st._state = st._state._replace(cm=_with(st._state.cm, (0, row, mol), float("nan")))
    else:
        w = target
        w._cell_molecules = _with(w._cell_molecules, (row, mol), float("nan"))
        w._cm_cache = None


def desync_cell_map(world) -> tuple:
    """Clear one occupied pixel of the host occupancy map without
    removing its cell: the desync ``check.audit_world`` reports as
    ``cell_map_desync``.  Returns the ``(row, col)`` cleared."""
    import numpy as np

    hits = np.argwhere(world._np_cell_map)
    if len(hits) == 0:
        raise ValueError("world has no occupied pixels to desync")
    r, c = (int(x) for x in hits[0])
    world._np_cell_map[r, c] = False
    return r, c


def inject_dead_residue(world, *, mol: int = 0, value: float = 1.0) -> int:
    """Write a nonzero concentration into a dead cell row (the first row
    past the live prefix): the residue ``check.audit_world`` reports as
    ``dead_cm_residue``.  Returns the corrupted row."""
    row = int(world.n_cells)
    if row >= world._cell_molecules.shape[0]:
        raise ValueError("world is at capacity: no dead rows to corrupt")
    world._cell_molecules = _with(world._cell_molecules, (row, mol), value)
    world._cm_cache = None
    return row


def _pick_translated_row(world) -> int:
    """First audited (sampled) live row whose genome translates to at
    least one protein: a row the audit's re-translation looks at."""
    from magicsoup_tpu_torch.check.audit import _sample_rows

    n = int(world.n_cells)
    counts, _, _ = world.genetics.translate_genomes_flat(list(world.cell_genomes))
    row = next((i for i in _sample_rows(n, 8) if int(counts[i]) > 0), None)
    if row is None:
        raise ValueError(
            "no sampled cell translates to any protein; nothing for "
            "the cross-check to catch"
        )
    return row


def corrupt_params_row(world, *, row: int | None = None) -> int:
    """Raise a live cell's Vmax without touching its genome: the
    params/genome desync ``check.audit_world`` reports as
    ``params_genome_mismatch``.  Returns the row."""
    if row is None:
        row = _pick_translated_row(world)
    kin = world.kinetics
    kin.params = kin.params._replace(Vmax=_with(kin.params.Vmax, (row, 0), add=7.0))
    return row


def poison_world_mm(scheduler, slot: int, *, mol: int = 0, pixel=(0, 0)) -> None:
    """Poison one fleet world's molecule map with NaN (``slot`` indexes
    ``scheduler.lanes``).  While the lane is resident its device truth
    is the group's stacked state, so the NaN goes into that world's
    slice and the other worlds are untouched."""
    lane = scheduler.lanes[slot]
    r, c = pixel
    if lane._fleet_resident:
        group, gslot = lane._fleet_slot
        group.fstate = group.fstate._replace(
            mm=_with(group.fstate.mm, (gslot, mol, r, c), float("nan"))
        )
    else:
        lane._state = lane._state._replace(
            mm=_with(lane._state.mm, (0, mol, r, c), float("nan"))
        )


def corrupt_world_params(scheduler, slot: int, *, row: int | None = None) -> int:
    """Fleet twin of :func:`corrupt_params_row`: raise one world's Vmax
    on an audited row, in the group's stacked parameters when the lane
    is resident.  Returns the row."""
    lane = scheduler.lanes[slot]
    if row is None:
        row = _pick_translated_row(lane.world)
    if lane._fleet_resident:
        group, gslot = lane._fleet_slot
        group.fparams = group.fparams._replace(
            Vmax=_with(group.fparams.Vmax, (gslot, row, 0), add=7.0)
        )
    else:
        lane.kin.params = lane.kin.params._replace(
            Vmax=_with(lane.kin.params.Vmax, (row, 0), add=7.0)
        )
    return row


def inject_dispatch_failures(stepper, n: int = 1) -> None:
    """Arm the stepper so its next ``n`` dispatches raise
    :class:`TransientDispatchError` before anything is enqueued.  The
    error carries a transient marker, so a stepper built with
    ``dispatch_retries >= n`` absorbs the faults and its trajectory is
    unchanged."""
    if not hasattr(stepper, "_fault_dispatch"):
        raise TypeError(f"{type(stepper).__name__} has no dispatch fault hook")
    stepper._fault_dispatch = int(n)


def consume_dispatch_fault(stepper) -> None:
    """Stepper side (called before a dispatch enqueues anything): raise
    one armed fault, counting down."""
    count = getattr(stepper, "_fault_dispatch", 0)
    if count > 0:
        stepper._fault_dispatch = count - 1
        raise TransientDispatchError()
