"""
Fleet lanes: one :class:`~magicsoup_tpu_torch.stepper.PipelinedStepper` per
admitted world, its device state resident in the group's stacked tensors
instead of its own.  Counterpart of :mod:`magicsoup_tpu.fleet.lanes`.

A lane keeps the whole solo host machinery (spawn and push queues, replay,
growth and compaction decisions); only the device boundary changes: the
scheduler runs the lane's ``_prepare_dispatch``, dispatches one group
step, and hands the lane its slice of the shared fetch through
``_commit_dispatch``.

Checkout protocol: while resident, ``lane._state`` and ``lane.kin.params``
are stale — the truth is the group stack.  Every operation that touches
them on the host (flush, consistency check, standalone pushes, token
growth) first checks the lane out; the scheduler re-inserts checked-out
lanes before the next group dispatch.
"""
from magicsoup_tpu_torch.stepper import PipelinedStepper

__all__ = ["FleetLane"]


class FleetLane(PipelinedStepper):
    """A :class:`PipelinedStepper` whose device state is a slot of a fleet
    group's stacked tensors; after ``retire`` it is a plain stepper."""

    def __init__(self, world, **kwargs):
        self._fleet = None
        self._fleet_slot = None  # (group, slot index) while a member
        self._fleet_resident = False  # device truth lives in the stack
        super().__init__(world, **kwargs)

    def _checkout(self) -> None:
        """Pull this lane's slice out of the group stack (no-op when
        detached or already checked out)."""
        if self._fleet is not None and self._fleet_resident:
            self._fleet._checkout(self)

    def flush(self) -> None:
        self._checkout()
        super().flush()

    def check_consistency(self) -> None:
        self._checkout()
        super().check_consistency()

    def _grow_tokens(self, n_prots: int, n_doms: int) -> None:
        # the resize pads kin.params: pad the truth, not a stale copy
        if n_prots > self.kin.max_proteins or n_doms > self.kin.max_doms:
            self._checkout()
        super()._grow_tokens(n_prots, n_doms)

    def _apply_push_now(self, genomes, rows, seq) -> None:
        # standalone pushes write kin.params directly
        self._checkout()
        super()._apply_push_now(genomes, rows, seq)

    def _guard_row_extra(self) -> dict:
        # tag guard telemetry rows with the lane's place in its group
        if self._fleet_slot is not None:
            group, slot = self._fleet_slot
            return {"fleet_slot": slot, "fleet_size": len(group.slots)}
        return {}

    def step(self) -> None:
        if self._fleet is not None:
            raise RuntimeError(
                "lane is managed by a FleetScheduler — drive it with "
                "scheduler.step(), or retire() it for solo stepping"
            )
        super().step()
