"""
FleetScheduler: admit and retire worlds, pack same-rung worlds into
groups, and step the fleet with ONE dispatch and ONE record fetch per
group per megastep.  Counterpart of :mod:`magicsoup_tpu.fleet.scheduler`
with ``fusion="rung"``.

Grouping
    Worlds are bucketed by capacity rung: every shape and setting the
    group step depends on (state shapes, spawn and push blocks, megastep,
    division cap, rounds, numeric mode, integrator, device).  Each rung
    owns sibling groups of ``block`` slots; with ``grow="pad"`` a full rung
    opens another block-sized group, with ``grow="double"`` its one group
    doubles.  Token capacities are unified per rung, grow-only.

Stepping
    ``step()`` runs every lane's solo ``_prepare_dispatch`` (all host
    decisions are the unchanged solo code), re-buckets lanes whose rung
    changed, unifies token capacities, densifies the planned batches and
    runs one group step per group: every phase once for all its worlds
    and one batched integrator launch per simulated step.  The members
    share one fetch of the ``(B, k, record)`` output, and each replays
    its slice through the unchanged solo replay.

Telemetry and guard
    Each lane writes its rows to its own world's recorder; every member
    of a group dispatch gets the dispatch's ``"device"`` span, its
    ``spawn``/``push``/``param_assembly`` spans and a ``dispatch`` row
    tagged with its ``fleet_slot`` and ``fleet_size``.  The group
    dispatch probes the chaos ``dispatch`` site and retries through the
    first lane's ``dispatch_retries``, only while nothing is enqueued.

Cross-rung fusion (``fusion="fleet"`` / ``"auto"``), the warden,
persistence and sharding are not ported.
"""
import threading
import time
from concurrent.futures import TimeoutError as _FuturesTimeout

import numpy as np

from magicsoup_tpu_torch.analysis import runtime as _runtime
from magicsoup_tpu_torch.fleet.batch import (
    extract_world,
    fleet_step_program,
    insert_world,
    lane_consts,
    stack_consts,
    stack_worlds,
    zeros_world_like,
)
from magicsoup_tpu_torch.fleet.lanes import FleetLane
from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.stepper import DeviceState, dispatch_inputs

__all__ = ["FleetScheduler"]


class _SharedFetch:
    """ONE device->host fetch of a group's batched record, shared by every
    member lane.  A fetch past the watchdog budget dumps diagnostics
    naming the group (``context``) and raises a typed error."""

    def __init__(self, fut, *, timeout=None, context=None):
        self._fut = fut
        self._value = None
        self._lock = threading.Lock()
        self._timeout = timeout
        self._context = dict(context or {})

    def done(self) -> bool:
        return self._value is not None or self._fut.done()

    def result(self, timeout=None):
        with self._lock:
            if self._value is None:
                budget = timeout if timeout is not None else self._timeout
                try:
                    self._value = np.asarray(self._fut.result(timeout=budget))
                except (TimeoutError, _FuturesTimeout) as exc:
                    from magicsoup_tpu_torch.guard.errors import WatchdogTimeout
                    from magicsoup_tpu_torch.guard.watchdog import dump_diagnostics

                    dump_diagnostics(
                        "fleet fetch timed out",
                        {"phase": "fleet-fetch", "timeout_s": budget, **self._context},
                    )
                    raise WatchdogTimeout(
                        f"fleet step-record fetch exceeded {budget:.0f}s",
                        phase="fleet-fetch",
                        seconds=budget,
                    ) from exc
                self._fut = None  # drop the device buffer reference
            return self._value


class _SliceFetch:
    """A lane's view of the shared fetch: its ``(k, record)`` slice."""

    __slots__ = ("_shared", "_slot")

    def __init__(self, shared: _SharedFetch, slot: int):
        self._shared = shared
        self._slot = slot

    def done(self) -> bool:
        return self._shared.done()

    def result(self, timeout=None):
        return self._shared.result(timeout=timeout)[self._slot]


def _rung_key(lane: FleetLane) -> tuple:
    """Everything the group step's shapes and settings depend on; token
    capacities are excluded (unified per rung, grow-only)."""
    return (
        tuple(tuple(t.shape[1:]) for t in lane._state),
        lane.spawn_block,
        lane.push_block,
        lane.megastep,
        lane.max_divisions,
        lane.n_rounds,
        bool(lane.world.deterministic),
        str(lane.world.integrator),
        str(lane.world.device),
    )


class _FleetGroup:
    """One capacity rung's stacked state."""

    def __init__(self, key: tuple, block: int):
        self.key = key
        self.slots: list = [None] * block
        self.fstate = None
        self.fparams = None
        self.consts = None
        self.consts_ids: tuple | None = None
        self.maxp = 0
        self.maxd = 0
        self.dirty = True  # restack needed before the next dispatch
        # shape the stack was built at: while it holds, a dirty group
        # restacks incrementally (only changed slots move)
        self.stacked_shape: tuple | None = None
        # vacated slots whose slices still hold a lane's data
        self.stale: set[int] = set()
        self.budget_cache: dict = {}

    def members(self) -> list:
        return [(i, lane) for i, lane in enumerate(self.slots) if lane is not None]


class FleetScheduler:
    """Run independent worlds as rung groups.  ``admit`` wraps a
    :class:`~magicsoup_tpu_torch.World` in a :class:`FleetLane`; ``step``
    advances every admitted world by its ``megastep`` with one dispatch
    and one fetch per group.

    Parameters:
        block: Slot count of a group (rounded up to a power of two).
        grow: ``"pad"`` (default) opens a sibling group when a rung is
            full; ``"double"`` doubles the rung's one group.
        fusion: ``"rung"`` (the only one ported): one dispatch per group.
    """

    def __init__(self, *, block: int = 4, grow: str = "pad", fusion: str = "rung"):
        if block < 1:
            raise ValueError("block must be >= 1")
        if grow not in ("pad", "double"):
            raise ValueError('grow must be "pad" or "double"')
        if fusion != "rung":
            raise ValueError(
                f'fusion="{fusion}": cross-rung fusion is not ported yet;'
                ' use fusion="rung"'
            )
        self.fusion = fusion
        self.block = 1 << (int(block) - 1).bit_length()
        self.grow = grow
        self.lanes: list[FleetLane] = []
        self._groups: dict[tuple, list[_FleetGroup]] = {}
        # rung key -> grow-only (max_proteins, max_doms)
        self._rung_caps: dict[tuple, tuple[int, int]] = {}

    # ------------------------------------------------------------ #
    # membership                                                   #
    # ------------------------------------------------------------ #

    def admit(self, world, **stepper_kwargs) -> FleetLane:
        """Wrap ``world`` in a :class:`FleetLane` and join the fleet;
        placement into a group happens at the next ``step()``."""
        lane = FleetLane(world, **stepper_kwargs)
        lane._fleet = self
        self.lanes.append(lane)
        return lane

    def retire(self, lane: FleetLane) -> FleetLane:
        """Remove ``lane`` from the fleet and return it as a standalone
        stepper; no state is lost."""
        if lane._fleet is not self:
            raise ValueError("lane is not managed by this scheduler")
        if lane._fleet_resident:
            self._checkout(lane)
        if lane._fleet_slot is not None:
            self._vacate(lane)
        self.lanes.remove(lane)
        lane._fleet = None
        return lane

    def readmit(self, lane: FleetLane) -> FleetLane:
        """Re-join a retired lane without rebuilding it: its pipeline
        state is kept, so the round trip does not change its trajectory."""
        if not isinstance(lane, FleetLane):
            raise TypeError("readmit() takes the FleetLane retire() returned")
        if lane._fleet is not None:
            raise ValueError("lane is already managed by a scheduler")
        lane._fleet = self
        self.lanes.append(lane)
        return lane

    def _vacate(self, lane: FleetLane) -> None:
        group, slot = lane._fleet_slot
        group.slots[slot] = None
        group.stale.add(slot)
        group.dirty = True
        group.consts_ids = None
        lane._fleet_slot = None
        if not group.members():
            siblings = self._groups.get(group.key)
            if siblings and group in siblings:
                siblings.remove(group)
                if not siblings:
                    self._groups.pop(group.key, None)

    # ------------------------------------------------------------ #
    # stepping                                                     #
    # ------------------------------------------------------------ #

    def step(self) -> None:
        """One fleet megastep: every world advances ``megastep`` steps,
        with one dispatch and one fetch per group."""
        plans = {id(lane): lane._prepare_dispatch() for lane in list(self.lanes)}
        self._place()
        for siblings in list(self._groups.values()):
            for group in list(siblings):
                if group.members():
                    self._dispatch_group(group, plans)

    def drain(self) -> None:
        """Block until every lane's dispatched steps are replayed."""
        for lane in self.lanes:
            lane.drain()

    def flush(self) -> None:
        """Drain and sync every lane's world (checks every lane out; they
        are re-inserted at the next ``step``)."""
        for lane in self.lanes:
            lane.flush()

    # ------------------------------------------------------------ #
    # placement and restacking                                     #
    # ------------------------------------------------------------ #

    def _place(self) -> None:
        for lane in self.lanes:
            key = _rung_key(lane)
            if lane._fleet_slot is not None:
                if lane._fleet_slot[0].key == key:
                    continue
                # rung changed (capacity growth): leave the old group
                if lane._fleet_resident:
                    self._checkout(lane)
                self._vacate(lane)
            self._assign(lane, key)

    def _assign(self, lane: FleetLane, key: tuple) -> None:
        siblings = self._groups.setdefault(key, [])
        group = next((g for g in siblings if None in g.slots), None)
        if group is None:
            if self.grow == "pad" or not siblings:
                group = _FleetGroup(key, self.block)
                group.maxp, group.maxd = self._rung_caps.get(key, (0, 0))
                siblings.append(group)
            else:
                group = siblings[0]
                group.slots.extend([None] * len(group.slots))
                group.dirty = True
                group.budget_cache.clear()
        slot = group.slots.index(None)
        group.slots[slot] = lane
        group.stale.discard(slot)
        lane._fleet_slot = (group, slot)
        lane._fleet_resident = False
        group.consts_ids = None

    def _checkout(self, lane: FleetLane) -> None:
        group, slot = lane._fleet_slot
        lane._state = DeviceState(*(t[slot : slot + 1].clone() for t in group.fstate))
        lane.kin.params = extract_world(group.fparams, slot)
        lane._fleet_resident = False

    def _insert(self, group: _FleetGroup, slot: int, lane: FleetLane) -> None:
        lane.kin.ensure_token_limits(group.maxp, group.maxd)
        insert_world(group.fstate, slot, DeviceState(*(t[0] for t in lane._state)))
        insert_world(group.fparams, slot, lane.kin.params)
        lane._fleet_resident = True

    def _restack(self, group: _FleetGroup) -> None:
        """Patch the group's stack (only changed slots move) while its
        shape holds; rebuild it otherwise."""
        members = group.members()
        shape = (len(group.slots), group.maxp, group.maxd)
        if group.fstate is not None and group.stacked_shape == shape:
            for slot, lane in members:
                if not lane._fleet_resident:
                    self._insert(group, slot, lane)
            for slot in sorted(group.stale):
                if group.slots[slot] is None:
                    insert_world(group.fstate, slot, zeros_world_like(
                        DeviceState(*(t[slot] for t in group.fstate))))
                    insert_world(group.fparams, slot, zeros_world_like(
                        CellParams(*(t[slot] for t in group.fparams))))
        else:
            for _, lane in members:
                if lane._fleet_resident:
                    self._checkout(lane)
            for _, lane in members:
                lane.kin.ensure_token_limits(group.maxp, group.maxd)
            _, first = members[0]
            zs = zeros_world_like(DeviceState(*(t[0] for t in first._state)))
            zp = zeros_world_like(first.kin.params)
            group.fstate = stack_worlds(
                [DeviceState(*(t[0] for t in lane._state)) if lane is not None else zs
                 for lane in group.slots]
            )
            group.fparams = stack_worlds(
                [lane.kin.params if lane is not None else zp for lane in group.slots]
            )
            for _, lane in members:
                lane._fleet_resident = True
            group.stacked_shape = shape
        group.stale.clear()
        group.dirty = False

    def _ensure_stacked(self, group: _FleetGroup) -> None:
        members = group.members()
        maxp = max(lane.kin.max_proteins for _, lane in members)
        maxd = max(lane.kin.max_doms for _, lane in members)
        # unify token capacities across the whole rung, grow-only
        rp, rd = self._rung_caps.get(group.key, (0, 0))
        maxp, maxd = max(maxp, rp), max(maxd, rd)
        self._rung_caps[group.key] = (maxp, maxd)
        if maxp > group.maxp or maxd > group.maxd:
            group.maxp, group.maxd = max(group.maxp, maxp), max(group.maxd, maxd)
            group.dirty = True
        if group.dirty:
            self._restack(group)
        else:
            for slot, lane in members:
                if not lane._fleet_resident:
                    self._insert(group, slot, lane)
        ids = tuple(
            (id(lane), id(lane.kin.tables)) if lane is not None else None
            for lane in group.slots
        )
        if group.consts is None or ids != group.consts_ids:
            group.consts = stack_consts(
                [lane_consts(lane) if lane is not None else None for lane in group.slots]
            )
            group.consts_ids = ids

    # ------------------------------------------------------------ #
    # group dispatch                                               #
    # ------------------------------------------------------------ #

    def _dispatch_group(self, group: _FleetGroup, plans: dict) -> None:
        self._ensure_stacked(group)
        members = group.members()
        _, first = members[0]
        lane_plans = {slot: plans[id(lane)] for slot, lane in members}
        inputs = dispatch_inputs(
            [
                (lane, lane_plans[slot]) if lane is not None else None
                for slot, lane in enumerate(group.slots)
            ],
            spawn_block=first.spawn_block,
            max_proteins=group.maxp,
            max_doms=group.maxd,
            device=first.world.device,
            budget_cache=group.budget_cache,
        )
        compact = tuple(slot for slot, plan in lane_plans.items() if plan.compact)
        integrator = str(first.world.integrator)
        t_dispatch0 = time.perf_counter()
        # the chaos dispatch site fires before anything is enqueued, so a
        # retried group dispatch sends the same inputs
        group.fstate, group.fparams, fouts = first._dispatch_with_retry(
            lambda: fleet_step_program(
                group.fstate,
                group.fparams,
                group.consts,
                inputs,
                det=bool(first.world.deterministic),
                max_div=first.max_divisions,
                n_rounds=first.n_rounds,
                k=first.megastep,
                integrator=integrator,
                compact=compact,
            ),
            lane_faults=False,
        )
        t_dispatched = time.perf_counter()
        _runtime.note_dispatch(dispatches=1, fused_groups=1)
        # the one group step ran every world's integrator steps: ONE count
        _runtime.note_integrator_dispatch(integrator)
        # one census entry for the physical dispatch; every member's
        # recorder gets the whole span (the group step ran for each)
        ready = first._device_ready(t_dispatched, [lane for _, lane in members])
        B = len(group.slots)
        shared = _SharedFetch(
            first._fetch(fouts, ready),
            timeout=first._fetch_timeout,
            context={"B": B, "k": first.megastep, "slots": [slot for slot, _ in members]},
        )
        cap = group.fstate.cm.shape[1]
        for slot, lane in members:
            lane._commit_dispatch(
                lane_plans[slot],
                _SliceFetch(shared, slot),
                q=cap,
                t_dispatch0=t_dispatch0,
                t_dispatched=t_dispatched,
                extra_row={"fleet_slot": slot, "fleet_size": B},
            )
