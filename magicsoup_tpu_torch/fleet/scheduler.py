"""
FleetScheduler: admit and retire worlds, pack same-rung worlds into
groups, and step the fleet with ONE dispatch and ONE record fetch per
group per megastep, or per fused set of groups.  Counterpart of
:mod:`magicsoup_tpu.fleet.scheduler`.

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

Cross-rung fusion
    ``fusion="fleet"`` steps every live group as ONE dispatch with ONE
    record fetch; ``"auto"`` packs groups greedily, largest record
    footprint first, while every member's padded records stay within
    ``fusion_waste`` of the envelope.  A fused dispatch interleaves the
    rungs' step bodies at their native shapes around one grouped
    integrator launch per simulated step
    (:func:`~magicsoup_tpu_torch.fleet.batch.fused_step_program`), pads
    the records to the grow-only ``(k_env, rec_env)`` envelope and
    concatenates them, so each world computes what its own group step
    computes.  Every group of a set is densified before anything is
    enqueued, so the chaos ``dispatch`` site and ``dispatch_retries``
    keep their rule.  The census counts one dispatch carrying R groups
    and one integrator dispatch per backend.

The warden (:mod:`magicsoup_tpu_torch.fleet.warden`) binds itself as
``_warden``: admissions and retirements are reported to it, and it runs
its policy at the top of every ``step()``.  Sharding the world axis over
devices is not ported (ROADMAP A9).
"""
import threading
import time
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import NamedTuple

import numpy as np

from magicsoup_tpu_torch.analysis import runtime as _runtime
from magicsoup_tpu_torch.fleet.batch import (
    extract_world,
    fleet_step_program,
    fused_step_program,
    insert_world,
    lane_consts,
    stack_consts,
    stack_worlds,
    zeros_world_like,
)
from magicsoup_tpu_torch.fleet.lanes import FleetLane
from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.stepper import (
    DeviceState,
    crop_fused_record,
    dispatch_inputs,
    record_length,
)

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


class _FusedSliceFetch:
    """A lane's view of a cross-rung fused fetch: its native ``(k,
    record)`` megastep record cropped out of its world-row of the
    envelope-padded buffer (the replay never sees the pad)."""

    __slots__ = ("_shared", "_row", "_k", "_length")

    def __init__(self, shared: _SharedFetch, row: int, k: int, length: int):
        self._shared = shared
        self._row = row
        self._k = k
        self._length = length

    def done(self) -> bool:
        return self._shared.done()

    def result(self, timeout=None):
        return crop_fused_record(
            self._shared.result(timeout=timeout)[self._row], self._k, self._length
        )


class _GroupInputs(NamedTuple):
    """One group's device inputs, densified: the shared front half of the
    per-rung and the fused dispatch."""

    first: FleetLane  # the first member: settings, fetcher, retries
    lane_plans: dict  # slot -> _DispatchPlan
    B: int  # slot count
    cap: int  # cell capacity (q of every member)
    k: int  # megastep
    length: int  # the rung's record length
    statics: tuple  # (det, max_div, n_rounds, k, integrator)
    inputs: object  # DispatchInputs
    compact: tuple  # slots that compact at the last step


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
        fusion: ``"rung"`` (default): one dispatch per group; ``"fleet"``:
            one dispatch and one fetch for every live group; ``"auto"``:
            fused sets whose members' padded records stay within
            ``fusion_waste``, the rest per group.
        fusion_waste: For ``"auto"``, the largest share of a member's
            fetched record envelope that may be padding
            (``1 - (k L) / (k_env rec_env)``), in [0, 1).
    """

    def __init__(
        self,
        *,
        block: int = 4,
        grow: str = "pad",
        fusion: str = "rung",
        fusion_waste: float = 0.5,
    ):
        if block < 1:
            raise ValueError("block must be >= 1")
        if grow not in ("pad", "double"):
            raise ValueError('grow must be "pad" or "double"')
        if fusion not in ("rung", "fleet", "auto"):
            raise ValueError('fusion must be "rung", "fleet" or "auto"')
        if not 0.0 <= float(fusion_waste) < 1.0:
            raise ValueError("fusion_waste must be in [0, 1)")
        self.fusion = fusion
        self.fusion_waste = float(fusion_waste)
        self.block = 1 << (int(block) - 1).bit_length()
        self.grow = grow
        self.lanes: list[FleetLane] = []
        self._groups: dict[tuple, list[_FleetGroup]] = {}
        # rung key -> grow-only (max_proteins, max_doms)
        self._rung_caps: dict[tuple, tuple[int, int]] = {}
        # the grow-only record envelope of fused fetch buffers
        self._env_k = 0
        self._env_rec = 0
        self._warden = None  # bound by fleet.warden.FleetWarden

    # ------------------------------------------------------------ #
    # membership                                                   #
    # ------------------------------------------------------------ #

    def admit(self, world, **stepper_kwargs) -> FleetLane:
        """Wrap ``world`` in a :class:`FleetLane` and join the fleet;
        placement into a group happens at the next ``step()``."""
        lane = FleetLane(world, **stepper_kwargs)
        lane._fleet = self
        # the warden readmits a healed world with the same kwargs
        lane._admit_kwargs = dict(stepper_kwargs)
        self.lanes.append(lane)
        if self._warden is not None:
            self._warden._on_admit(lane)
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
        if self._warden is not None:
            self._warden._on_retire(lane)
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
        if self._warden is not None:
            self._warden._on_admit(lane)
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
        with one dispatch and one fetch per group, or per fused set of
        groups (one for the whole fleet under ``fusion="fleet"``)."""
        if self._warden is not None:
            # evictions, heals and cadence saves settle membership before
            # any plan is prepared
            self._warden.before_step()
        plans = {id(lane): lane._prepare_dispatch() for lane in list(self.lanes)}
        self._place()
        live = [
            group
            for siblings in list(self._groups.values())
            for group in list(siblings)
            if group.members()
        ]
        for fused_set in self._plan_fusion(live):
            if len(fused_set) == 1:
                self._dispatch_group(fused_set[0], plans)
            else:
                self._dispatch_fused(fused_set, plans)

    def _plan_fusion(self, groups: list) -> list[list]:
        """Partition the live groups into dispatch sets: singletons under
        ``"rung"``, one set under ``"fleet"``; under ``"auto"`` a greedy
        packing, largest record footprint (k L) first, that admits a group
        into a set only while every member's footprint is at least
        ``1 - fusion_waste`` of the grow-only envelope the merged set
        would fetch under."""
        if self.fusion == "rung" or len(groups) <= 1:
            return [[g] for g in groups]
        if self.fusion == "fleet":
            return [list(groups)]
        geo = {}
        for g in groups:
            _, first = g.members()[0]
            geo[id(g)] = (
                first.megastep,
                record_length(first._cap, first.max_divisions, first.spawn_block),
            )
        order = sorted(
            range(len(groups)),
            key=lambda i: (-geo[id(groups[i])][0] * geo[id(groups[i])][1], i),
        )
        sets: list[list] = []
        for i in order:
            g = groups[i]
            for s in sets:
                cand = s + [g]
                k_env = max(self._env_k, max(geo[id(x)][0] for x in cand))
                rec_env = max(self._env_rec, max(geo[id(x)][1] for x in cand))
                envelope = k_env * rec_env
                if all(
                    geo[id(x)][0] * geo[id(x)][1] >= (1.0 - self.fusion_waste) * envelope
                    for x in cand
                ):
                    s.append(g)
                    break
            else:
                sets.append([g])
        return sets

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

    def _prepare_group(self, group: _FleetGroup, plans: dict) -> _GroupInputs:
        """Stack one group and densify its members' planned batches."""
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
        cap = group.fstate.cm.shape[1]
        return _GroupInputs(
            first=first,
            lane_plans=lane_plans,
            B=len(group.slots),
            cap=cap,
            k=first.megastep,
            length=record_length(cap, first.max_divisions, first.spawn_block),
            statics=(
                bool(first.world.deterministic),
                first.max_divisions,
                first.n_rounds,
                first.megastep,
                str(first.world.integrator),
            ),
            inputs=inputs,
            compact=tuple(slot for slot, plan in lane_plans.items() if plan.compact),
        )

    def _dispatch_group(self, group: _FleetGroup, plans: dict) -> None:
        gi = self._prepare_group(group, plans)
        first = gi.first
        det, max_div, n_rounds, k, integrator = gi.statics
        t_dispatch0 = time.perf_counter()
        # the chaos dispatch site fires before anything is enqueued, so a
        # retried group dispatch sends the same inputs
        group.fstate, group.fparams, fouts = first._dispatch_with_retry(
            lambda: fleet_step_program(
                group.fstate,
                group.fparams,
                group.consts,
                gi.inputs,
                det=det,
                max_div=max_div,
                n_rounds=n_rounds,
                k=k,
                integrator=integrator,
                compact=gi.compact,
            ),
            lane_faults=False,
        )
        t_dispatched = time.perf_counter()
        _runtime.note_dispatch(dispatches=1, fused_groups=1)
        # the one group step ran every world's integrator steps: ONE count
        _runtime.note_integrator_dispatch(integrator)
        # one census entry for the physical dispatch; every member's
        # recorder gets the whole span (the group step ran for each)
        members = group.members()
        ready = first._device_ready(t_dispatched, [lane for _, lane in members])
        shared = _SharedFetch(
            first._fetch(fouts, ready),
            timeout=first._fetch_timeout,
            context={"B": gi.B, "k": k, "slots": [slot for slot, _ in members]},
        )
        for slot, lane in members:
            lane._fused_tags = {}
            lane._commit_dispatch(
                gi.lane_plans[slot],
                _SliceFetch(shared, slot),
                q=gi.cap,
                t_dispatch0=t_dispatch0,
                t_dispatched=t_dispatched,
                extra_row={"fleet_slot": slot, "fleet_size": gi.B},
            )

    def _dispatch_fused(self, fused_set: list, plans: dict) -> None:
        """ONE dispatch and ONE record fetch for a fused set of groups:
        every group is stacked and densified first, then
        :func:`~magicsoup_tpu_torch.fleet.batch.fused_step_program` steps
        them with one grouped integrator launch per simulated step, and
        each lane crops its native record out of its row of the
        ``(sum B_r, k_env, rec_env)`` buffer."""
        prepped = [self._prepare_group(group, plans) for group in fused_set]
        # grow-only envelope: membership churn never shrinks the buffer
        self._env_k = max(self._env_k, max(p.k for p in prepped))
        self._env_rec = max(self._env_rec, max(p.length for p in prepped))
        k_env, rec_env = self._env_k, self._env_rec
        statics = tuple(p.statics for p in prepped)
        first = prepped[0].first
        t_dispatch0 = time.perf_counter()
        new_states, new_params, fouts = first._dispatch_with_retry(
            lambda: fused_step_program(
                tuple(g.fstate for g in fused_set),
                tuple(g.fparams for g in fused_set),
                tuple((g.consts, p.inputs, p.compact) for g, p in zip(fused_set, prepped)),
                statics=statics,
                k_env=k_env,
                rec_env=rec_env,
            ),
            lane_faults=False,
        )
        t_dispatched = time.perf_counter()
        for group, fs, fp in zip(fused_set, new_states, new_params):
            group.fstate, group.fparams = fs, fp
        _runtime.note_dispatch(dispatches=1, fused_groups=len(fused_set))
        # one count per backend the fused dispatch ran
        for name in sorted({s[4] for s in statics}):
            _runtime.note_integrator_dispatch(name)
        riders = [lane for group in fused_set for _, lane in group.members()]
        shared = _SharedFetch(
            first._fetch(fouts, first._device_ready(t_dispatched, riders)),
            timeout=first._fetch_timeout,
            context={
                "fused_groups": len(fused_set),
                "worlds": sum(p.B for p in prepped),
                "envelope": [k_env, rec_env],
            },
        )
        tags = {"fused_groups": len(fused_set), "envelope": [k_env, rec_env]}
        row_base = 0
        for group, p in zip(fused_set, prepped):
            for slot, lane in group.members():
                lane._fused_tags = dict(tags)
                lane._commit_dispatch(
                    p.lane_plans[slot],
                    _FusedSliceFetch(shared, row_base + slot, p.k, p.length),
                    q=p.cap,
                    t_dispatch0=t_dispatch0,
                    t_dispatched=t_dispatched,
                    extra_row={"fleet_slot": slot, "fleet_size": p.B, **tags},
                )
            row_base += p.B
