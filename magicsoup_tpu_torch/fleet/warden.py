"""
Per-world fault isolation and self-healing for the fleet.  Counterpart of
:mod:`magicsoup_tpu.fleet.warden`.

The health and invariant lanes of the step record are per world slot, and
every lane decodes its own slice at replay.  The warden adds world-level
policy: without it a lane's ``sentinel_policy`` warns or raises through
the scheduler's shared commit loop, so one world's NaN could take down
every world of its group.  With a :class:`FleetWarden` bound, a lane
reports its trips to the warden (:class:`~.lanes.FleetLane`), which never
raises there:

- ``warn``: per-world ``sentinel``/``invariant`` telemetry rows tagged
  ``world`` and ``fleet_slot``; nothing raises, trips are counted.
- ``quarantine``: the tripped world is evicted from its group at the next
  ``scheduler.step()`` (its slot restacks to zeros, no new stack shape)
  and parked as a standalone stepper; the others keep stepping, in det
  mode bit-equal to a run without the poisoned world's fault.
- ``heal``: quarantine, then restore from the world's rolling checkpoint
  stream and readmit into the rung it left (a free slot of the existing
  group: no new group, no new stack shape, no kernel build), under a
  bounded restart budget with an exponential cooldown that parks the
  world once ``max_restarts`` is spent (the circuit breaker).

Each world gets its own :class:`~magicsoup_tpu_torch.guard.CheckpointManager`
stream, prefix-scoped (``world-<label>-<step>.msck``) so several share one
directory.  A cadence save is a lane flush, part of the det schedule:
compare a warden run with a baseline that saves on the same cadence.  A
failed cadence save is skipped and counted; ``max_save_failures``
consecutive failures raise the typed ``CheckpointError``
(``check="degraded"``).

With pipeline lag L and megastep K a poison is replayed up to L
dispatches after the one that ran it, and eviction happens at the next
``step()``: the window is O((L + 1) K) steps, and the other worlds never
see it.  Under cross-rung fusion each lane still replays its native
record, so none of this changes; the warden's rows carry the lane's
``fused_groups``/``envelope`` tags.
"""
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from magicsoup_tpu_torch.guard import chaos as _chaos
from magicsoup_tpu_torch.guard.backoff import BackoffPolicy
from magicsoup_tpu_torch.guard.checkpoint import CheckpointManager
from magicsoup_tpu_torch.guard.errors import CheckpointError, GuardConfigError

__all__ = ["WARDEN_POLICIES", "FleetWarden", "WardenStatus"]

WARDEN_POLICIES = ("warn", "quarantine", "heal")


@dataclass
class WardenStatus:
    """Typed per-world health status (:meth:`FleetWarden.statuses`).

    ``status`` is one of ``active`` (stepping in the fleet), ``tripped``
    (flagged, eviction pending at the next scheduler step), ``cooldown``
    (evicted, heal scheduled at ``cooldown_until``), ``parked``
    (evicted for good: quarantine policy, no loadable checkpoint, or
    the circuit breaker — see ``reason``), ``suspended`` (checked out by
    a budget pause — :meth:`FleetWarden.suspend` — and
    re-joinable via :meth:`FleetWarden.resume`), ``retired`` (the caller
    retired it manually; the warden no longer tracks it)."""

    label: int
    status: str
    trips: int
    restarts: int
    last_flags: int
    cooldown_until: int | None = None
    reason: str | None = None
    # graceful-degradation accounting: cadence saves that failed and
    # were SKIPPED (the run kept stepping), and whether the stream is
    # currently in its degraded state (consecutive failures > 0)
    save_skips: int = 0
    save_degraded: bool = False


@dataclass
class _WorldRecord:
    """Warden-side bookkeeping for one admitted world."""

    label: int
    lane: Any
    kwargs: dict
    stream: CheckpointManager | None = None
    status: str = "active"
    trips: int = 0
    restarts: int = 0
    last_flags: int = 0
    last_kind: str = ""
    cooldown_until: int | None = None
    reason: str | None = None
    save_skips: int = 0
    save_degraded: bool = False
    extra: dict = field(default_factory=dict)


class FleetWarden:
    """World-level health policy for a
    :class:`~magicsoup_tpu_torch.fleet.FleetScheduler`.

    Attaching a warden re-routes every member lane's sentinel/invariant
    trip handling (the per-slot flag words of the shared fleet fetch)
    away from the solo ``sentinel_policy`` machinery — trips NEVER
    raise through the scheduler's commit loop; they mark the single
    affected world and the policy runs at the next ``scheduler.step()``
    boundary.

    Parameters:
        scheduler: The fleet to guard; ``scheduler._warden`` is bound
            here and every current and future lane is tracked.
        policy: ``warn`` | ``quarantine`` | ``heal`` (see module docs).
        checkpoint_dir: Directory for the per-world rolling checkpoint
            streams (``world-<label>-<step>.msck``; several streams
            share the directory via prefix scoping).  Required for
            ``heal``.
        cadence: Save each ACTIVE world's stream every ``cadence``
            scheduler steps (a lane flush — part of the det schedule).
            ``0`` disables cadence saves.  ``heal`` requires ``>= 1``.
        keep: Rolling retention per world stream.
        max_restarts: Heal budget per world; the breaker parks the
            world when a trip arrives with the budget exhausted.
        backoff_base: Cooldown before the n-th heal is
            ``backoff_base * 2**n`` scheduler steps (the shared
            :class:`~magicsoup_tpu_torch.guard.backoff.BackoffPolicy` ladder).
        audit_on_heal: Run the deep audit on the restored
            world before re-admission (an audit failure walks back is
            NOT attempted — the world parks with the typed reason).
        max_save_failures: The graceful-degradation budget for cadence
            checkpoint saves: a failed save (ENOSPC, EIO — the atomic
            protocol guarantees no torn file) is SKIPPED with a warning
            + counter and retried next cadence; only this many
            CONSECUTIVE failures raise the typed
            :class:`CheckpointError` (``check="degraded"``).  A later
            successful save resets the ladder and clears the degraded
            state.
    """

    def __init__(
        self,
        scheduler,
        *,
        policy: str = "warn",
        checkpoint_dir=None,
        cadence: int = 0,
        keep: int = 3,
        max_restarts: int = 3,
        backoff_base: int = 1,
        audit_on_heal: bool = False,
        max_save_failures: int = 5,
    ):
        if policy not in WARDEN_POLICIES:
            raise GuardConfigError(
                f"warden policy must be one of {WARDEN_POLICIES}, "
                f"got {policy!r}",
                variable="policy",
                value=str(policy),
            )
        if cadence < 0:
            raise GuardConfigError(
                "cadence must be >= 0",
                variable="cadence",
                value=str(cadence),
            )
        if policy == "heal":
            if checkpoint_dir is None:
                raise GuardConfigError(
                    "policy='heal' needs checkpoint_dir: healing rolls "
                    "back from the per-world stream",
                    variable="checkpoint_dir",
                    value="None",
                )
            if cadence < 1:
                raise GuardConfigError(
                    "policy='heal' needs cadence >= 1: a stream nobody "
                    "writes to cannot heal anything",
                    variable="cadence",
                    value=str(cadence),
                )
        if getattr(scheduler, "_warden", None) is not None:
            raise GuardConfigError(
                "scheduler already has a FleetWarden attached",
                variable="scheduler",
                value=repr(scheduler._warden),
            )
        if max_save_failures < 1:
            raise GuardConfigError(
                "max_save_failures must be >= 1",
                variable="max_save_failures",
                value=str(max_save_failures),
            )
        self.scheduler = scheduler
        self.policy = policy
        self.cadence = int(cadence)
        self.keep = int(keep)
        self.max_restarts = int(max_restarts)
        self.backoff_base = int(backoff_base)
        self.audit_on_heal = bool(audit_on_heal)
        self.max_save_failures = int(max_save_failures)
        # restart-cooldown ladder: delay(n) = backoff_base * 2**(n-1),
        # the exact schedule the old inline `backoff_base << restarts`
        # produced, shared with guard.retry
        self._restart_backoff = BackoffPolicy(
            base=float(backoff_base), factor=2.0
        )
        self._dir = Path(checkpoint_dir) if checkpoint_dir is not None else None
        self._records: list[_WorldRecord] = []
        self._by_lane: dict[int, _WorldRecord] = {}
        self._next_label = 0
        self._steps = 0  # scheduler.step() calls seen (cadence clock)
        self._adopting: _WorldRecord | None = None
        self._evicting = None
        scheduler._warden = self
        for lane in scheduler.lanes:
            self._on_admit(lane)

    # ------------------------------------------------------------ #
    # membership tracking (called by the scheduler)                #
    # ------------------------------------------------------------ #

    def _on_admit(self, lane) -> None:
        if self._adopting is not None:
            # heal re-admission: the new lane IS the old world
            rec = self._adopting
            rec.lane = lane
        else:
            rec = _WorldRecord(
                label=self._next_label,
                lane=lane,
                kwargs=dict(getattr(lane, "_admit_kwargs", {})),
            )
            self._next_label += 1
            if self._dir is not None:
                rec.stream = CheckpointManager(
                    self._dir,
                    keep=self.keep,
                    prefix=f"world-{rec.label:03d}",
                )
            self._records.append(rec)
        self._by_lane[id(lane)] = rec

    def _on_retire(self, lane) -> None:
        rec = self._by_lane.pop(id(lane), None)
        if rec is None or lane is self._evicting:
            return  # unknown lane, or our own eviction (status set there)
        rec.status = "retired"
        rec.lane = None

    def manages(self, lane) -> bool:
        """Whether ``lane``'s trips are routed through this warden."""
        return id(lane) in self._by_lane

    # ------------------------------------------------------------ #
    # tenant lifecycle (suspend, resume, adopt)                    #
    # ------------------------------------------------------------ #

    def suspend(self, lane):
        """Retire ``lane`` from the scheduler while KEEPING its warden
        record (label, rolling stream, trip/restart counts) — a serving
        layer's budget pause.  Returns the lane (a standalone stepper
        again); :meth:`resume` re-joins the SAME lane object, so the
        round trip is invisible to the world's trajectory."""
        rec = self._by_lane.get(id(lane))
        if rec is None:
            raise KeyError("warden does not track this lane")
        self._evicting = lane
        try:
            self.scheduler.retire(lane)
        finally:
            self._evicting = None
        rec.status = "suspended"
        return lane

    def resume(self, lane):
        """Re-join a lane parked by :meth:`suspend` — same object, no
        state rebuild (``scheduler.readmit``)."""
        rec = next(
            (
                r
                for r in self._records
                if r.lane is lane and r.status == "suspended"
            ),
            None,
        )
        if rec is None:
            raise KeyError("lane is not suspended by this warden")
        self._adopting = rec
        try:
            self.scheduler.readmit(lane)
        finally:
            self._adopting = None
        rec.status = "active"
        return lane

    def adopt(self, world, *, label: int, **stepper_kwargs):
        """Admit ``world`` under a FORCED label — service restart
        recovery: a tenant restored from its rolling stream must keep
        appending to the same ``world-<label>`` prefix.  Creates (or
        reuses) the record for ``label`` and bumps the label allocator
        past it so later admissions never collide."""
        label = int(label)
        rec = next((r for r in self._records if r.label == label), None)
        if rec is None:
            rec = _WorldRecord(
                label=label, lane=None, kwargs=dict(stepper_kwargs)
            )
            if self._dir is not None:
                rec.stream = CheckpointManager(
                    self._dir,
                    keep=self.keep,
                    prefix=f"world-{rec.label:03d}",
                )
            self._records.append(rec)
        self._next_label = max(self._next_label, label + 1)
        rec.kwargs = dict(stepper_kwargs)
        self._adopting = rec
        try:
            lane = self.scheduler.admit(world, **stepper_kwargs)
        finally:
            self._adopting = None
        rec.status = "active"
        return lane

    def reserve_label(self, label: int) -> None:
        """Keep ``label`` (and everything below it) out of the
        allocator's future assignments WITHOUT creating a record —
        service recovery reserves the labels of registered tenants it
        could NOT restore, so a later admission never reuses a lost
        tenant's ``world-<label>`` stream prefix (rolling retention on
        a reused prefix would rotate the lost tenant's surviving
        checkpoints out of existence)."""
        self._next_label = max(self._next_label, int(label) + 1)

    def label_of(self, lane) -> int:
        """The stable world label behind ``lane`` (stream prefix id)."""
        rec = self._by_lane.get(id(lane))
        if rec is None:
            raise KeyError("warden does not track this lane")
        return rec.label

    def stream_of(self, lane_or_label):
        """The per-world rolling checkpoint stream (by lane object or
        integer label); ``None`` when the warden has no checkpoint_dir."""
        for rec in self._records:
            if rec.lane is lane_or_label or rec.label == lane_or_label:
                return rec.stream
        raise KeyError(f"warden does not track {lane_or_label!r}")

    # ------------------------------------------------------------ #
    # trip intake (called from FleetLane replay — never raises)    #
    # ------------------------------------------------------------ #

    def report(self, lane, kind: str, out) -> None:
        """Record one tripped flag word for ``lane`` — the per-world
        reaction to the per-slot sentinel/invariant lanes.  Emits the
        same telemetry row the solo handler would (plus ``fleet_slot``
        / ``world`` tags) and, under quarantine/heal, marks the world
        for eviction at the next scheduler step.  NEVER raises: the
        whole point is that one world's poison must not unwind the
        shared commit loop under the other B-1 worlds."""
        rec = self._by_lane.get(id(lane))
        if rec is None:
            return
        step = lane.stats["replayed"]
        if kind == "sentinel":
            from magicsoup_tpu_torch.guard.sentinel import decode_health

            flags_int = int(out.health)
            flags = decode_health(out.health)
            lane.stats["sentinel_trips"] += 1
            row = {
                "type": "sentinel",
                "step": step,
                "flags": flags_int,
                "n_bad_cells": (
                    int(out.bad_cells.sum())
                    if out.bad_cells is not None
                    else 0
                ),
            }
        else:
            from magicsoup_tpu_torch.check.invariants import decode_invariants

            flags_int = int(out.invariants)
            flags = decode_invariants(out.invariants)
            lane.stats["invariant_trips"] += 1
            row = {
                "type": "invariant",
                "step": step,
                "flags": flags_int,
                "mass_drift": float(out.mass_drift),
            }
        row.update(flags)
        row["policy"] = f"warden-{self.policy}"
        row["world"] = rec.label
        row.update(lane._guard_row_extra())
        if lane.telemetry.attached:
            lane.telemetry.emit(row)
        rec.trips += 1
        rec.last_flags = flags_int
        rec.last_kind = kind
        if self.policy != "warn" and rec.status == "active":
            rec.status = "tripped"

    # ------------------------------------------------------------ #
    # policy (called by the scheduler at the top of step())        #
    # ------------------------------------------------------------ #

    def pending_policy(self) -> bool:
        """Whether a policy action (eviction of a tripped world, heal of
        a cooled-down one) is waiting for the next step boundary.  The
        serve loop checks this when NO tenant is runnable: a sole
        tripped tenant must still reach its terminal state even though
        ``scheduler.step()`` (which usually calls :meth:`before_step`)
        never runs."""
        return any(
            rec.status in ("tripped", "cooldown") for rec in self._records
        )

    def before_step(self) -> None:
        """One warden tick: evict tripped worlds, heal cooled-down
        ones, run cadence saves.  Runs BEFORE the scheduler prepares
        any dispatch, so membership is settled for this step."""
        step = self._steps
        for rec in self._records:
            if rec.status == "tripped":
                self._evict(rec, step)
        for rec in self._records:
            if (
                rec.status == "cooldown"
                and rec.cooldown_until is not None
                and step >= rec.cooldown_until
            ):
                self._heal(rec, step)
        if self.cadence:
            from magicsoup_tpu_torch.guard.resume import save_run

            for rec in self._records:
                if (
                    rec.status == "active"
                    and rec.stream is not None
                    and step % self.cadence == 0
                ):
                    try:
                        save_run(
                            rec.stream,
                            rec.lane.world,
                            rec.lane,
                            step=step,
                            meta={"world": rec.label},
                        )
                    except OSError as exc:
                        self._save_failed(rec, step, exc)
                    else:
                        self._save_recovered(rec, step)
        self._steps += 1

    # ------------------------------------------------------------ #
    # cadence-save graceful degradation                            #
    # ------------------------------------------------------------ #

    def _save_failed(self, rec: _WorldRecord, step: int, exc: OSError) -> None:
        """One cadence save failed: the run does NOT die.  The skip is
        counted (record + chaos registry + telemetry row), warned once
        per degradation episode, and retried next cadence; only
        ``max_save_failures`` CONSECUTIVE failures escalate to the
        typed error — at that point data loss is unbounded and silence
        would be lying."""
        rec.save_skips += 1
        consecutive = (
            rec.stream.consecutive_save_failures if rec.stream else 1
        )
        subsystem = f"warden.checkpoint.world-{rec.label:03d}"
        _chaos.note_degraded(subsystem, f"{type(exc).__name__}: {exc}")
        _chaos.note_counter("warden_save_skips")
        self._emit(
            rec,
            rec.lane,
            "save_degraded",
            step,
            error=f"{type(exc).__name__}: {exc}",
            save_skips=rec.save_skips,
            consecutive=consecutive,
        )
        if not rec.save_degraded:
            rec.save_degraded = True
            warnings.warn(
                f"cadence checkpoint save for world {rec.label} failed "
                f"({exc}); skipped and counted — retrying next cadence "
                f"(typed error after {self.max_save_failures} consecutive "
                "failures)"
            )
        if consecutive >= self.max_save_failures:
            raise CheckpointError(
                f"cadence checkpoint stream for world {rec.label} is "
                f"degraded: {consecutive} consecutive save failures "
                f"(last: {exc}) exhausted the budget of "
                f"{self.max_save_failures}",
                check="degraded",
                path=rec.stream.directory if rec.stream else None,
            ) from exc

    def _save_recovered(self, rec: _WorldRecord, step: int) -> None:
        if not rec.save_degraded:
            return
        rec.save_degraded = False
        subsystem = f"warden.checkpoint.world-{rec.label:03d}"
        _chaos.clear_degraded(subsystem)
        self._emit(
            rec, rec.lane, "save_recovered", step, save_skips=rec.save_skips
        )

    def _evict(self, rec: _WorldRecord, step: int) -> None:
        lane = rec.lane
        self._evicting = lane
        try:
            self.scheduler.retire(lane)
        finally:
            self._evicting = None
        if (
            self.policy == "heal"
            and rec.stream is not None
            and rec.restarts < self.max_restarts
        ):
            rec.status = "cooldown"
            rec.cooldown_until = step + int(
                self._restart_backoff.delay(rec.restarts + 1)
            )
            self._emit(
                rec,
                lane,
                "quarantine",
                step,
                cooldown_until=rec.cooldown_until,
            )
        else:
            rec.status = "parked"
            rec.cooldown_until = None
            if self.policy == "heal" and rec.restarts >= self.max_restarts:
                rec.reason = (
                    f"circuit breaker: {rec.restarts} restarts exhausted "
                    f"the budget of {self.max_restarts}"
                )
                self._emit(rec, lane, "quarantine", step)
                self._emit(rec, lane, "circuit_break", step)
            else:
                rec.reason = f"quarantined on {rec.last_kind} trip"
                self._emit(rec, lane, "quarantine", step)

    def _heal(self, rec: _WorldRecord, step: int) -> None:
        from magicsoup_tpu_torch.check import AuditFailed
        from magicsoup_tpu_torch.guard.resume import restore_run, restore_stepper

        old_lane = rec.lane
        try:
            world, aux, meta = restore_run(
                rec.stream, device=old_lane.world.device, audit=self.audit_on_heal
            )
        except (CheckpointError, AuditFailed) as exc:
            rec.status = "parked"
            rec.cooldown_until = None
            rec.reason = f"heal failed: {exc}"
            self._emit(rec, old_lane, "heal_failed", step, error=str(exc))
            return
        self._adopting = rec
        try:
            lane = self.scheduler.admit(world, **rec.kwargs)
        finally:
            self._adopting = None
        restore_stepper(lane, aux)
        rec.status = "active"
        rec.restarts += 1
        rec.cooldown_until = None
        rec.reason = None
        # the fresh lane starts with an unattached recorder; fall back
        # to the parked lane's so the heal event lands in the same
        # stream as the quarantine it resolves
        emit_lane = lane if lane.telemetry.attached else old_lane
        self._emit(
            rec,
            emit_lane,
            "heal",
            step,
            restarts=rec.restarts,
            checkpoint_step=meta.get("step"),
        )

    def _emit(self, rec, lane, event: str, step: int, **extra) -> None:
        if lane is None or not lane.telemetry.attached:
            return
        lane.telemetry.emit(
            {
                "type": "warden",
                "event": event,
                "step": step,
                "world": rec.label,
                "policy": self.policy,
                **extra,
            }
        )

    # ------------------------------------------------------------ #
    # inspection                                                   #
    # ------------------------------------------------------------ #

    def statuses(self) -> list[WardenStatus]:
        """Typed status of every world the warden has ever tracked."""
        return [
            WardenStatus(
                label=rec.label,
                status=rec.status,
                trips=rec.trips,
                restarts=rec.restarts,
                last_flags=rec.last_flags,
                cooldown_until=rec.cooldown_until,
                reason=rec.reason,
                save_skips=rec.save_skips,
                save_degraded=rec.save_degraded,
            )
            for rec in self._records
        ]

    def status_of(self, lane_or_label) -> WardenStatus:
        """Status for one world, by lane object or integer label."""
        for rec in self._records:
            if (
                rec.lane is lane_or_label
                or rec.label == lane_or_label
            ):
                return WardenStatus(
                    label=rec.label,
                    status=rec.status,
                    trips=rec.trips,
                    restarts=rec.restarts,
                    last_flags=rec.last_flags,
                    cooldown_until=rec.cooldown_until,
                    reason=rec.reason,
                    save_skips=rec.save_skips,
                    save_degraded=rec.save_degraded,
                )
        raise KeyError(f"warden does not track {lane_or_label!r}")

    def parked(self) -> list:
        """The evicted-for-good lanes (standalone steppers again, state
        intact as of eviction) — inspect, flush, or re-``admit`` them
        manually."""
        return [
            rec.lane
            for rec in self._records
            if rec.status == "parked" and rec.lane is not None
        ]
