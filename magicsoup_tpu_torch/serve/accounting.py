"""
Per-tenant accounting.  Counterpart of
:mod:`magicsoup_tpu.serve.accounting`, with its rules unchanged.

Every number is folded from host-side state the serving loop already
holds (lane ``stats``, the process-wide device->host fetch census
:func:`magicsoup_tpu_torch.telemetry.fetch_stats`, the device-time census
:func:`magicsoup_tpu_torch.telemetry.metrics.device_time_stats` and the
scheduler's megastep bookkeeping): accounting adds no device work and no
transfer.

Per tenant the ledger tracks:

- ``steps``: world steps served (tenant megasteps x the lane's
  ``megastep``); they sum exactly to the steps the service dispatched.
- ``megasteps`` and ``dispatches``: one per group megastep the tenant
  rode (B tenants sharing a group each count the shared dispatch).
- ``fetch_bytes``: the tenant's share of the physical fetch traffic.  The
  fleet fetches one record per group megastep, or one envelope record for
  all fused groups; each observed byte delta is split evenly over the
  tenants stepped in that window, remainder to the first in sorted order,
  so the shares sum EXACTLY to the process total (also for megasteps that
  only some tenants rode).  The port's record layout is its own, so its
  byte counts are not the JAX package's; their conservation is the same.
- ``device_us``: the tenant's share of measured device time, integer
  microseconds, split by the same rule.
- ``sentinel_trips`` / ``invariant_trips``: health trips, folded as deltas
  of the lane's own counters so a lane swap (restore) never bills twice.

Rows serialize as telemetry ``{"type": "accounting", ...}`` records
(:func:`magicsoup_tpu_torch.telemetry.summary.validate_rows`), and the
ledger round-trips through checkpoint meta, so a restarted service
resumes billing where it stopped.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["AccountingLedger", "TenantAccount"]

_COUNTER_FIELDS = (
    "steps",
    "megasteps",
    "dispatches",
    "fetch_bytes",
    "device_us",
    "sentinel_trips",
    "invariant_trips",
)


@dataclass
class TenantAccount:
    """One tenant's cumulative resource usage."""

    tenant: str
    world: int  # warden label (stream prefix id)
    steps: int = 0
    megasteps: int = 0
    dispatches: int = 0
    fetch_bytes: int = 0
    device_us: int = 0
    sentinel_trips: int = 0
    invariant_trips: int = 0
    # last-seen lane counters (trips are folded as deltas so a lane
    # swap on restore never re-bills the restored counter values)
    _seen_sentinel: int = 0
    _seen_invariant: int = 0

    def row(self) -> dict:
        """The telemetry/summary ``accounting`` row."""
        out = {"type": "accounting", "tenant": self.tenant, "world": self.world}
        out.update({k: getattr(self, k) for k in _COUNTER_FIELDS})
        return out


class AccountingLedger:
    """The service-wide fold of :class:`TenantAccount` records."""

    def __init__(self):
        self._accounts: dict[str, TenantAccount] = {}

    def open(self, tenant: str, world: int) -> TenantAccount:
        """Create (or return) the account for ``tenant``."""
        acct = self._accounts.get(tenant)
        if acct is None:
            acct = TenantAccount(tenant=tenant, world=int(world))
            self._accounts[tenant] = acct
        return acct

    def get(self, tenant: str) -> TenantAccount:
        return self._accounts[tenant]

    def charge_megastep(self, tenant: str, k: int) -> None:
        """One group megastep served: ``k`` fused world steps and one
        device dispatch."""
        acct = self._accounts[tenant]
        acct.steps += int(k)
        acct.megasteps += 1
        acct.dispatches += 1

    def charge_fetch(self, tenants, nbytes: int) -> None:
        """Distribute ``nbytes`` of observed fetch traffic over the
        tenants stepped in this window — even split, remainder to the
        first in sorted order, so shares always sum to ``nbytes``."""
        nbytes = int(nbytes)
        tenants = sorted(tenants)
        if nbytes <= 0 or not tenants:
            return
        share, rem = divmod(nbytes, len(tenants))
        for i, tid in enumerate(tenants):
            self._accounts[tid].fetch_bytes += share + (rem if i == 0 else 0)

    def charge_device_time(self, tenants, us: int) -> None:
        """Distribute ``us`` microseconds of measured device time over
        the tenants stepped in this window — the fetch_bytes split
        (even, remainder to the first in sorted order), so per-tenant
        shares sum EXACTLY to the measured total."""
        us = int(us)
        tenants = sorted(tenants)
        if us <= 0 or not tenants:
            return
        share, rem = divmod(us, len(tenants))
        for i, tid in enumerate(tenants):
            self._accounts[tid].device_us += share + (rem if i == 0 else 0)

    def sync_trips(self, tenant: str, sentinel: int, invariant: int) -> None:
        """Fold the lane's trip counters in as deltas vs last seen."""
        acct = self._accounts[tenant]
        acct.sentinel_trips += max(0, int(sentinel) - acct._seen_sentinel)
        acct.invariant_trips += max(0, int(invariant) - acct._seen_invariant)
        acct._seen_sentinel = int(sentinel)
        acct._seen_invariant = int(invariant)

    def rebase_trips(self, tenant: str, sentinel: int, invariant: int) -> None:
        """Reset the last-seen lane counters WITHOUT billing — call
        after swapping a tenant's lane (restore/recover), where the new
        lane's counters describe already-billed history."""
        acct = self._accounts[tenant]
        acct._seen_sentinel = int(sentinel)
        acct._seen_invariant = int(invariant)

    # -------------------------------------------------- persistence
    def snapshot_one(self, tenant: str) -> dict:
        """Plain-JSON counters for checkpoint meta."""
        acct = self._accounts[tenant]
        return {k: getattr(acct, k) for k in _COUNTER_FIELDS}

    def restore_one(self, tenant: str, world: int, counters: dict) -> None:
        """Re-seat a tenant's counters from checkpoint meta."""
        acct = self.open(tenant, world)
        for k in _COUNTER_FIELDS:
            setattr(acct, k, int(counters.get(k, 0)))

    def rows(self) -> list[dict]:
        """All accounting rows, tenant-sorted (stable across calls)."""
        return [
            self._accounts[t].row() for t in sorted(self._accounts)
        ]

    def total_steps(self) -> int:
        return sum(a.steps for a in self._accounts.values())

    def total_fetch_bytes(self) -> int:
        return sum(a.fetch_bytes for a in self._accounts.values())

    def total_device_us(self) -> int:
        return sum(a.device_us for a in self._accounts.values())
