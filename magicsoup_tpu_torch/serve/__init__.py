"""
Multi-tenant fleet serving with admission control, per-tenant accounting
and a crash-safe tenant lifecycle.  Counterpart of
:mod:`magicsoup_tpu.serve`, with the same ``__all__``, routes and
decisions.

A :class:`FleetService` turns one
:class:`~magicsoup_tpu_torch.fleet.FleetScheduler` /
:class:`~magicsoup_tpu_torch.fleet.FleetWarden` pair into a long-lived
service: independent *tenants* each own one simulated world, admitted
into shared capacity rungs, stepped together by one scheduler loop,
checkpointed to per-tenant rolling streams and billed from counters the
loop already holds.  The front end is a stdlib ``http.server`` JSON API
(see :mod:`.api` for the routes and the tenant spec format).  Worlds live
on the card unless the service is built with ``device="cpu"``.

- :mod:`.service`: :class:`FleetService`, the single-writer scheduler
  loop, bounded command queue, budgeted stepping with budget pauses that
  the trajectory cannot see, the tenant registry and restart recovery,
  the SIGTERM drain and checkpoint.
- :mod:`.api`: spec validation, world and stepper construction, HTTP
  routing (handler threads never touch fleet or device state).
- :mod:`.admission`: :class:`AdmissionController`, warm rungs admit free,
  cold rungs spend a measured compile budget or queue.
- :mod:`.accounting`: :class:`AccountingLedger`, per-tenant steps,
  dispatches, fetch bytes, device time and health trips, exact at drain
  boundaries and persisted through checkpoint meta.

Determinism contract: a tenant's trajectory is a function of its spec and
the megasteps served to it, not of co-tenants, request timing or service
restarts.  Flush points (checkpoint cadence, explicit checkpoint and
digest requests) are part of the schedule, keyed to tenant megasteps;
runs compared for bit-identity must flush at the same tenant steps.

Run a service (``--device cpu`` for the CPU)::

    python -m magicsoup_tpu_torch.serve --dir /var/lib/soup --port 8640
"""
from magicsoup_tpu_torch.serve.accounting import AccountingLedger, TenantAccount
from magicsoup_tpu_torch.serve.admission import AdmissionController
from magicsoup_tpu_torch.serve.api import ServeError
from magicsoup_tpu_torch.serve.service import FleetService, tenant_digest

__all__ = [
    "AccountingLedger",
    "AdmissionController",
    "FleetService",
    "ServeError",
    "TenantAccount",
    "tenant_digest",
]
