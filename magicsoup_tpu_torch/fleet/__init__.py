"""
Fleets of independent worlds stepped as rung groups: one dispatch and one
record fetch per group per megastep.  Counterpart of
:mod:`magicsoup_tpu.fleet` (the per-rung path; cross-rung fusion, the
warden, persistence and sharding are not ported).
"""
from magicsoup_tpu_torch.fleet.lanes import FleetLane
from magicsoup_tpu_torch.fleet.scheduler import FleetScheduler

__all__ = ["FleetLane", "FleetScheduler"]
