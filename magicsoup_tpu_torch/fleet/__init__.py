"""
Fleets of independent worlds stepped as rung groups: one dispatch and one
record fetch per group per megastep, or per fused set of groups.
Counterpart of :mod:`magicsoup_tpu.fleet`::

    fleet = FleetScheduler(block=4, fusion="fleet")
    a = fleet.admit(world_a, mol_name="ATP", ...)   # solo stepper kwargs
    b = fleet.admit(world_b, mol_name="ATP", ...)
    fleet.step()            # one dispatch and one fetch for the fleet
    fleet.flush()           # sync every World
    solo = fleet.retire(b)  # b goes on as a standalone stepper

Submodules: :mod:`~.batch` (the stacked device program and the fused one),
:mod:`~.lanes` (per-world steppers), :mod:`~.scheduler` (admission, rungs,
fusion, dispatch), :mod:`~.persist` (fleet checkpoints) and
:mod:`~.warden` (per-world fault isolation, rolling checkpoint streams,
self-healing).  Sharding the world axis over several devices
(``magicsoup_tpu.fleet.sharding``) is not ported (ROADMAP A9).
"""
from magicsoup_tpu_torch.fleet.lanes import FleetLane
from magicsoup_tpu_torch.fleet.persist import (
    FLEET_FORMAT,
    restore_fleet,
    restore_world,
    save_fleet,
    snapshot_fleet,
)
from magicsoup_tpu_torch.fleet.scheduler import FleetScheduler
from magicsoup_tpu_torch.fleet.warden import (
    WARDEN_POLICIES,
    FleetWarden,
    WardenStatus,
)

__all__ = [
    "FLEET_FORMAT",
    "WARDEN_POLICIES",
    "FleetLane",
    "FleetScheduler",
    "FleetWarden",
    "WardenStatus",
    "restore_fleet",
    "restore_world",
    "save_fleet",
    "snapshot_fleet",
]
