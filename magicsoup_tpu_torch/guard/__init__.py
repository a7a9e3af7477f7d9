"""
The fault-tolerance plane.  Counterpart of :mod:`magicsoup_tpu.guard`,
with the same ``__all__``:

- **Crash-safe persistence** (:mod:`.io`, :mod:`.checkpoint`): every
  state write goes temp file -> fsync -> ``os.replace``; checkpoint files
  carry a schema version and a content digest, checked before any byte
  is unpickled, and corruption raises a typed :class:`CheckpointError`
  naming the failed check.
- **Deterministic resume** (:mod:`.resume`): a checkpoint holds the world,
  every random stream, the stepper's device key and schedule, so in
  deterministic mode a run killed at a checkpoint and restored in a fresh
  process continues bit-identically.
- **Health sentinels** (:mod:`.sentinel`, :mod:`.watchdog`): the fused
  step packs non-finite and negative-concentration flags into the record
  it already fetches; policies escalate from counting to quarantining
  poisoned cells to raising for a rollback.  The watchdog turns a wedged
  fetch into diagnostics and a typed error instead of a silent hang.
- **Fault injection** (:mod:`.faults`, :mod:`.chaos`): byte flips, NaN
  injection, transient dispatch failures against :mod:`.retry`, and the
  spec-driven fault points.

Quickstart::

    from magicsoup_tpu_torch import guard

    mgr = guard.CheckpointManager("run/checkpoints", keep=3)
    ...
    guard.save_run(mgr, world, stepper)        # at any flush boundary
    # -- process dies --
    world, aux, meta = guard.restore_run(mgr, device="cuda")
    stepper = PipelinedStepper(world, **same_kwargs)
    guard.restore_stepper(stepper, aux)        # bit-identical continue
"""
from magicsoup_tpu_torch.guard.errors import (
    CheckpointError,
    GuardConfigError,
    GuardError,
    InvariantTripped,
    SentinelTripped,
    TransientDispatchError,
    WatchdogTimeout,
)
from magicsoup_tpu_torch.guard.faults import (
    corrupt_params_row,
    corrupt_world_params,
    desync_cell_map,
    flip_byte,
    inject_dead_residue,
    inject_dispatch_failures,
    inject_nan,
    poison_world_mm,
)
from magicsoup_tpu_torch.guard.io import atomic_write_bytes
from magicsoup_tpu_torch.guard.checkpoint import (
    SCHEMA_VERSION,
    CheckpointManager,
    inspect_checkpoint,
    read_checkpoint,
    write_checkpoint,
)
from magicsoup_tpu_torch.guard.resume import (
    restore_run,
    restore_stepper,
    save_run,
    snapshot_run,
    stepper_config,
)
from magicsoup_tpu_torch.guard.retry import is_transient_error, retry_call
from magicsoup_tpu_torch.guard.sentinel import (
    SENTINEL_POLICIES,
    decode_health,
    quarantine_world,
)
from magicsoup_tpu_torch.guard.signals import GracefulShutdown
from magicsoup_tpu_torch.guard.watchdog import Watchdog, dump_diagnostics

__all__ = [
    "GuardError",
    "CheckpointError",
    "GuardConfigError",
    "InvariantTripped",
    "SentinelTripped",
    "TransientDispatchError",
    "WatchdogTimeout",
    "atomic_write_bytes",
    "SCHEMA_VERSION",
    "CheckpointManager",
    "write_checkpoint",
    "read_checkpoint",
    "inspect_checkpoint",
    "snapshot_run",
    "save_run",
    "restore_run",
    "restore_stepper",
    "stepper_config",
    "retry_call",
    "is_transient_error",
    "SENTINEL_POLICIES",
    "decode_health",
    "quarantine_world",
    "GracefulShutdown",
    "Watchdog",
    "dump_diagnostics",
    "flip_byte",
    "inject_nan",
    "inject_dispatch_failures",
    "desync_cell_map",
    "inject_dead_residue",
    "corrupt_params_row",
    "poison_world_mm",
    "corrupt_world_params",
]
