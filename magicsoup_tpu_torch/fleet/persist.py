"""
Batch-aware guard checkpoints for fleets.  Counterpart of
:mod:`magicsoup_tpu.fleet.persist`, over the verified ``.msck`` container
and the single-run snapshot of :mod:`magicsoup_tpu_torch.guard.resume`:

- **the whole fleet at once**: :func:`save_fleet` flushes every lane (one
  drain boundary for the fleet) and writes ONE checkpoint file nesting
  one run payload per world; the write is atomic, so a crash mid-save
  never leaves half a fleet on disk.
- **one world out of a fleet**: :func:`restore_world` restores a single
  world's run payload as a standalone :class:`~magicsoup_tpu_torch.World`
  and stepper aux, bit-identical to a solo checkpoint of that world,
  because a lane's snapshot IS a solo ``snapshot_run`` (its flush checks
  the lane out of the group stack first).

A fleet file and a run file each refuse to load as the other, with a
typed :class:`~magicsoup_tpu_torch.guard.errors.CheckpointError`
(``check="format"``).  Restores place the worlds on ``device``: ``None``
means ``"cuda"``, and without a card that is a ``RuntimeError`` naming
``device="cpu"``.
"""
from magicsoup_tpu_torch.guard.checkpoint import (
    CheckpointManager,
    read_checkpoint,
    write_checkpoint,
)
from magicsoup_tpu_torch.guard.errors import CheckpointError
from magicsoup_tpu_torch.guard.resume import (
    restore_run_payload,
    restore_stepper,
    snapshot_run,
)

__all__ = [
    "FLEET_FORMAT",
    "restore_fleet",
    "restore_world",
    "save_fleet",
    "snapshot_fleet",
]

FLEET_FORMAT = "magicsoup_tpu_torch.fleet.run/1"


def snapshot_fleet(scheduler) -> dict:
    """Flush every lane (checking it out of its group stack) and capture
    one single-run payload per world, in admission order."""
    runs = [snapshot_run(lane.world, lane) for lane in scheduler.lanes]
    return {"format": FLEET_FORMAT, "runs": runs}


def save_fleet(target, scheduler, *, step: int = 0, meta: dict | None = None):
    """Atomically write the whole fleet as ONE verified checkpoint.
    ``target`` is a :class:`~magicsoup_tpu_torch.guard.CheckpointManager`
    (step-indexed, rolling retention) or the path of one ``.msck`` file.
    Returns the written path."""
    payload = snapshot_fleet(scheduler)
    meta = {**(meta or {}), "format": FLEET_FORMAT, "worlds": len(payload["runs"])}
    if isinstance(target, CheckpointManager):
        return target.save(payload, step=step, meta=meta)
    return write_checkpoint(target, payload, meta=meta)


def _load(source, device) -> tuple[dict, dict]:
    from magicsoup_tpu_torch.util import resolve_device, restore_device

    dev = resolve_device(device, "fleet.persist")
    with restore_device(dev):
        if isinstance(source, CheckpointManager):
            payload, meta, _path = source.load_latest()
        else:
            payload, meta = read_checkpoint(source)
    if not isinstance(payload, dict) or payload.get("format") != FLEET_FORMAT:
        raise CheckpointError(
            f"checkpoint payload is not a {FLEET_FORMAT} fleet snapshot "
            f"(got {type(payload).__name__}"
            + (
                f" with format={payload.get('format')!r})"
                if isinstance(payload, dict)
                else ")"
            ),
            check="format",
        )
    return payload, meta


def restore_world(
    source, index: int = 0, *, device=None, audit: bool = False, genome_backend=None
) -> tuple:
    """Restore ONE world of a fleet checkpoint as a standalone run on
    ``device``; returns ``(world, stepper_aux, meta)`` as
    :func:`magicsoup_tpu_torch.guard.restore_run` does: build a stepper
    (or admit the world) with the same keyword arguments and hand both to
    ``guard.restore_stepper``.  ``audit`` runs the deep audit on the
    restored world; ``genome_backend`` converts its genome storage."""
    payload, meta = _load(source, device)
    runs = payload["runs"]
    if not -len(runs) <= index < len(runs):
        raise CheckpointError(
            f"fleet checkpoint holds {len(runs)} worlds; index {index} is out of range",
            check="index",
        )
    world, aux = restore_run_payload(runs[index], audit=audit, genome_backend=genome_backend)
    return world, aux, meta


def restore_fleet(
    source,
    scheduler,
    stepper_kwargs,
    *,
    device=None,
    audit: bool = False,
    genome_backend=None,
) -> tuple[list, dict]:
    """Rebuild every world of a fleet checkpoint into ``scheduler``.
    ``stepper_kwargs`` is the keyword dict every lane was built with (or
    a callable ``index -> kwargs``); ``guard.restore_stepper`` refuses a
    trajectory-determining mismatch.  Returns the admitted lanes in
    checkpoint order and the checkpoint's meta."""
    payload, meta = _load(source, device)
    lanes = []
    for i, run in enumerate(payload["runs"]):
        world, aux = restore_run_payload(run, audit=audit, genome_backend=genome_backend)
        kwargs = stepper_kwargs(i) if callable(stepper_kwargs) else dict(stepper_kwargs)
        lane = scheduler.admit(world, **kwargs)
        restore_stepper(lane, aux)
        lanes.append(lane)
    return lanes, meta
