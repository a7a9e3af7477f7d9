"""
Deterministic resume: snapshot and restore the full trajectory state.
Counterpart of :mod:`magicsoup_tpu.guard.resume`.

The contract: in deterministic mode, ``[run K, checkpoint, run K]`` is
bit-identical to ``[run K, checkpoint, kill, restore in a fresh process,
run K]``, for the classic step loop and for
:class:`~magicsoup_tpu_torch.stepper.PipelinedStepper` at any megastep.
The uninterrupted reference checkpoints at the same boundary because a
pipelined checkpoint is a flush, and draining the pipeline is part of the
deterministic schedule.  The classic loop has no pipeline, so there
``[run 2K]`` equals the killed and restored run outright.

What a run snapshot carries beyond the world's pickle:

- **Every random stream.**  The world pickle carries ``world._rng`` and
  ``world._nprng``, but a fresh stepper's constructor draws from
  ``world._rng`` twice (its own generator's seed and the device key), so
  :func:`restore_stepper` re-seats all three streams after construction.
- **The device key**, the stepper's ``(B, 2)`` int64 threefry words,
  which the world's pickle never sees; it travels as host numpy and goes
  back onto the stepper's device.
- **The stepper's schedule state**: spawn queue, growth history (it sets
  the division budget and the live-row prefix), change and dispatch
  counters, and stats.

Snapshots are taken at the stepper's flush, where the pipeline is
drained, evolution joined, all pushes applied and the world is the
source of truth (a token world's store handed back), so no pending
dispatch is ever serialized.  The world pickles its tensors as host
numpy and its device as a string; :func:`restore_run` places it on the
device it is given.

Under a mesh every rank calls :func:`save_run` (the world's pickle
gathers its blocks, a collective) and rank 0 alone writes the file;
:func:`restore_run` with ``mesh=`` places the restored world on a mesh
again, whatever it was saved from.  A det checkpoint restores onto any
tile count (the sharded det trajectory is the single-device one), so
:func:`restore_stepper` lets ``n_tiles`` differ in deterministic mode.
"""
import pickle

import numpy as np

from magicsoup_tpu_torch.guard.checkpoint import CheckpointManager, read_checkpoint
from magicsoup_tpu_torch.guard.errors import CheckpointError

RUN_FORMAT = "magicsoup_tpu_torch.guard.run/1"

# constructor knobs that must match between the checkpointing stepper and
# the restoring one: a mismatch silently changes the trajectory, so
# restore_stepper refuses it
_CONFIG_FIELDS = (
    "mol_idx",
    "kill_below",
    "divide_above",
    "divide_cost",
    "target_cells",
    "genome_size",
    "lag",
    "max_lag",
    "megastep",
    "max_divisions",
    "spawn_block",
    "push_block",
    "n_rounds",
    "p_mutation",
    "p_indel",
    "p_del",
    "p_recombination",
    "compact_headroom",
    "compact_dead_slack",
    "auto_grow",
)


def stepper_config(stepper) -> dict:
    """The trajectory-determining constructor knobs of a stepper, with
    the mesh's tile count (1 on one device)."""
    cfg = {name: getattr(stepper, name) for name in _CONFIG_FIELDS}
    cfg["overlap_evolution"] = stepper._evo_worker is not None
    cfg["n_tiles"] = stepper._n_tiles
    cfg["deterministic"] = bool(stepper.world.deterministic)
    return cfg


def snapshot_run(world, stepper=None) -> dict:
    """Build the checkpoint payload of a run.

    With a stepper, flushes it first (drain, evolution join, push apply,
    world sync), so the world alone is the simulation state and the
    stepper adds only its host schedule state.  A classic run
    passes ``stepper=None``: the world's pickle carries its streams.
    """
    from magicsoup_tpu_torch.util import fetch_host

    aux = None
    if stepper is not None:
        stepper.flush()
        aux = {
            "config": stepper_config(stepper),
            "key": np.asarray(fetch_host(stepper._state.key)),
            "rng_state": stepper._rng.bit_generator.state,
            "spawn_queue": [tuple(item) for item in stepper._spawn_queue],
            "growth_hist": list(stepper._growth_hist),
            "change_seq": int(stepper._change_seq),
            "dispatched_seq": int(stepper._dispatched_seq),
            "stats": dict(stepper.stats),
        }
    return {
        "format": RUN_FORMAT,
        "world": world,
        "stepper": aux,
        # captured after any stepper flush; restore_stepper re-seats
        # these after construction (the constructor draws from world._rng)
        "world_rng_state": world._rng.getstate(),
        "world_nprng_state": world._nprng.bit_generator.state,
    }


def save_run(
    manager: CheckpointManager,
    world,
    stepper=None,
    *,
    step: int | None = None,
    meta: dict | None = None,
):
    """Snapshot and write one retained checkpoint; returns its path.
    ``step`` defaults to the stepper's replayed-step counter (or, for a
    classic run, the number of existing checkpoints).  Under a mesh every
    rank calls it and rank 0 writes; the others return ``None``."""
    payload = snapshot_run(world, stepper)
    mesh = getattr(world, "_mesh", None)
    if mesh is not None and mesh.rank != 0:
        # the pickle all-gathers the world's blocks: every rank takes part
        pickle.dumps(payload)
        return None
    if step is None:
        if stepper is not None:
            step = int(stepper.stats["replayed"])
        else:
            step = len(manager.checkpoints())
    return manager.save(payload, step=step, meta=meta)


def _remesh_world(world, mesh) -> None:
    """Place a freshly unpickled world (on ``mesh.device``) over
    ``mesh``: each rank keeps its blocks of the map, the cell tensors,
    the parameters and a token store (pickles are mesh-free)."""
    from magicsoup_tpu_torch.parallel import tiled

    n_tiles = mesh.size
    if world.map_size % n_tiles != 0:
        # typed: a restore loop falling back across checkpoints can tell
        # "this snapshot cannot live on this mesh" from a crash
        raise CheckpointError(
            f"map_size={world.map_size} must be divisible by the first"
            f" mesh axis size {n_tiles} for row sharding",
            check="config",
        )
    if world._capacity % n_tiles != 0:
        raise CheckpointError(
            f"restored capacity {world._capacity} does not split across"
            f" {n_tiles} tiles; checkpoint was taken under a different"
            " mesh size",
            check="config",
        )
    mm, cm = world._molecule_map, world._cell_molecules
    world._mesh = mesh
    world._molecule_map, world._cell_molecules = mm, cm
    world._mm_cache = None
    world._cm_cache = None
    kin = world.kinetics
    kin.mesh = mesh
    kin.params = tiled.shard_params(kin.params, mesh)
    store = world._genome_store
    if store is not None:
        tokens, lengths = store.tokens, store.lengths
        store._mesh = mesh
        store.tokens, store.lengths = tokens, lengths


def restore_run(
    source, *, device=None, mesh=None, audit: bool = False, genome_backend=None
) -> tuple:
    """Load a run checkpoint; returns ``(world, stepper_aux, meta)``.

    ``source`` is a :class:`CheckpointManager` (loads the newest
    verifiable snapshot, walking back over corrupt ones) or the path of
    one ``.msck`` file.  ``device`` is where the world goes: ``None``
    means ``"cuda"``, and without a card that is a ``RuntimeError``
    naming ``device="cpu"``.  ``mesh`` places the world over a mesh
    instead (on ``mesh.device``; every rank restores, collectively).
    ``genome_backend`` continues the run on that genome storage (the
    typed entry for resuming a migrated schema-1 string checkpoint on the
    token backend; the conversion is storage-only).  ``stepper_aux`` is
    ``None`` for a classic checkpoint; otherwise build a stepper with the
    same keyword arguments and hand both to :func:`restore_stepper`.

    ``audit=True`` runs the deep audit
    (:func:`magicsoup_tpu_torch.check.assert_consistent`) on the restored
    world: a checkpoint whose digest verified can still carry a semantic
    desync from before the save.
    """
    from magicsoup_tpu_torch.util import resolve_device, restore_device

    if mesh is not None:
        if device is not None:
            # graftlint: disable=GL022 argument check before anything is read; callers catch ValueError
            raise ValueError("device and mesh are mutually exclusive")
        dev = mesh.device
    else:
        dev = resolve_device(device, "guard.restore_run")
    with restore_device(dev):
        if isinstance(source, CheckpointManager):
            payload, meta, _path = source.load_latest()
        else:
            payload, meta = read_checkpoint(source)
    world, aux = restore_run_payload(
        payload, mesh=mesh, audit=audit, genome_backend=genome_backend
    )
    return world, aux, meta


def restore_run_payload(
    payload, *, mesh=None, audit: bool = False, genome_backend=None
) -> tuple:
    """Restore one run from an in-memory snapshot payload (the dict
    :func:`snapshot_run` builds, already unpickled onto its device);
    returns ``(world, stepper_aux)``.  The verifying I/O stays with the
    caller, so a format nesting several run payloads in one file can
    reuse the single-run restore.  ``mesh`` places the world over it."""
    if not isinstance(payload, dict) or payload.get("format") != RUN_FORMAT:
        raise CheckpointError(
            f"checkpoint payload is not a {RUN_FORMAT} run snapshot "
            f"(got {type(payload).__name__}"
            + (
                f" with format={payload.get('format')!r})"
                if isinstance(payload, dict)
                else ")"
            ),
            check="format",
        )
    world = payload["world"]
    if mesh is not None:
        _remesh_world(world, mesh)
    if genome_backend is not None:
        if genome_backend not in ("string", "token"):
            raise CheckpointError(
                f"unknown genome_backend {genome_backend!r} "
                '(want "string" or "token")',
                check="config",
            )
        if genome_backend != world.genome_backend:
            world.convert_genome_backend(genome_backend)
    # classic resume: re-seat the world's streams here (no stepper
    # constructor will draw from them); a stepper resume re-seats them
    # in restore_stepper
    aux = payload["stepper"]
    if aux is None:
        world._rng.setstate(payload["world_rng_state"])
        world._nprng.bit_generator.state = payload["world_nprng_state"]
    else:
        aux = dict(aux)
        aux["world_rng_state"] = payload["world_rng_state"]
        aux["world_nprng_state"] = payload["world_nprng_state"]
    if audit:
        from magicsoup_tpu_torch.check import assert_consistent

        assert_consistent(world)
    return world, aux


def restore_stepper(stepper, aux: dict) -> None:
    """Re-seat a freshly built stepper to the checkpointed schedule state
    (call it with the world :func:`restore_run` returned and a stepper
    built with the same keyword arguments).

    Refuses (``CheckpointError``, ``check="config"``) when a
    trajectory-determining knob differs: a silently different config
    would break bit-identity unseen.
    """
    from magicsoup_tpu_torch.util import to_device

    want = aux["config"]
    have = stepper_config(stepper)
    diff = sorted(k for k in set(want) | set(have) if want.get(k) != have.get(k))
    # the mesh shape alone does not determine a det trajectory (the
    # sharded det run is the single-device one), so a det checkpoint
    # restores onto another tile count; in fast mode the reduction order
    # follows the shape and the refusal stands
    if "n_tiles" in diff and want.get("deterministic") and have.get("deterministic"):
        diff.remove("n_tiles")
    if diff:
        detail = ", ".join(
            f"{k}: checkpoint={want.get(k)!r} != stepper={have.get(k)!r}" for k in diff
        )
        raise CheckpointError(
            f"stepper config does not match the checkpoint ({detail})",
            check="config",
        )
    # the constructor drew from world._rng (twice): rewind all streams to
    # the snapshot, so the next draw matches the uninterrupted run
    stepper.world._rng.setstate(aux["world_rng_state"])
    stepper.world._nprng.bit_generator.state = aux["world_nprng_state"]
    stepper._rng.bit_generator.state = aux["rng_state"]
    stepper._spawn_queue = [tuple(item) for item in aux["spawn_queue"]]
    stepper._growth_hist = list(aux["growth_hist"])
    stepper._change_seq = int(aux["change_seq"])
    stepper._dispatched_seq = int(aux["dispatched_seq"])
    stepper.stats.update(aux["stats"])
    # re-enter through the post-flush path: the next step() re-attaches
    # from the restored world with the checkpointed device key, as the
    # uninterrupted run does after its flush
    key = np.ascontiguousarray(np.asarray(aux["key"], dtype=np.int64))
    stepper._state = stepper._state._replace(key=to_device(key, stepper.world.device))
    stepper._needs_attach = True
