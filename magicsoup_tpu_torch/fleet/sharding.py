"""
World-axis sharding: data-parallel fleets over a mesh of ranks.
Counterpart of :mod:`magicsoup_tpu.fleet.sharding`.

Worlds are independent, so the fleet's world axis shards with no
collectives: a 1D ``"world"`` mesh gives every rank its contiguous block
of worlds, and each rank steps its block with the same program the
single-device fleet runs (:func:`~magicsoup_tpu_torch.fleet.batch.fleet_step_program`,
one batched integrator launch per simulated step for the rank's
block).  This composes with, but is distinct from, the row and slot
sharding of :mod:`magicsoup_tpu_torch.parallel.tiled`: a fleet world is
itself single-device (the scheduler refuses a mesh-placed one), and
scale-out for fleets is more worlds per mesh, not bigger worlds.

In deterministic mode the sharded fleet step is bit-identical to the
unsharded one: nothing reduces across worlds, so placement reorders no
float work.
"""
from __future__ import annotations

import torch

from magicsoup_tpu_torch.fleet.batch import fleet_step_program
from magicsoup_tpu_torch.ops import backends as _backends
from magicsoup_tpu_torch.parallel import tiled
from magicsoup_tpu_torch.stepper import DispatchInputs, StepConsts

__all__ = [
    "WORLD_AXIS",
    "make_world_mesh",
    "shard_fleet",
    "sharded_fleet_step",
]

WORLD_AXIS = "world"


def make_world_mesh(n_devices: int | None = None, *, device=None) -> tiled.Mesh:
    """1D mesh over the joined process group's ranks along the fleet's
    world axis (:func:`~magicsoup_tpu_torch.parallel.tiled.make_mesh`).
    ``device`` defaults to this rank's card, and without one raises
    naming ``device='cpu'``."""
    if device is None:
        device = tiled.default_device("make_world_mesh")
    return tiled.make_mesh(n_devices, axis_name=WORLD_AXIS, device=device)


def _block(x, lo: int, hi: int):
    if x is None:
        return None
    if torch.is_tensor(x):
        return x[lo:hi].clone()
    return tuple(x[lo:hi])


def shard_fleet(tree, mesh: tiled.Mesh):
    """This rank's contiguous block of worlds of a stacked fleet tuple
    (a ``DeviceState``, ``CellParams``, ``StepConsts`` or
    ``DispatchInputs``): every per-world entry sliced on its leading
    world axis, which must divide by the mesh's size; a
    ``DispatchInputs``' static spawn budget stays as it is."""
    if isinstance(tree, DispatchInputs):
        lo, hi = mesh.block(tree.div_budget.shape[0])
        return tree._replace(
            spawn_valid=_block(tree.spawn_valid, lo, hi),
            spawn_dense=_block(tree.spawn_dense, lo, hi),
            push=_block(tree.push, lo, hi),
            div_budget=_block(tree.div_budget, lo, hi),
        )
    if isinstance(tree, StepConsts):
        lo, hi = mesh.block(tree.kernels.shape[0])
    else:
        lo, hi = mesh.block(tree[0].shape[0])
    return type(tree)(*(_block(x, lo, hi) for x in tree))


def sharded_fleet_step(
    mesh: tiled.Mesh,
    *,
    det: bool,
    max_div: int,
    n_rounds: int,
    k: int,
    integrator: str | None = None,
):
    """The world-sharded fleet step for ``mesh`` with the given statics:
    ``step(fstate, fparams, consts, inputs, compact=())`` takes this
    rank's block (:func:`shard_fleet`) and ``compact`` as global world
    indices, and returns the block's next state and parameters and its
    ``(B / n, k, record)`` records, as
    :func:`~magicsoup_tpu_torch.fleet.batch.fleet_step_program` does for
    the whole stack.  No collective runs.  ``integrator`` defaults to the
    numeric mode's backend on ``mesh.device`` (``cuda`` on a card,
    ``torch-det`` in deterministic mode), as a fleet world's."""
    name, _ = _backends.resolve(integrator, deterministic=bool(det), device_type=mesh.device.type)

    def step(fstate, fparams, consts, inputs, compact: tuple = ()):
        lo = mesh.rank * fstate.cm.shape[0]
        hi = lo + fstate.cm.shape[0]
        return fleet_step_program(
            fstate,
            fparams,
            consts,
            inputs,
            det=bool(det),
            max_div=int(max_div),
            n_rounds=int(n_rounds),
            k=int(k),
            integrator=name,
            compact=tuple(w - lo for w in compact if lo <= w < hi),
        )

    return step
