"""
Jobs that the mesh tests run on every rank of a
``magicsoup_tpu_torch.parallel.launch.RankPool`` (each is ``fn(mesh, ...)``,
returns host values).  They import the port only; the test modules hold
their results against the JAX package and the port on one device.
``mesh=None`` runs the same job on one CPU device.
"""
import random

import numpy as np
import torch

import magicsoup_tpu_torch as mt
from magicsoup_tpu_torch.analysis import runtime
from magicsoup_tpu_torch.check.differential import state_digest
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
from magicsoup_tpu_torch.parallel import tiled


def _world(mesh, *, seed, map_size, n_cells, genome_size=500, det=True, chemistry=CHEMISTRY, **kw):
    world = mt.World(
        chemistry=chemistry,
        map_size=map_size,
        seed=seed,
        mesh=mesh,
        device=None if mesh is not None else "cpu",
        **kw,
    )
    world.deterministic = det
    rng = random.Random(seed)
    world.spawn_cells([mt.random_genome(s=genome_size, rng=rng) for _ in range(n_cells)])
    return world


def api_lifecycle(mesh, *, det: bool, steps: int = 5, seed: int = 9, map_size: int = 64):
    """The JAX package's ``tests/fast/test_parallel.py::_lifecycle``: the
    classic API's full lifecycle; returns the state digest, the cell
    count and the rank's block shapes."""
    world = mt.World(
        chemistry=CHEMISTRY,
        map_size=map_size,
        seed=seed,
        mesh=mesh,
        device=None if mesh is not None else "cpu",
    )
    world.deterministic = det
    rng = random.Random(1)
    world.spawn_cells([mt.random_genome(s=500, rng=rng) for _ in range(64)])
    for _ in range(steps):
        world.enzymatic_activity()
        cm = world.cell_molecules
        world.kill_cells(np.nonzero(cm[:, 2] < 0.2)[0].tolist())
        cm = world.cell_molecules
        world.divide_cells(np.nonzero(cm[:, 2] > 4.0)[0].tolist())
        world.mutate_cells(p=1e-4)
        world.recombinate_cells(p=1e-6)
        world.degrade_molecules()
        world.diffuse_molecules()
        world.increment_cell_lifetimes()
    mm = world.molecule_map.numpy()
    return {
        "digest": state_digest(world),
        "n_cells": world.n_cells,
        "finite": bool(np.isfinite(mm).all() and (mm >= 0).all()),
        "mm_block": tuple(world._block("_molecule_map").shape),
        "cm_block": tuple(world._block("_cell_molecules").shape),
        "vmax_block": tuple(world.kinetics.params.Vmax.shape),
    }


def sharded_step(mesh, *, det: bool, steps: int, degrade: bool = True):
    """``tiled.make_sharded_step`` on the rank's blocks of a seeded world
    (``mesh=None``: the World's own single-device steps); returns the
    whole map and cell molecules after ``steps`` steps."""
    world = _world(None, seed=31, map_size=32, n_cells=32, det=det, mol_map_init="randn")
    if not degrade:
        world._degrad_factors = torch.ones_like(world._degrad_factors)
    n = world.n_cells
    if mesh is None:
        for _ in range(steps):
            world.enzymatic_activity()
            world.diffuse_molecules()
            world.degrade_molecules()
        return world.molecule_map.numpy(), world.cell_molecules.copy()
    mm, cm, pos, params = tiled.shard_world_state(world, mesh)
    step = tiled.make_sharded_step(
        mesh, world._diff_kernels, world._perm_factors, world._degrad_factors, det=det
    )
    for _ in range(steps):
        mm, cm = step(mm, cm, pos, n, params)
    return mesh.all_gather(mm, 1).numpy(), mesh.all_gather(cm, 0).numpy()[:n]


def one_tile_halo(mesh, mm: np.ndarray, kernels: np.ndarray, det: bool):
    """``halo_diffuse`` over a one-rank mesh (the first rank of the
    group; the others get ``None``) against ``diffuse``."""
    from magicsoup_tpu_torch.ops import diffusion

    one = tiled.make_mesh(1, device="cpu")
    if one is None:
        return None
    got = tiled.halo_diffuse(torch.from_numpy(mm), torch.from_numpy(kernels), one, det=det)
    want = diffusion.diffuse(torch.from_numpy(mm), torch.from_numpy(kernels), det=det)
    return got.numpy().tobytes() == want.numpy().tobytes()


def divisibility_error(mesh) -> str:
    """The message of a mesh World whose map does not split."""
    try:
        mt.World(chemistry=CHEMISTRY, map_size=mesh.size * 8 + 1, seed=1, mesh=mesh)
    except ValueError as exc:
        return str(exc)
    return ""


def device_and_mesh_error(mesh) -> str:
    try:
        mt.World(chemistry=CHEMISTRY, map_size=16, seed=1, mesh=mesh, device="cpu")
    except ValueError as exc:
        return str(exc)
    return ""


def default_device_errors(mesh) -> list:
    """The messages of the mesh entry points left to their default
    device on a rank with no card (each must raise, naming the CPU)."""
    from magicsoup_tpu_torch.fleet import sharding
    from magicsoup_tpu_torch.parallel import multihost

    msgs = []
    for make in (
        tiled.make_mesh,
        lambda: tiled.Mesh(mesh.group),
        multihost.global_mesh,
        sharding.make_world_mesh,
    ):
        try:
            make()
        except RuntimeError as exc:
            msgs.append(str(exc))
        else:
            msgs.append("")
    return msgs


def load_state_keeps_placement(mesh, statedir: str):
    """``save_state`` then ``load_state`` of a mesh world (each rank in
    its own directory): the blocks stay the rank's, the state comes
    back."""
    world = _world(mesh, seed=41, map_size=64, n_cells=16, genome_size=300)
    before = state_digest(world)
    path = f"{statedir}/rank{mesh.rank}"
    world.save_state(statedir=path)
    world.load_state(statedir=path)
    return {
        "n_cells": world.n_cells,
        "same": state_digest(world) == before,
        "mm_block": tuple(world._block("_molecule_map").shape),
        "cm_block": tuple(world._block("_cell_molecules").shape),
        "vmax_block": tuple(world.kinetics.params.Vmax.shape),
    }


def pickle_drops_mesh(mesh):
    """A mesh world's pickle holds the whole state and no mesh: it loads
    as a one-device world with the same state."""
    import pickle

    world = _world(mesh, seed=3, map_size=16, n_cells=10, genome_size=200)
    back = pickle.loads(pickle.dumps(world))
    return {
        "mesh_free": back._mesh is None and back.kinetics.mesh is None,
        "same": state_digest(back) == state_digest(world),
        "mm": tuple(back._block("_molecule_map").shape),
        "vmax": tuple(back.kinetics.params.Vmax.shape),
    }


def custom_axis(mesh, jsonl: str):
    """A mesh under another axis name: a world steps, its stepper writes
    dispatch rows naming the axis and step rows with tile lanes."""
    rows = tiled.Mesh(mesh.group, axis_name="rows", device=mesh.device)
    world = _world(rows, seed=43, map_size=32, n_cells=8, genome_size=300, det=False)
    world.enzymatic_activity()
    world.diffuse_molecules()
    mm = world.molecule_map.numpy()
    # every rank records (a token world's step row reads the store, a
    # collective); rank 0 into ``jsonl``
    world.telemetry.attach(jsonl if rows.rank == 0 else f"{jsonl}.{rows.rank}")
    st = mt.PipelinedStepper(world, target_cells=None, lag=1)
    for _ in range(3):
        st.step()
    st.flush()
    return {"axis": rows.axis_names, "finite": bool(np.isfinite(mm).all())}


def three_tile_capacity(mesh):
    """The JAX package's non-pow2 mesh test: a 33-row map over 3 ranks;
    the capacity rounds to a tile multiple and the stepper runs."""
    world = _world(mesh, seed=7, map_size=33, n_cells=70, genome_size=300, det=False)
    st = mt.PipelinedStepper(world, target_cells=None, lag=2)
    for _ in range(3):
        st.step()
    st.flush()
    st.check_consistency()
    return {
        "capacity": world._capacity,
        "n_cells": world.n_cells,
        "cm_block": tuple(world._block("_cell_molecules").shape),
        "mm_block": tuple(world._block("_molecule_map").shape),
    }


def collective_census(mesh, *, steps: int):
    """Collectives (calls, bytes) of a mesh world's classic step and of
    the pipelined stepper's simulated step, fast mode, the torch-fast
    integrator (its early stop all-reduces once per correction
    increment) and the det integrator."""
    world = _world(mesh, seed=51, map_size=64, n_cells=32, genome_size=300, det=False)
    runtime.reset_counters()
    world.enzymatic_activity()
    world.degrade_and_diffuse_molecules()
    classic = runtime.collective_stats()
    st = mt.PipelinedStepper(world, target_cells=None, lag=1)
    st.step()
    st.drain()
    runtime.reset_counters()
    for _ in range(steps):
        st.step()
    st.drain()
    stepper = runtime.collective_stats()
    st.flush()
    map_bytes = world.n_molecules * world.map_size**2 * 4
    return {"classic": classic, "stepper": stepper, "map_bytes": map_bytes, "cap": world._capacity}


def sharded_stepper_world(mesh, *, seed=7, map_size=32, n_cells=50, det=False):
    """The JAX package's ``tests/fast/test_sharded_stepper.py::_world``."""
    mols = [
        mt.Molecule("shs-a", 10e3),
        mt.Molecule("shs-atp", 8e3, half_life=100_000),
        mt.Molecule("shs-c", 4e3, permeability=0.3),
    ]
    chem = mt.Chemistry(molecules=mols, reactions=[([mols[0]], [mols[1]]), ([mols[1]], [mols[2]])])
    return _world(
        mesh, seed=seed, map_size=map_size, n_cells=n_cells, genome_size=300, det=det,
        chemistry=chem,
    )


SHARDED_STEPPER_KW = dict(
    mol_name="shs-atp",
    kill_below=0.2,
    divide_above=2.5,
    divide_cost=1.0,
    target_cells=60,
    genome_size=300,
    lag=2,
    p_mutation=1e-4,
    p_recombination=1e-5,
)


def sharded_stepper(mesh, *, megastep: int, steps: int = 6, jsonl: str | None = None, **kw):
    """The sharded stepper test's run: ``steps`` dispatches of the stepper
    then a flush; returns the state digest, the stats and the length of
    the first record."""
    world = sharded_stepper_world(mesh, det=True, **kw)
    if jsonl is not None:
        world.telemetry.attach(jsonl if mesh is None or mesh.rank == 0 else f"{jsonl}.{mesh.rank}")
    st = mt.PipelinedStepper(world, **dict(SHARDED_STEPPER_KW, megastep=megastep))
    seen = []
    orig = st._unpack_outputs

    def spy(arr):
        seen.append(len(arr))
        return orig(arr)

    st._unpack_outputs = spy
    for _ in range(steps):
        st.step()
    st.flush()
    st.check_consistency()
    return {
        "digest": state_digest(world),
        "n_cells": world.n_cells,
        "record": seen[0],
        "cap": st._cap,
        "n_tiles": st._n_tiles,
        "stats": {k: v for k, v in st.stats.items() if not k.endswith("_ms")},
    }


def save_for_resume(mesh, *, ckdir: str, steps: int):
    """A det stepper run checkpointed after ``steps`` dispatches (rank 0
    writes under a mesh); returns the digest at the checkpoint."""
    from magicsoup_tpu_torch import guard

    world = sharded_stepper_world(mesh, det=True)
    st = mt.PipelinedStepper(world, **SHARDED_STEPPER_KW)
    for _ in range(steps):
        st.step()
    guard.save_run(guard.CheckpointManager(ckdir), world, st)
    return state_digest(world)


def resume(mesh, *, ckdir: str, steps: int):
    """``restore_run`` from ``ckdir`` (onto ``mesh``, or one CPU device),
    the stepper re-seated, ``steps`` more dispatches; returns the digest
    and the restored world's placement."""
    from magicsoup_tpu_torch import guard

    mgr = guard.CheckpointManager(ckdir)
    if mesh is None:
        world, aux, _ = guard.restore_run(mgr, device="cpu")
    else:
        world, aux, _ = guard.restore_run(mgr, mesh=mesh)
    st = mt.PipelinedStepper(world, **SHARDED_STEPPER_KW)
    guard.restore_stepper(st, aux)
    for _ in range(steps):
        st.step()
    st.flush()
    return {
        "digest": state_digest(world),
        "tiles": st._n_tiles,
        "mm_block": tuple(world._block("_molecule_map").shape),
    }


def uninterrupted(mesh, *, steps: int, flush_at: int):
    """The run :func:`save_for_resume` + :func:`resume` reproduce: a
    flush (the checkpoint's drain) after ``flush_at`` dispatches."""
    world = sharded_stepper_world(mesh, det=True)
    st = mt.PipelinedStepper(world, **SHARDED_STEPPER_KW)
    for i in range(steps):
        if i == flush_at:
            st.flush()
        st.step()
    st.flush()
    return state_digest(world)


def load_arrays(mesh, arrays: dict, *, det: bool = True):
    """``interop.load_world_arrays`` of one exported world into a world on
    ``mesh`` (every rank takes its blocks), then one activity and
    physics step; returns the state digest and the rank's blocks."""
    from magicsoup_tpu_torch.interop import load_world_arrays

    world = mt.World(
        chemistry=CHEMISTRY,
        map_size=arrays["molecule_map"].shape[1],
        seed=3,
        mesh=mesh,
        device=None if mesh is not None else "cpu",
    )
    world.deterministic = det
    load_world_arrays(world, arrays)
    loaded = state_digest(world)
    world.enzymatic_activity()
    world.degrade_and_diffuse_molecules()
    return {
        "loaded": loaded,
        "stepped": state_digest(world),
        "vmax_block": tuple(world.kinetics.params.Vmax.shape),
    }


def fleet_refuses_mesh_world(mesh) -> str:
    from magicsoup_tpu_torch.fleet import FleetScheduler

    world = _world(mesh, seed=1, map_size=16, n_cells=4, genome_size=200)
    try:
        FleetScheduler(block=2).admit(world)
    except ValueError as exc:
        return str(exc)
    return ""

