"""
Seeded runs over a mesh, each a function ``fn(mesh, ...)`` that every rank
of a :class:`~magicsoup_tpu_torch.parallel.launch.RankPool` calls in
lockstep; they return host values (digests, arrays, counters), so a
parent can hold the mesh against one device.  ``mesh=None`` runs the
same schedule on one device (``device=``), which is what a mesh run is
held to.  The tests and ``chip_smoke.py``'s mesh phase share them; the
rank processes load them by ``"torch_mesh_runs:<function>"`` with this
directory on their ``PYTHONPATH``.
"""
import os
import random
import time
from contextlib import contextmanager

import numpy as np
import torch

_DET = "MAGICSOUP_TPU_DETERMINISTIC"


@contextmanager
def numeric_mode(det: bool):
    """Worlds built inside take ``det``'s numeric mode (the environment
    variable the World reads at construction)."""
    old = os.environ.get(_DET)
    os.environ[_DET] = "1" if det else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(_DET, None)
        else:
            os.environ[_DET] = old


def make_world(
    mesh,
    *,
    seed: int,
    map_size: int,
    n_cells: int,
    genome_size: int = 500,
    det: bool = True,
    device=None,
):
    """A Wood-Ljungdahl world of ``n_cells`` random genomes drawn from
    ``seed``, on the mesh (or on ``device`` when ``mesh`` is None)."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY

    with numeric_mode(det):
        world = mt.World(
            chemistry=CHEMISTRY,
            map_size=map_size,
            seed=seed,
            mesh=mesh,
            device=None if mesh is not None else device,
        )
    rng = random.Random(seed)
    world.spawn_cells([mt.random_genome(s=genome_size, rng=rng) for _ in range(n_cells)])
    return world


def classic_lifecycle(mesh, *, steps: int, digest_every: int = 1, device=None, **world_kw):
    """The canonical workload step (``workload.sim_step``: activity, kill,
    divide, evolution, physics) ``steps`` times; returns the
    :func:`~magicsoup_tpu_torch.check.differential.state_digest` after the
    spawn and every ``digest_every`` steps, and the final cell count."""
    from magicsoup_tpu_torch import workload
    from magicsoup_tpu_torch.check.differential import state_digest

    world = make_world(mesh, device=device, **world_kw)
    digests = [state_digest(world)]
    rng = random.Random(world_kw["seed"] + 1)
    n_target = world_kw["n_cells"]
    atp = world.chemistry.molname_2_idx["ATP"]
    for i in range(steps):
        workload.sim_step(
            world,
            rng,
            n_cells=n_target,
            genome_size=world_kw.get("genome_size", 500),
            atp_idx=atp,
        )
        if (i + 1) % digest_every == 0:
            digests.append(state_digest(world))
    return {"digests": digests, "n_cells": world.n_cells}


def stepper_run(
    mesh,
    *,
    steps: int,
    megastep: int = 1,
    device=None,
    stepper_kw: dict | None = None,
    **world_kw,
):
    """The pipelined stepper over a world for ``steps`` dispatches, then a
    flush; returns the flushed world's state digest, its cell count and
    the stepper's stats."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.check.differential import state_digest

    world = make_world(mesh, device=device, **world_kw)
    kw = dict(target_cells=world.n_cells, lag=2, megastep=megastep)
    kw.update(stepper_kw or {})
    st = mt.PipelinedStepper(world, **kw)
    for _ in range(steps):
        st.step()
    st.flush()
    return {
        "digest": state_digest(world),
        "n_cells": world.n_cells,
        "stats": {k: v for k, v in st.stats.items() if not k.endswith("_ms")},
    }


def halo_diffusion(mesh, mm: np.ndarray, kernels: np.ndarray, det: bool):
    """:func:`~magicsoup_tpu_torch.parallel.tiled.halo_diffuse` of the
    rank's rows of ``mm``; returns the whole result (gathered)."""
    from magicsoup_tpu_torch.parallel import tiled

    dev = mesh.device
    local = mesh.local(torch.from_numpy(mm).to(dev), 1)
    out = tiled.halo_diffuse(local, torch.from_numpy(kernels).to(dev), mesh, det=det)
    return mesh.all_gather(out, 1).cpu().numpy()


def fleet_sharding(
    mesh,
    *,
    seeds,
    steps: int,
    map_size: int,
    n_cells: int,
    genome_size: int = 300,
    det: bool = True,
    default_integrator: bool = False,
):
    """One fleet group of ``len(seeds)`` worlds built on every rank (on
    the rank's device); ``steps`` steps of the unsharded group program
    over the whole stack and of the world-sharded step over the rank's
    block, from the same state.  Returns whether every leaf of the
    rank's block is bit-equal to the unsharded stack's, the rank's
    world range, and the integrator launches of the sharded steps.
    ``default_integrator`` builds the sharded step without naming the
    integrator (the unsharded one runs the worlds')."""
    from magicsoup_tpu_torch.fleet import FleetScheduler, batch, sharding
    from magicsoup_tpu_torch.ops import cuda_integrate
    from magicsoup_tpu_torch.parallel import tiled
    from magicsoup_tpu_torch.stepper import DispatchInputs

    wmesh = tiled.Mesh(mesh.group, axis_name=sharding.WORLD_AXIS, device=mesh.device)
    dev = mesh.device
    fleet = FleetScheduler(block=len(seeds))
    lanes = [
        fleet.admit(
            make_world(
                None, seed=s, map_size=map_size, n_cells=n_cells, genome_size=genome_size,
                det=det, device=dev,
            ),
            target_cells=None,
            lag=1,
        )
        for s in seeds
    ]
    fleet.step()
    fleet.drain()
    group = lanes[0]._fleet_slot[0]
    first = lanes[0]
    B = len(group.slots)
    inputs = DispatchInputs(
        spawn_block=first.spawn_block,
        spawn_valid=None,
        spawn_dense=(None,) * B,
        push=(None,) * B,
        div_budget=torch.full((B,), 64, dtype=torch.int64, device=dev),
    )
    statics = dict(
        det=first.world.deterministic,
        max_div=first.max_divisions,
        n_rounds=first.n_rounds,
        k=1,
        integrator=first.world.integrator,
    )
    clone = lambda tree: type(tree)(*(t.clone() for t in tree))  # noqa: E731
    ref_state, ref_params = clone(group.fstate), clone(group.fparams)
    loc = [sharding.shard_fleet(t, wmesh) for t in (group.fstate, group.fparams, group.consts, inputs)]
    loc_state, loc_params, loc_consts, loc_inputs = loc
    sharded_statics = dict(statics)
    if default_integrator:
        del sharded_statics["integrator"]
    step = sharding.sharded_fleet_step(wmesh, **sharded_statics)
    launches = 0
    outs_equal = True
    for _ in range(steps):
        ref_state, ref_params, ref_out = batch.fleet_step_program(
            ref_state, ref_params, group.consts, inputs, **statics
        )
        before = cuda_integrate.launches
        loc_state, loc_params, loc_out = step(loc_state, loc_params, loc_consts, loc_inputs)
        launches += cuda_integrate.launches - before
        outs_equal &= _same(wmesh.local(ref_out, 0), loc_out)
    names = [f"state.{f}" for f in ref_state._fields] + [f"params.{f}" for f in ref_params._fields]
    leaves = [
        _same(wmesh.local(r, 0), g)
        for r, g in zip(tuple(ref_state) + tuple(ref_params), tuple(loc_state) + tuple(loc_params))
    ]
    lo, hi = wmesh.block(B)
    return {
        "equal": bool(all(leaves) and outs_equal),
        "differ": [n for n, ok in zip(names, leaves) if not ok] + ([] if outs_equal else ["records"]),
        "leaves": len(leaves),
        "worlds": [lo, hi],
        "launches": launches,
        "alive": int(loc_state.alive.sum()),
    }


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counts() -> dict:
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate, cuda_params, cuda_prng

    return {
        "k1_k2": cuda_integrate.launches,
        "threefry": cuda_prng.launches,
        "assembly": cuda_params.launches,
        **runtime.collective_stats(),
    }


def _zero_counts() -> None:
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate, cuda_params, cuda_prng

    cuda_integrate.launches = cuda_prng.launches = cuda_params.launches = 0
    runtime.reset_counters()


def _finite(world) -> bool:
    mm = world.molecule_map.cpu().numpy()
    cm = world.cell_molecules
    return bool(np.isfinite(mm).all() and (mm >= 0).all() and np.isfinite(cm).all() and (cm >= 0).all())


def headline_mesh(
    mesh,
    *,
    seed: int,
    map_size: int,
    n_cells: int,
    genome_size: int,
    classic_steps: int,
    stepper_steps: int,
    stepper_kw: dict,
    warmup: int = 3,
):
    """A full-width world on ``mesh`` in fast mode: the first step's
    integrator output on the rank's slot block, ``classic_steps`` of the
    canonical workload step, then the pipelined stepper for
    ``stepper_steps`` dispatches after ``warmup``; per window the
    kernel launches, collectives (calls, bytes, host microseconds),
    seconds and the rank's peak memory, the stepper's flag words decoded
    and its tile lanes held to ``n_occupied``."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import workload
    from magicsoup_tpu_torch.check.invariants import decode_invariants
    from magicsoup_tpu_torch.guard.sentinel import decode_health
    from magicsoup_tpu_torch.ops import backends

    dev = mesh.device
    t0 = time.perf_counter()
    world = make_world(mesh, seed=seed, map_size=map_size, n_cells=n_cells,
                       genome_size=genome_size, det=False)
    out = {"spawn_s": time.perf_counter() - t0, "capacity": world._capacity,
           "block": list(mesh.block(world._capacity)), "integrator": world.integrator}
    X0, params = world.integrator_inputs()
    out["first_X1"] = backends.integrate(world.integrator, X0, params, mesh=mesh).cpu().numpy()

    rng = random.Random(seed + 1)
    atp = world.chemistry.molname_2_idx["ATP"]

    def step():
        workload.sim_step(world, rng, n_cells=n_cells, genome_size=genome_size, atp_idx=atp,
                          sync=False)

    step()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(classic_steps):
        step()
    _sync(dev)
    out["classic"] = {"steps": classic_steps, "seconds": time.perf_counter() - t0, **_counts(),
                      "finite_nonneg": _finite(world), "n_cells": world.n_cells}

    st = mt.PipelinedStepper(world, **stepper_kw)
    flags: dict[str, int] = {}
    tiles = {"records": 0, "mismatch": 0}
    unpack = st._unpack_outputs

    def tap(arr):
        rec = unpack(arr)
        for kind, decoded in (("invariant", decode_invariants(rec.invariants)),
                              ("health", decode_health(rec.health))):
            for name, on in decoded.items():
                if on:
                    flags[f"{kind}:{name}"] = flags.get(f"{kind}:{name}", 0) + 1
        tiles["records"] += 1
        tiles["mismatch"] += int(sum(int(v) for v in rec.tile_occupancy) != rec.n_occupied)
        return rec

    st._unpack_outputs = tap
    for _ in range(warmup):
        st.step()
    st.drain()
    _sync(dev)
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(stepper_steps):
        st.step()
    st.drain()
    _sync(dev)
    seconds = time.perf_counter() - t0
    counts = _counts()
    st.flush()
    out["stepper"] = {"steps": stepper_steps * st.megastep, "seconds": seconds, **counts,
                      "flags": flags, "tile_records": tiles, "finite_nonneg": _finite(world),
                      "n_cells": world.n_cells}
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def backend_probe(mesh):
    """One all-reduce and one all-gather straight through the process
    group's backend (a one-rank mesh skips its own collectives)."""
    import torch.distributed as dist

    x = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    dist.all_reduce(x, group=mesh.group)
    outs = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(outs, x, group=mesh.group)
    _sync(mesh.device)
    return {"backend": mesh.backend, "sum": x.tolist(), "gathered": len(outs)}


def det_paths(mesh, *, device=None, steps: int, stepper_dispatches: dict, stepper_kw: dict,
              **world_kw):
    """The deterministic mesh checks of the smoke run at one size: the
    classic lifecycle and the stepper at each megastep of
    ``stepper_dispatches`` (K -> dispatches); returns the final state
    digests and the kernel launches of each."""
    out = {}
    _zero_counts()
    res = classic_lifecycle(mesh, steps=steps, digest_every=steps, device=device, det=True,
                            **world_kw)
    out["classic"] = {"digest": res["digests"][-1], "n_cells": res["n_cells"], **_counts()}
    for k, n in stepper_dispatches.items():
        _zero_counts()
        res = stepper_run(mesh, steps=n, megastep=int(k), device=device, det=True,
                          stepper_kw=stepper_kw, **world_kw)
        out[f"K{k}"] = {"digest": res["digest"], "n_cells": res["n_cells"], **_counts()}
    return out
