"""
The differential correctness harness.  Counterpart of
:mod:`magicsoup_tpu.check.differential`.

One seeded spawn/step/mutate/kill/divide schedule is driven through
several execution paths: the classic :class:`World`, the
:class:`PipelinedStepper` at ``K=1`` and ``K=4``, a B=1 fleet at K=1 and
K=4, and each again with device token genomes.  In deterministic mode
they are bit-equal: the full semantic state is digested at each schedule
boundary, and a digest mismatch names the boundary where two
trajectories forked.

The schedule's structural ops (spawn, mutate, kill, divide; kill also
compacts rows) run through the classic World API on every path, with the
world's RNG streams re-seeded from the schedule seed before each op: the
axis under test is the chemistry's execution path, not the host-side
ops.  The stepper and fleet paths build a fresh chem-only runner per phase
(selection off, mutation rates 0) and flush it, and they draw from the
world's streams only when they are built, so the re-seeding reaches
them.

The token axis (``TOKEN_PATHS``) re-runs the paths with the world's
genomes held as a device token tensor: ``state_digest`` reads
``world.cell_genomes``, which then decodes the store, so one byte of
storage divergence forks the digest.  ``token_fleet3`` steps the
schedule world from slot 0 of a B=3 group with two companion token
worlds.

``cuda_k1`` builds the world with ``integrator="cuda"`` (the hand-written
kernel on a card, its plain version on the CPU) and drives the K=1
stepper in fast mode: selection is off and mutation rates are 0 in the
chem phases, so the structural trajectory must not depend on the
integrator's floats, and :func:`structural_digest` holds it to the
committed golden file of the JAX package's ``pallas_k1`` path.

The fused axis (``FUSED_PATHS``) steps the schedule world inside a
mixed-rung fleet whose groups share one dispatch per megastep: its
companions sit on a double-size map (another capacity rung), ``block=2``.
``fused2`` runs K=1 under ``fusion="fleet"`` with one companion,
``fused_fleet`` K=4 under ``fusion="auto"`` with two.  Their digests
equal the solo paths' at every boundary.

``mesh2`` and ``token_mesh2`` need device meshes (ROADMAP A9); they raise
``ValueError`` until those are ported.

Entry points run on ``"cuda"`` unless ``device="cpu"`` is passed.
"""
import hashlib
import random

import numpy as np

#: the gated solo execution paths, in report order
PATHS = ("classic", "k1", "k4")

#: a B=1 fleet driven through the FleetScheduler at K=1 / K=4
FLEET_PATHS = ("fleet1", "fleet4")

#: every path again with device token genomes; ``token_fleet3`` is a B=3
#: fleet group with two companion token worlds
TOKEN_PATHS = ("token_classic", "token_k1", "token_k4", "token_fleet3")

#: cross-rung fused dispatch: the schedule world in a mixed-rung fleet
#: (K=1 ``fusion="fleet"``, K=4 ``fusion="auto"``)
FUSED_PATHS = ("fused2", "fused_fleet")

#: the CUDA kernel's axis, in fast mode: the counterpart of the JAX
#: package's ``pallas_k1``, held to its golden structural digests
CUDA_PATHS = ("cuda_k1",)

#: paths of the JAX harness that wait on other parts of the port
NOT_PORTED = {
    "mesh2": "A9 (device meshes)",
    "token_mesh2": "A9 (device meshes)",
}

#: chem-phase lengths between structural ops; multiples of 4 so the K=4
#: megastep divides every phase evenly
PHASES = (4, 8, 4)

#: schedule boundary names, in digest order (one digest per boundary)
BOUNDARIES = (
    "spawn",
    "chem_a",
    "mutate",
    "chem_b",
    "kill",
    "divide",
    "chem_c",
)


def _chemistry():
    import magicsoup_tpu_torch as mt

    mols = [
        mt.Molecule("dfx-a", 10e3),
        mt.Molecule("dfx-atp", 8e3, half_life=100_000),
    ]
    return mt.Chemistry(molecules=mols, reactions=[([mols[0]], [mols[1]])])


def _reseed(world, seed: int, op_index: int) -> None:
    """Pin both world RNG streams to a schedule-derived state before a
    structural op."""
    world._rng.seed(seed * 10_007 + op_index)
    world._nprng = np.random.default_rng(seed * 20_011 + op_index)


def _digest(parts) -> str:
    h = hashlib.sha256()
    for tag, part in parts:
        h.update(tag.encode())
        h.update(part)
    return h.hexdigest()


def _structural_parts(world) -> list:
    return [
        ("pos", np.asarray(world.cell_positions).tobytes()),
        ("map", np.asarray(world.cell_map).tobytes()),
        ("lt", np.asarray(world.cell_lifetimes).tobytes()),
        ("div", np.asarray(world.cell_divisions).tobytes()),
        ("gen", "\x00".join(world.cell_genomes).encode()),
    ]


def state_digest(world) -> str:
    """sha256 over the full semantic state: map and live cell molecules,
    positions, occupancy, counters and genomes.  The RNG streams (the
    schedule pins them) and dead capacity rows are left out.  Equal to the
    JAX package's digest of the same state."""
    from magicsoup_tpu_torch.util import fetch_host

    n = int(world.n_cells)
    mm = fetch_host(world._molecule_map)
    cm = fetch_host(world._cell_molecules)
    parts = [
        ("n", np.int64(n).tobytes()),
        ("mm", np.ascontiguousarray(mm).tobytes()),
        ("cm", np.ascontiguousarray(cm[:n]).tobytes()),
    ]
    return _digest(parts + _structural_parts(world))


def structural_digest(world) -> str:
    """sha256 over the structural state only: cell count, positions,
    occupancy map, lifetime and division counters, and genomes; no float
    tensor.  The committed golden files under ``tests/fast/data/golden/``
    hold these digests."""
    n = int(world.n_cells)
    return _digest([("n", np.int64(n).tobytes())] + _structural_parts(world))


def _chem_phase(world, n_steps: int, path: str) -> None:
    """Advance ``n_steps`` chemistry steps through the path's runner; a
    stepper or fleet is flushed at the end, so the world is the source of
    truth again at the boundary."""
    import magicsoup_tpu_torch as mt

    base = path[len("token_"):] if path.startswith("token_") else path
    if base == "classic":
        world.step_many(n_steps)
        return
    k = 4 if base in ("k4", "fleet4", "fused_fleet") else 1
    kwargs = dict(
        mol_name="dfx-atp",
        kill_below=-1.0,
        divide_above=1e30,
        divide_cost=0.0,
        target_cells=None,
        genome_size=200,
        lag=1,
        megastep=k,
        p_mutation=0.0,
        p_recombination=0.0,
    )
    assert n_steps % k == 0
    if base in ("fleet1", "fleet4", "fleet3") + FUSED_PATHS:
        from magicsoup_tpu_torch.fleet import FleetScheduler

        if base in FUSED_PATHS:
            fleet = FleetScheduler(block=2, fusion="fleet" if base == "fused2" else "auto")
        else:
            fleet = FleetScheduler(block=4 if base == "fleet3" else 1)
        lane = fleet.admit(world, **kwargs)
        companions = []
        if base in FUSED_PATHS:
            # companions on another capacity rung: a double-size map
            for j in range(1 if base == "fused2" else 2):
                cw = mt.World(
                    chemistry=world.chemistry,
                    map_size=world.map_size * 2,
                    seed=1500 + j,
                    device=world.device,
                )
                cw.deterministic = True
                crng = random.Random(700 + j)
                cw.spawn_cells([mt.random_genome(s=200, rng=crng) for _ in range(4)])
                companions.append(fleet.admit(cw, **kwargs))
        elif base == "fleet3":
            for j in range(2):
                cw = mt.World(
                    chemistry=world.chemistry,
                    map_size=world.map_size,
                    seed=1000 + j,
                    genome_backend="token",
                    device=world.device,
                )
                cw.deterministic = True
                crng = random.Random(500 + j)
                cw.spawn_cells([mt.random_genome(s=200, rng=crng) for _ in range(4)])
                companions.append(fleet.admit(cw, **kwargs))
        for _ in range(n_steps // k):
            fleet.step()
        fleet.flush()
        for c in companions:
            fleet.retire(c)
        fleet.retire(lane)
        return
    st = mt.PipelinedStepper(world, **kwargs)
    for _ in range(n_steps // k):
        st.step()
    st.flush()


def run_path(
    path: str,
    *,
    seed: int = 11,
    map_size: int = 16,
    n_cells: int = 16,
    digest_fn=None,
    device=None,
) -> list[str]:
    """Drive the seeded schedule through one execution path; returns the
    per-boundary digests.  ``digest_fn`` defaults to :func:`state_digest`;
    the golden-file check passes :func:`structural_digest`.  ``device``
    ``None`` means ``"cuda"``."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.util import resolve_device

    if path in NOT_PORTED:
        raise ValueError(
            f"path {path!r} is not ported yet: it comes with ROADMAP {NOT_PORTED[path]}"
        )
    known = PATHS + FLEET_PATHS + TOKEN_PATHS + FUSED_PATHS + CUDA_PATHS
    if path not in known:
        raise ValueError(f"unknown path {path!r} (want one of {known})")
    device = resolve_device(device, "run_path")
    if digest_fn is None:
        digest_fn = state_digest
    world = mt.World(
        chemistry=_chemistry(),
        map_size=map_size,
        seed=seed,
        genome_backend="token" if path.startswith("token_") else "string",
        integrator="cuda" if path in CUDA_PATHS else None,
        device=device,
    )
    if path not in CUDA_PATHS:
        # the cuda backend is fast mode only; its axis is held by the
        # float-free structural digest instead
        world.deterministic = True
    digests: list[str] = []

    # op 0: seeded spawn
    _reseed(world, seed, 0)
    rng = random.Random(seed)
    world.spawn_cells([mt.random_genome(s=200, rng=rng) for _ in range(n_cells)])
    digests.append(digest_fn(world))

    _chem_phase(world, PHASES[0], path)
    digests.append(digest_fn(world))

    # op 1: seeded point mutations (an explicitly seeded stream)
    _reseed(world, seed, 1)
    world.update_cells(mt.point_mutations(list(world.cell_genomes), p=1e-3, seed=seed))
    digests.append(digest_fn(world))

    _chem_phase(world, PHASES[1], path)
    digests.append(digest_fn(world))

    # op 2: seeded kill (compacts the surviving rows)
    _reseed(world, seed, 2)
    pick = random.Random(seed + 1)
    world.kill_cells(sorted(pick.sample(range(world.n_cells), world.n_cells // 4)))
    digests.append(digest_fn(world))

    # op 3: seeded divisions
    _reseed(world, seed, 3)
    world.divide_cells(sorted(pick.sample(range(world.n_cells), world.n_cells // 3)))
    digests.append(digest_fn(world))

    _chem_phase(world, PHASES[2], path)
    digests.append(digest_fn(world))
    return digests


def run_differential(
    paths=PATHS, *, seed: int = 11, map_size: int = 16, n_cells: int = 16, device=None
) -> dict:
    """Run the schedule through every path and compare digests.

    Returns ``{"ok": bool, "digests": {path: [...]}, "mismatches":
    [{"boundary": i, "boundary_name": ..., "path": p, "reference": ...,
    "want": d0, "got": d}, ...]}`` with the first listed path as the
    reference; the caller decides whether to gate.
    """
    digests = {
        p: run_path(p, seed=seed, map_size=map_size, n_cells=n_cells, device=device)
        for p in paths
    }
    ref_path = paths[0]
    ref = digests[ref_path]
    mismatches = []
    for p in paths[1:]:
        for i, (want, got) in enumerate(zip(ref, digests[p])):
            if want != got:
                mismatches.append(
                    {
                        "boundary": i,
                        "boundary_name": BOUNDARIES[i],
                        "path": p,
                        "reference": ref_path,
                        "want": want,
                        "got": got,
                    }
                )
    return {"ok": not mismatches, "digests": digests, "mismatches": mismatches}
