"""
The canonical benchmark workload step: spawn top-up to the target
population, enzymatic_activity, kill below 1.0 ATP, divide above 5.0 ATP
(at a cost of 4.0 ATP), recombinate, mutate, degrade+diffuse+lifetimes.

A copy of ``performance/workload.py::sim_step`` for the port's
:class:`~magicsoup_tpu_torch.world.World` (the original imports the JAX
package); the steps, their order and their random draws are the same.
"""
from contextlib import nullcontext

import numpy as np

from magicsoup_tpu_torch.util import random_genome

KILL_BELOW_ATP = 1.0
DIVIDE_ABOVE_ATP = 5.0
DIVIDE_COST_ATP = 4.0


def _no_timer(label: str):
    return nullcontext()


def sim_step(
    world,
    rng,
    *,
    n_cells: int,
    genome_size: int,
    atp_idx: int,
    timeit=_no_timer,
    sync: bool = True,
) -> None:
    """Advance the world by one canonical workload step.

    ``timeit`` is an optional ``label -> context manager`` factory used to
    time each phase; the default does nothing.  With ``sync=False`` the
    final device barrier is skipped (the next step's selection fetch
    synchronizes anyway).
    """
    if world.n_cells < n_cells:
        with timeit("addCells"):
            genomes = [
                random_genome(s=genome_size, rng=rng)
                for _ in range(n_cells - world.n_cells)
            ]
            world.spawn_cells(genomes=genomes)

    with timeit("activity"):
        # the ATP column's device->host copy starts right after the step
        world.enzymatic_activity(prefetch_column=atp_idx)

    # ONE fetch of the ATP column drives both selections: killing only
    # compacts rows, so the post-kill ATP levels follow from the snapshot
    with timeit("kill"):
        atp = world.cell_molecule_column(atp_idx)
        kill_mask = atp < KILL_BELOW_ATP
        world.kill_cells(cell_idxs=np.nonzero(kill_mask)[0].tolist())

    with timeit("replicate"):
        atp_after = atp[~kill_mask]  # kill compaction is stable
        repl = np.nonzero(atp_after > DIVIDE_ABOVE_ATP)[0]
        if len(repl):
            world.add_cell_molecules(repl.tolist(), atp_idx, -DIVIDE_COST_ATP)
            world.divide_cells(cell_idxs=repl.tolist())

    with timeit("recombinateGenomes"):
        world.recombinate_cells()

    with timeit("mutateGenomes"):
        world.mutate_cells()

    with timeit("wrapUp"):
        world.degrade_and_diffuse_molecules()
        world.increment_cell_lifetimes()
        if sync:
            # a value fetch is a device barrier
            float(world._molecule_map[0, 0, 0])
            float(world._cell_molecules[0, 0])
