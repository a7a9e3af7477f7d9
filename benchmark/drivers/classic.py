"""
The serial loop that upstream users write (upstream magic-soup 1.0.5
``performance/run_simulation.py``): top the population up to its size,
activity, kill below and divide above a threshold of the selection
molecule (at a cost), recombinate, mutate, degrade and diffuse.  A frozen
copy of it, calling ``World``'s methods; it bypasses the stepper.  With
the workload's ``hold_population``, cells beyond the size are removed at
random where the loop tops up, as a user passages a culture, so that
every step starts from the same number of cells.  Genomes, top-ups and
passaging are drawn from the configuration's ``world_seed``
(:func:`benchmark.worlds.world_seed`).  Its
integrator runs inside this driver's own ``bench:activity`` range, and
the genome engine's time (recombinate plus mutate) is its own span.
"""
import time

import numpy as np
import torch

from benchmark import worlds

ACTIVITY = "bench:activity"


class Driver:
    activity_range = ACTIVITY

    def __init__(self, config: dict, workload: dict, seed: int, device):
        from magicsoup_tpu_torch.cache import ensure_compile_cache

        ensure_compile_cache(device)
        self.config = config
        self.device = torch.device(device)
        self.world = worlds.make_world(config, workload, seed, device)
        self.atp = self.world.chemistry.molname_2_idx[config["selection_molecule"]]
        self.seed = seed
        self.hold = bool(workload.get("hold_population", False))
        self.rng = np.random.default_rng(worlds.world_seed(config, seed))
        self.topups = 0
        self.removed = 0
        self.genome_s = 0.0
        self.steps = 0
        for _ in range(workload["warmup_steps"]):
            self.step()
        self.world.wait_warm()
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _top_up(self) -> None:
        w, cfg = self.world, self.config
        missing = cfg["n_cells"] - w.n_cells
        if missing > 0:
            self.topups += 1
            w.spawn_cells(worlds.input_genomes(cfg, self.seed, self.topups, missing))
        elif missing < 0 and self.hold:
            gone = self.rng.choice(w.n_cells, size=-missing, replace=False)
            w.kill_cells(cell_idxs=np.sort(gone).tolist())
            self.removed -= missing

    def _rest(self) -> tuple[list[int], list[tuple[int, int]]]:
        """The step after the top-up; returns the killed cells and the
        (parent, child) pairs of the divisions."""
        w, cfg = self.world, self.config
        with torch.profiler.record_function(ACTIVITY):
            w.enzymatic_activity(prefetch_column=self.atp)
        atp = w.cell_molecule_column(self.atp)
        kill = atp < cfg["kill_below"]
        killed = np.nonzero(kill)[0].tolist()
        w.kill_cells(cell_idxs=killed)
        repl = np.nonzero(atp[~kill] > cfg["divide_above"])[0].tolist()
        pairs = []
        if repl:
            w.add_cell_molecules(repl, self.atp, -cfg["divide_cost"])
            pairs = w.divide_cells(cell_idxs=repl)
        t0 = time.perf_counter()
        w.recombinate_cells(p=cfg["p_recombination"])
        w.mutate_cells(p=cfg["p_mutation"])
        self.genome_s += time.perf_counter() - t0
        w.degrade_and_diffuse_molecules()
        w.increment_cell_lifetimes()
        self.steps += 1
        return killed, pairs

    def step(self) -> int:
        self._top_up()
        self._rest()
        return 1

    def finish(self) -> None:
        self._sync()

    def stats(self) -> dict:
        return {"classic.steps": self.steps, "classic.genome_ms": self.genome_s * 1e3,
                "classic.topups": self.topups, "classic.removed": self.removed}

    def live_genomes(self) -> list[tuple[int, list[str]]]:
        return [(self.world.seed, worlds.live_genomes(self.world))]

    def check_states(self, check_seed: int):
        w = self.world
        self._top_up()
        pos = np.asarray(w.cell_positions, dtype=np.int64)[: w.n_cells]
        from benchmark.reference import judge

        plan = judge.plan(pos, w.map_size, check_seed)
        s0 = worlds.snapshot(w, plan.rows)
        killed, pairs = self._rest()
        counts = {"kills": len(killed), "placed": len(pairs), "drops": 0}
        return [(s0, worlds.snapshot(w), counts, plan)]

    def close(self) -> None:
        del self.world
