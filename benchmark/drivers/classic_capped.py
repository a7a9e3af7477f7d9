"""
The serial loop of :mod:`benchmark.drivers.classic` with the genome-size
kill that upstream's tutorial gives alongside the chemical one (magic-soup
``docs/tutorials.md``, "Genome size"): each step a cell of genome length
``L`` dies with probability ``L^h / (L^h + size_kill_bp^h)``, with
``size_kill_bp`` and ``h`` (``size_kill_hill``) from the configuration.
Without it, tail exchange doubles genomes until the integrator's protein
axis outgrows the card.

The kill is drawn where the loop tops up, before it, from the loop's
``world_seed`` generator; the top-up then refills the population or
passages it.  So the step that the correctness check judges (after the
top-up) is the classic step, killing below ``kill_below`` as the
reference does.
"""
import numpy as np

from benchmark.drivers import classic


class Driver(classic.Driver):
    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.size_killed = 0
        super().__init__(config, workload, seed, device)

    def size_kill(self) -> list[int]:
        """The cells that the size kill takes this step (drawn from the
        loop's generator)."""
        w, cfg = self.world, self.config
        n = w.n_cells
        if n == 0:
            return []
        lengths = np.fromiter((len(g) for g in w.cell_genomes[:n]), dtype=np.float64, count=n)
        h = cfg["size_kill_hill"]
        x = (lengths / cfg["size_kill_bp"]) ** h
        return np.nonzero(self.rng.random(n) < x / (x + 1.0))[0].tolist()

    def _top_up(self) -> None:
        killed = self.size_kill()
        if killed:
            self.world.kill_cells(cell_idxs=killed)
            self.size_killed += len(killed)
        super()._top_up()

    def stats(self) -> dict:
        return {**super().stats(), "classic.size_killed": self.size_killed}
