"""
What the drivers share: the inputs drawn from the seed, the program's
worlds built from a configuration, and the snapshots and step that the
correctness check reads after the window.
"""
import json
import random
from pathlib import Path

import numpy as np

from benchmark.reference import judge

ROOT = Path(__file__).resolve().parent


def chemistry_data(name: str) -> dict:
    return json.loads((ROOT / "chemistries" / f"{name}.json").read_text())


def program_chemistry(data: dict):
    """The chemistry as the program takes it, built from the data file
    that the reference reads too."""
    from magicsoup_tpu_torch import Chemistry, Molecule

    mols = {
        m["name"]: Molecule(m["name"], m["energy"], half_life=m["half_life"],
                            diffusivity=m["diffusivity"], permeability=m["permeability"])
        for m in data["molecules"]
    }
    reactions = [([mols[n] for n in subs], [mols[n] for n in prods])
                 for subs, prods in data["reactions"]]
    return Chemistry(molecules=list(mols.values()), reactions=reactions)


def genomes(seed: int, n: int, size: int) -> list[str]:
    """``n`` uniform random genomes of ``size`` bp from ``seed``: four
    letters per byte of ``random.Random(seed)``."""
    rng = random.Random(seed)
    table = bytes(ord("TCGA"[b & 3]) for b in range(256))
    return [rng.randbytes(size).translate(table).decode("ascii") for _ in range(n)]


def world_seed(config: dict, seed: int) -> int:
    """The seed of what the cell's world is given: the World's own seed
    (its genetic code, its map and its placements), its genomes
    (:func:`input_genomes`) and the cells the loop passages.  The
    configuration's ``world_seed`` where it fixes one, so that every run
    seed does the same work: a world's trajectory follows every difference
    in what it is given, and runs that drew their genomes and passaging
    from the run seed, or only their order, did up to 1.5x the work of
    others; the run seed then draws the cells and pixels that the
    correctness check judges.  Else ``seed``."""
    return int(config.get("world_seed", seed))


def input_genomes(config: dict, seed: int, k: int, n: int) -> list[str]:
    """The ``k``-th batch of ``n`` genomes given to the world (0: the
    initial population; 1, 2, ...: the top-ups), from :func:`world_seed`."""
    return genomes(world_seed(config, seed) * 1_000_003 + k, n, config["init_genome_size"])


def make_world(config: dict, workload: dict, seed: int, device):
    """A populated world of the configuration."""
    import magicsoup_tpu_torch as mt

    chem = program_chemistry(chemistry_data(config["chemistry"]))
    world = mt.World(chemistry=chem, map_size=config["map_size"],
                     seed=world_seed(config, seed),
                     abs_temp=config["abs_temp"], mol_map_init=config["mol_map_init"],
                     device=device, genome_backend=workload["genome_backend"])
    world.spawn_cells(input_genomes(config, seed, 0, config["n_cells"]))
    return world


def setting(config: dict, seed: int) -> judge.Setting:
    chem = chemistry_data(config["chemistry"])
    names = [m["name"] for m in chem["molecules"]]
    return judge.Setting(
        chem=chem, seed=world_seed(config, seed), abs_temp=config["abs_temp"],
        atp=names.index(config["selection_molecule"]),
        kill_below=config["kill_below"], divide_above=config["divide_above"],
        divide_cost=config["divide_cost"],
    )


def live_genomes(world) -> list[str]:
    """The genomes of the world's live cells."""
    return list(world.cell_genomes[: world.n_cells])


def snapshot(world, rows=None) -> judge.Snapshot:
    """The world's state on the host; with ``rows``, also their genomes
    and the program's kinetic parameters."""
    import torch

    n = world.n_cells
    pos = np.asarray(world.cell_positions, dtype=np.int64)[:n]
    cm = np.asarray(world.cell_molecules, dtype=np.float32)[:n]
    mm = world.molecule_map
    mm = mm.detach().cpu().numpy() if torch.is_tensor(mm) else np.asarray(mm)
    div = np.asarray(world.cell_divisions, dtype=np.int64)[:n]
    gen, params = {}, {}
    if rows is not None:
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=world.device)
        params = {k: v[idx].detach().cpu().numpy()
                  for k, v in world.kinetics.params._asdict().items()}
        all_genomes = world.cell_genomes
        gen = {int(r): all_genomes[int(r)] for r in rows}
    return judge.Snapshot(pos=pos, cm=cm, mm=mm.astype(np.float32), div=div,
                          genomes=gen, params=params)
