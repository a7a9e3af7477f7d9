"""
magicsoup_tpu_torch — the PyTorch/CUDA port of :mod:`magicsoup_tpu`.

Cells live on a 2D torus map; their string genomes deterministically
encode proteomes whose catalytic/transporter/regulatory domains drive a
reversible Michaelis-Menten integrator over molecule concentrations.
State lives in PyTorch tensors on one device (``"cuda"`` by default); the
integrator runs as a hand-written CUDA kernel there
(:mod:`magicsoup_tpu_torch.ops.cuda_integrate`), the rest as plain PyTorch.
Genome string work runs in a multithreaded C++ engine (with a pure-Python
fallback).  The package imports neither JAX nor :mod:`magicsoup_tpu`.
"""
from magicsoup_tpu_torch.containers import (
    CatalyticDomain,
    Cell,
    Chemistry,
    DomainType,
    Molecule,
    Protein,
    RegulatoryDomain,
    TransporterDomain,
)
from magicsoup_tpu_torch.genetics import Genetics
from magicsoup_tpu_torch.kinetics import Kinetics
from magicsoup_tpu_torch.mutations import point_mutations, recombinations
from magicsoup_tpu_torch.util import codons, random_genome, randstr, variants
from magicsoup_tpu_torch.world import World

__version__ = "0.1.0"

__all__ = [
    "CatalyticDomain",
    "Cell",
    "Chemistry",
    "DomainType",
    "Genetics",
    "Kinetics",
    "Molecule",
    "Protein",
    "RegulatoryDomain",
    "TransporterDomain",
    "World",
    "codons",
    "point_mutations",
    "random_genome",
    "randstr",
    "recombinations",
    "variants",
]
