"""
magicsoup_tpu_torch — the PyTorch/CUDA port of :mod:`magicsoup_tpu`.

Cells live on a 2D torus map; their string genomes deterministically
encode proteomes whose catalytic/transporter/regulatory domains drive a
reversible Michaelis-Menten integrator over molecule concentrations.
State lives in PyTorch tensors on one device (``"cuda"`` by default); the
integrator runs as a hand-written CUDA kernel there
(:mod:`magicsoup_tpu_torch.ops.cuda_integrate`), the rest as plain PyTorch.
:class:`PipelinedStepper` runs the selection workload on the device with
the host replaying a few steps behind; :class:`FleetScheduler` steps many
worlds as groups, one batched dispatch per group.
:mod:`magicsoup_tpu_torch.parallel` places a world over a mesh of ranks
(``World(mesh=...)``, one process per tile over ``torch.distributed``).
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
from magicsoup_tpu_torch.factories import (
    CatalyticDomainFact,
    GenomeFact,
    RegulatoryDomainFact,
    TransporterDomainFact,
)
from magicsoup_tpu_torch.genetics import Genetics
from magicsoup_tpu_torch.kinetics import Kinetics
from magicsoup_tpu_torch.mutations import point_mutations, recombinations
from magicsoup_tpu_torch.util import codons, random_genome, randstr, variants
from magicsoup_tpu_torch.world import World
from magicsoup_tpu_torch.stepper import PipelinedStepper
from magicsoup_tpu_torch.fleet import FleetScheduler

__version__ = "0.1.0"

__all__ = [
    "CatalyticDomain",
    "CatalyticDomainFact",
    "Cell",
    "Chemistry",
    "DomainType",
    "FleetScheduler",
    "Genetics",
    "GenomeFact",
    "Kinetics",
    "Molecule",
    "PipelinedStepper",
    "Protein",
    "RegulatoryDomain",
    "RegulatoryDomainFact",
    "TransporterDomain",
    "TransporterDomainFact",
    "World",
    "codons",
    "point_mutations",
    "random_genome",
    "randstr",
    "recombinations",
    "variants",
]
