"""
Wood-Ljungdahl CO2-fixation pathway chemistry (the benchmark chemistry of
the reference, `python/magicsoup/examples/wood_ljungdahl.py`; energies and
species per https://www.ncbi.nlm.nih.gov/pmc/articles/PMC2646786/).

Methyl (Eastern) branch:
    CO2 + NADPH -> formiat + NADP
    formiat + FH4 + ATP -> formyl-FH4 + ADP
    formyl-FH4 + NADPH -> methylen-FH4 + NADP
    methylen-FH4 + NADPH -> methyl-FH4 + NADP
Carbonyl (Western) branch:
    methyl-FH4 + Ni-ACS -> FH4 + methyl-Ni-ACS
    methyl-Ni-ACS + CO2 + HS-CoA -> Ni-ACS + acetyl-CoA
"""
from magicsoup_tpu_torch.containers import Chemistry, Molecule

NADPH = Molecule("NADPH", 200.0 * 1e3)
NADP = Molecule("NADP", 100.0 * 1e3)
ATP = Molecule("ATP", 100.0 * 1e3)
ADP = Molecule("ADP", 70.0 * 1e3)

methylFH4 = Molecule("methyl-FH4", 360.0 * 1e3)
methylenFH4 = Molecule("methylen-FH4", 300.0 * 1e3)
formylFH4 = Molecule("formyl-FH4", 240.0 * 1e3)
FH4 = Molecule("FH4", 200.0 * 1e3)
formiat = Molecule("formiat", 20.0 * 1e3)
co2 = Molecule("CO2", 10.0 * 1e3, diffusivity=1.0, permeability=1.0)

NiACS = Molecule("Ni-ACS", 200.0 * 1e3)
methylNiACS = Molecule("methyl-Ni-ACS", 300.0 * 1e3)
HSCoA = Molecule("HS-CoA", 200.0 * 1e3)
acetylCoA = Molecule("acetyl-CoA", 260.0 * 1e3)

MOLECULES = [
    NADPH,
    NADP,
    ATP,
    ADP,
    methylFH4,
    methylenFH4,
    formylFH4,
    FH4,
    formiat,
    co2,
    NiACS,
    methylNiACS,
    HSCoA,
    acetylCoA,
]

REACTIONS = [
    ([co2, NADPH], [formiat, NADP]),  # -90k
    ([formiat, FH4, ATP], [formylFH4, ADP]),  # -10k
    ([formylFH4, NADPH], [methylenFH4, NADP]),  # -40k
    ([methylenFH4, NADPH], [methylFH4, NADP]),  # -40k
    ([methylFH4, NiACS], [FH4, methylNiACS]),  # -60k
    ([methylNiACS, co2, HSCoA], [NiACS, acetylCoA]),  # -50k
]

CHEMISTRY = Chemistry(molecules=MOLECULES, reactions=REACTIONS)
