"""
Global constants and index-level type aliases.

Parity reference: `python/magicsoup/constants.py:1-10` in the reference repo
(mRcSchwering/magic-soup).  Values are physical/genetic constants shared by
every layer of the framework.
"""
from itertools import product

CODON_SIZE = 3  # number of nucleotides per codon
GAS_CONSTANT = 8.31446261815324  # J/(K*mol)

ALL_NTS = tuple("TCGA")  # "N" represents any one of these
ALL_CODONS = set("".join(d) for d in product(ALL_NTS, ALL_NTS, ALL_NTS))

# Index-level domain description emitted by genome translation:
# ((dom_type, idx0, idx1, idx2, idx3), dom_start, dom_end)
# dom_type: 1=catalytic, 2=transporter, 3=regulatory
# idx0..idx2: 1-codon scalar tokens, idx3: 2-codon vector token
DomainSpecType = tuple[tuple[int, int, int, int, int], int, int]

# (domains, cds_start, cds_end, is_fwd)
ProteinSpecType = tuple[list[DomainSpecType], int, int, bool]

# Numerical guard rails used by the kinetics integrator
# (reference: kinetics.py:11-13); MAX/EPS at least 100x away from f32 inf.
EPS = 1e-36
MAX = 1e36
MIN = -1e36
