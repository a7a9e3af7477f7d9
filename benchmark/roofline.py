"""
The integrator's least work and the card's published peak.

One integrator step reads every live cell's signals and the kinetic
parameters of its proteins once, and writes the signals once.  Per cell:
``2 s`` float32 signals in and out (``8 s`` bytes).  Per protein: Ke,
Kmf, Kmb and Vmax (float32, 16 bytes), Kmr over the signals (float32,
``4 s``) and N, Nf, Nb and A over the signals (int16, ``8 s``).  Only the
cells that live and the proteins they hold count: rows and protein slots
that the program pads to a capacity are its choice, not the work.  Bytes
bound the step: its operations per byte are far below the card's ratio
of compute to bandwidth (``chip_smoke.py``'s count of them takes under half
of the byte time).  The proteins are counted by the reference's
translation of the live genomes, not read from the program.
"""

import random

from benchmark.reference.genetics import CodonMaps

#: NVIDIA H100 SXM 80 GB, published HBM3 bandwidth (data sheet), at the
#: 700 W power limit; runs record the card's own limit beside the share
HBM_BYTES_PER_S = 3.35e12


def integrator_bytes(cells: int, proteins: int, signals: int) -> int:
    """Bytes one integrator step over ``cells`` live cells holding
    ``proteins`` proteins in all must move, at ``signals`` signals."""
    return cells * 8 * signals + proteins * (16 + 12 * signals)


def share_pct(n_bytes: float, device_s: float) -> float:
    """The byte bound's time as a share of ``device_s``, in percent."""
    return 100.0 * n_bytes / HBM_BYTES_PER_S / device_s


def live_work(genomes: list[str], world_seed: int) -> tuple[int, int]:
    """Live cells and the proteins their genomes translate to, under the
    codon maps that a world seeded ``world_seed`` draws first (as
    :func:`benchmark.reference.judge.translate` rebuilds them)."""
    maps = CodonMaps(random.Random(world_seed).randrange(2**63))
    return len(genomes), sum(len(maps.translate(g)) for g in genomes)
