"""
Health sentinels, host side: decode the packed flag word and quarantine
bad cells.  Counterpart of :mod:`magicsoup_tpu.guard.sentinel`.

The fused step folds a 4-bit health word into the step record it already
fetches (record word 8), so detection costs no extra transfer.  Policies
(``PipelinedStepper(sentinel_policy=...)``): ``"warn"`` counts the trip,
``"quarantine"`` also kills the poisoned cells and sanitizes the map at
the next flush boundary, ``"rollback"`` raises
:class:`~magicsoup_tpu_torch.guard.errors.SentinelTripped`.

Bit layout of the flag word::

    bit 0  molecule map has a non-finite value
    bit 1  molecule map has a value below -NEG_EPS
    bit 2  a live cell's molecules have a non-finite value
    bit 3  a live cell's molecules have a value below -NEG_EPS
"""
import numpy as np

from magicsoup_tpu_torch.util import fetch_host

SENTINEL_POLICIES = ("warn", "quarantine", "rollback")

# tolerance below zero before a concentration counts as negative: the
# integrator clips at 0, but arithmetic on clipped values can dip an
# epsilon below
NEG_EPS = 1e-4

FLAG_MM_NONFINITE = 1 << 0
FLAG_MM_NEGATIVE = 1 << 1
FLAG_CM_NONFINITE = 1 << 2
FLAG_CM_NEGATIVE = 1 << 3


def decode_health(flags: int) -> dict:
    """Expand the packed flag word into named booleans."""
    flags = int(flags)
    return {
        "mm_nonfinite": bool(flags & FLAG_MM_NONFINITE),
        "mm_negative": bool(flags & FLAG_MM_NEGATIVE),
        "cm_nonfinite": bool(flags & FLAG_CM_NONFINITE),
        "cm_negative": bool(flags & FLAG_CM_NEGATIVE),
    }


def quarantine_world(world) -> int:
    """Kill cells carrying non-finite or negative concentrations and
    sanitize the molecule map; returns how many cells were killed.  The
    caller must have drained in-flight device work first."""
    n_killed = 0
    if world.n_cells > 0:
        cm = np.asarray(world.cell_molecules)
        bad = ~np.isfinite(cm) | (cm < -NEG_EPS)
        rows = np.nonzero(bad.any(axis=1))[0]
        if len(rows) > 0:
            world.kill_cells([int(r) for r in rows])
            n_killed = len(rows)
    mm = fetch_host(world.molecule_map)
    if not np.isfinite(mm).all() or (mm < -NEG_EPS).any():
        world.molecule_map = np.clip(
            np.nan_to_num(mm, nan=0.0, posinf=0.0, neginf=0.0), 0.0, None
        )
    return n_killed
