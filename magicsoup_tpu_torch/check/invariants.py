"""
The on-device invariant lane contract: the bit layout of the invariant
flag word and the mass-drift tolerance.  Counterpart of
:mod:`magicsoup_tpu.check.invariants`.

The fused step (``stepper._step_body``) computes one i32 flag word per
step, unconditionally and before compaction, and packs it into the step
record next to the health word (header word 9):

- bit 0 ``occ_alive_mismatch`` — occupied-pixel count != live-row count;
- bit 1 ``pos_unoccupied`` — a live row's pixel is not marked occupied;
- bit 2 ``dup_position`` — two live rows share a pixel;
- bit 3 ``dead_cm_residue`` — a row at or beyond the high-water mark holds
  a nonzero intracellular concentration;
- bit 4 ``dead_param_residue`` — same, for any kinetic parameter tensor;
- bit 5 ``mass_drift`` — diffusion + permeation (both closed-system)
  changed the total molecule mass by more than ``MASS_DRIFT_RTOL``
  relative to the post-degradation total.

Header word 10 is the measured absolute mass drift, an f32 bitcast into
the i32 record.
"""

FLAG_OCC_ALIVE_MISMATCH = 1 << 0
FLAG_POS_UNOCCUPIED = 1 << 1
FLAG_DUP_POSITION = 1 << 2
FLAG_DEAD_CM_RESIDUE = 1 << 3
FLAG_DEAD_PARAM_RESIDUE = 1 << 4
FLAG_MASS_DRIFT = 1 << 5

# bit -> stable report key, in bit order
INVARIANT_NAMES = (
    "occ_alive_mismatch",
    "pos_unoccupied",
    "dup_position",
    "dead_cm_residue",
    "dead_param_residue",
    "mass_drift",
)

# relative tolerance of the closed-system mass lane: deterministic f32
# tree sums agree to ~1e-7 relative, a lost cell's molecules are orders
# of magnitude more
MASS_DRIFT_RTOL = 1e-4


def decode_invariants(flags: int) -> dict:
    """Invariant flag word -> ``{name: bool}`` in bit order."""
    flags = int(flags)
    return {name: bool(flags & (1 << bit)) for bit, name in enumerate(INVARIANT_NAMES)}
