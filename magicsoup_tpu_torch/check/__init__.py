"""
Semantic correctness checking for simulation state.  Counterpart of
:mod:`magicsoup_tpu.check`, in three tiers ordered by cost:

- device invariant lanes (:mod:`~magicsoup_tpu_torch.check.invariants`):
  per-step flags computed inside the stepper's step and packed into its
  record;
- the host deep audit (:func:`~magicsoup_tpu_torch.check.audit.audit_world`):
  the device state fetched once, the full semantic suite plus a sampled
  genome -> proteome re-translation against the assembled kinetic
  parameters, returning typed
  :class:`~magicsoup_tpu_torch.check.audit.InvariantViolation` reports;
- the differential harness (:mod:`~magicsoup_tpu_torch.check.differential`):
  one seeded schedule driven through the classic World, the pipelined
  stepper, the fleet and the token genome backend, comparing det-mode
  digests per boundary.
"""
from magicsoup_tpu_torch.check.audit import (
    AuditFailed,
    InvariantViolation,
    assert_consistent,
    audit_world,
)
from magicsoup_tpu_torch.check.invariants import (
    INVARIANT_NAMES,
    MASS_DRIFT_RTOL,
    decode_invariants,
)

__all__ = [
    "INVARIANT_NAMES",
    "MASS_DRIFT_RTOL",
    "AuditFailed",
    "InvariantViolation",
    "assert_consistent",
    "audit_world",
    "decode_invariants",
]
