"""
Admission control: compile budgets over capacity rungs.  Counterpart of
:mod:`magicsoup_tpu.serve.admission`.

The scheduler's padded-slot admission (``grow="pad"``) makes joining a
WARM capacity rung pure data movement: the rung's program shapes never
change.  What still costs is a COLD rung, the first world of a new shape:
in eager PyTorch that is a new working set for the caching allocator and,
in a fresh process, the native libraries' builds (what
:func:`magicsoup_tpu_torch.analysis.runtime.compile_count` counts).  On a
shared service that cost lands on every tenant, so it is budgeted.

:class:`AdmissionController` holds one number, the remaining compile
allowance, and answers one question per create: *is this spec's rung
warm?*  Warm rungs always admit.  Cold rungs admit only while budget
remains; otherwise the create is rejected (HTTP 429) or parked on the
service's bounded queue (``"queue": true`` in the spec) and re-assessed
every scheduler tick.

The spend side is measured: the service brackets world construction,
admission and every ``scheduler.step()`` with ``compile_count`` deltas
and charges what it observed.  ``compile_budget=0`` therefore means
"serve only shapes that are already warm".
"""
from __future__ import annotations

__all__ = ["AdmissionController"]


class AdmissionController:
    """Compile-budget gate for tenant creation.

    Parameters:
        compile_budget: Remaining compile allowance for COLD-rung
            admissions; ``None`` is unlimited.  Reconfigurable at
            runtime (``POST /admission``).
    """

    def __init__(self, *, compile_budget: int | None = None):
        self.remaining = None if compile_budget is None else int(compile_budget)
        self.spent = 0  # total compiles observed since start
        self.rejected = 0

    def configure(self, compile_budget: int | None) -> None:
        """Replace the remaining allowance (``None`` = unlimited)."""
        self.remaining = None if compile_budget is None else int(compile_budget)

    def assess(self, *, warm: bool) -> bool:
        """Whether a create may proceed: warm rungs always admit, cold
        rungs need budget headroom."""
        if warm:
            return True
        return self.remaining is None or self.remaining > 0

    def charge(self, compiles: int) -> None:
        """Record ``compiles`` observed compiles (a measured
        ``compile_count`` delta) against the budget."""
        compiles = int(compiles)
        if compiles <= 0:
            return
        self.spent += compiles
        if self.remaining is not None:
            self.remaining = max(0, self.remaining - compiles)

    def snapshot(self) -> dict:
        """JSON view for ``/counters`` and ``/admission`` responses."""
        return {
            "compile_budget": self.remaining,
            "compiles_spent": self.spent,
            "rejected": self.rejected,
        }
