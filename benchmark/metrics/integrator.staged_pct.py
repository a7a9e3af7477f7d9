"""Share of the integrator kernel's parameter bytes in the traced window
that its launch plans staged in shared memory: the program's
``integrator.staged_bytes`` over its ``integrator.param_bytes`` (both in
the kernel's layout at each launch's proteins and signals), in percent.
The rest the kernel read from device memory.  A program without these
counters, or a window without a launch, reads nothing."""
from benchmark import program_spans


def read(run):
    counts = program_spans.counters()
    if counts is None or run.trace is None:
        return None
    total = counts.get("integrator.param_bytes", 0)
    return 100.0 * counts.get("integrator.staged_bytes", 0) / total if total else None
