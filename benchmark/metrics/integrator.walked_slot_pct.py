"""Share of the protein slots handed to the integrator kernel in the
traced window that its tiles walked: the kernel's device counter
``integrator.walked_slots`` (8 times each tile's widest cell's extent, the
cell's slots up to its last protein) over the program's
``integrator.slots`` (rows times the protein axis p, per launch), in
percent.  A program without these counters, or a window without a
launch, reads nothing."""
from benchmark import program_spans


def read(run):
    counts = program_spans.counters()
    if counts is None or run.trace is None:
        return None
    total = counts.get("integrator.slots", 0)
    walked = counts.get("integrator.walked_slots")
    return 100.0 * walked / total if total and walked is not None else None
