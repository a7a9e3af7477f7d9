"""Share of the parameter rows that the World's compactions on kill wrote
in the traced window: the program's ``compaction.rows`` (the rows each
compaction wrote, summed over the parameter tensors) over its
``compaction.capacity_rows`` (the rows of their whole capacity, which a
compaction by a permutation of the capacity writes), in percent.  A
program without these counters, or a window without a kill, reads
nothing."""
from benchmark import program_spans


def read(run):
    counts = program_spans.counters()
    if counts is None or run.trace is None:
        return None
    capacity = counts.get("compaction.capacity_rows", 0)
    rows = counts.get("compaction.rows")
    return 100.0 * rows / capacity if capacity and rows is not None else None
