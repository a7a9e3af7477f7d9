"""Share of the parameter rows assembled in the traced window that the
assembly kernel wrote: the program's ``assembly.kernel_rows`` over its
``assembly.rows``, in percent."""
from benchmark import program_spans


def read(run):
    counts = program_spans.counters()
    if counts is None or run.trace is None:
        return None
    rows = counts.get("assembly.rows", 0)
    return 100.0 * counts.get("assembly.kernel_rows", 0) / rows if rows else None
