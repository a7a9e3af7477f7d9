"""Share of the phenotype cache's lookups in the traced window that hit:
the program's ``phenotype.hits`` over hits and ``phenotype.misses``."""
from benchmark import program_spans


def read(run):
    counts = program_spans.counters()
    if counts is None or run.trace is None:
        return None
    hits, misses = counts.get("phenotype.hits", 0), counts.get("phenotype.misses", 0)
    return 100.0 * hits / (hits + misses) if hits + misses else None
