"""The 95th percentile, over every step of the measured window, of the
milliseconds between consecutive returns of the entry: the stalls a
user watching a run feels (pushes, divide, the evolution thread)."""
from benchmark.run import p95


def read(run):
    return p95(run.step_gaps) * 1e3 if run.step_gaps else None
