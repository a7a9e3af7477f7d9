"""Host milliseconds per step of the genome engine in the serial loop:
the benchmark's own span around ``recombinate_cells`` and
``mutate_cells``, over the measured window."""


def read(run):
    steps = run.stats.get("classic.steps", 0)
    return run.stats["classic.genome_ms"] / steps if steps else None
