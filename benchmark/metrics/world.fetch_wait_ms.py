"""Host milliseconds per traced step in the program's ``ms:fetch`` spans:
the host waiting for the selection molecule's column to arrive from the
card (the prefetched copy, or a blocking one)."""
from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_step(run, ("ms:fetch",))
