"""Host milliseconds per traced step of translation: the self time of
the program's ``ms:translate`` spans (hashing, the phenotype cache's
lookup, decoding and translating the misses)."""
from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_step(run, ("ms:translate",))
