"""Host milliseconds per traced step of parameter assembly: the self
time of the program's ``ms:assemble`` spans (unsetting empty proteomes,
growing the token limits, packing and writing the parameter rows)."""
from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_step(run, ("ms:assemble",))
