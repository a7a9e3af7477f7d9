"""Device milliseconds per traced step of the kernels launched inside
the program's ``ms:physics`` spans (degradation, diffusion, permeation)."""
from benchmark import program_spans


def read(run):
    return program_spans.device_ms_per_step(run, "ms:physics")
