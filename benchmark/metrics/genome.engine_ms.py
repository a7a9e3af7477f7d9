"""Host milliseconds per traced step of the genome engine inside the
World: the self time of the program's spans ``ms:neighbors`` (pair
finding), ``ms:lengths`` (the genome-length passes), ``ms:mutate`` and
``ms:recombinate`` (the engine calls and their bookkeeping), leaving out
the translation and the parameter assembly nested in them."""
from benchmark import program_spans

SPANS = ("ms:neighbors", "ms:lengths", "ms:mutate", "ms:recombinate")


def read(run):
    return program_spans.self_ms_per_step(run, SPANS)
