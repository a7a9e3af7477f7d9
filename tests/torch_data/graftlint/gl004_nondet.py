"""GL004 fixture: wall-clock nondeterminism in library code."""
import time


def stamp():
    return time.time()  # GL004: wall clock breaks seeded repro
