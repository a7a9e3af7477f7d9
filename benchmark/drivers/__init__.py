"""
Drivers: one module per way of stepping the program, found by the name a
workload file gives under ``driver``.  Each defines ``Driver(config,
workload, seed, device)``, which builds and warms the cell's program, and
on it ``step()`` (one call of the entry a user's loop makes; returns the
simulated steps per world it adds), ``finish()`` (the end of the window:
every dispatched step done), ``stats()`` (the program's and the
benchmark's own counters), ``live_genomes()`` (each world's seed and
the genomes of its live cells), ``check_states(check_seed)`` (after the window:
S0, S1 and the counts of one more step per world) and ``close()``.
"""
