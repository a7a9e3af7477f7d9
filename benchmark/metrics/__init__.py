"""
Per-layer metrics: one reader per metric, found by the metric's name in
``BENCHMARK.json`` (``<name>.py`` here).  Each defines ``read(run)``,
which returns the metric's value from a traced run's data (``Run`` in
:mod:`benchmark.run`), or ``None`` when the run holds nothing to read.
"""
