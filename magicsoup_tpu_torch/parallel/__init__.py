"""
Scaling past one device: a 1D mesh of ranks over ``torch.distributed``,
the tile-sharded world step (the molecule map split by rows, cells by
slots, a halo exchange for diffusion) and the multi-process entry points.
Counterpart of :mod:`magicsoup_tpu.parallel`.

See :mod:`magicsoup_tpu_torch.parallel.tiled` (the mesh and the sharded
ops), :mod:`~.multihost` (joining the process group, the global mesh) and
:mod:`~.launch` (a pool of rank processes driven from one parent, for
tests and the smoke run).
"""
