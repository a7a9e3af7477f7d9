"""
Native layer of the framework: the host-side genome engine.

See :mod:`magicsoup_tpu_torch.native.engine` (C++/ctypes primary) and
:mod:`magicsoup_tpu_torch.native._pyengine` (pure-Python fallback + shared
lookup-table containers).
"""
from magicsoup_tpu_torch.native.engine import (
    TranslationTables,
    has_native,
    pack_dense,
    point_mutations,
    recombinations,
    translate_genomes_flat,
)

__all__ = [
    "TranslationTables",
    "has_native",
    "pack_dense",
    "point_mutations",
    "recombinations",
    "translate_genomes_flat",
]
