"""
Loader and ctypes bindings for the native genome engine.

A copy of the JAX package's engine loader: compiles its own copy of
`src/genome.cpp` with g++ (``-O3 -fopenmp``) on first use, into the
git-ignored build directory of :mod:`magicsoup_tpu_torch._build` (named
after a hash of the source, built to a temp file and renamed into place),
and exposes the flat-array API.  If no compiler is available (or
``MAGICSOUP_TPU_NO_NATIVE=1``), falls back to the pure-Python engine in
:mod:`magicsoup_tpu_torch.native._pyengine` — same signatures, same flat
formats, same results.

String work runs on host threads (OpenMP) with the GIL released for the
duration of each call (ctypes does that automatically).
"""
import ctypes
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

from magicsoup_tpu_torch._build import build_shared
from magicsoup_tpu_torch.native import _pyengine
from magicsoup_tpu_torch.native._pyengine import TranslationTables
from magicsoup_tpu_torch.telemetry import recorder as _telemetry

_SRC = Path(__file__).parent / "src" / "genome.cpp"
_BUILD_LOCK = threading.Lock()
_GXX = [
    "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
    "-fopenmp",
]

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_charp = ctypes.POINTER(ctypes.c_char)


def _build_lib() -> Path | None:
    """Compile the C++ engine if needed; returns the .so path or None"""
    with _BUILD_LOCK:
        try:
            return build_shared("libmsgenome", _SRC, _GXX, timeout=300)
        except (RuntimeError, subprocess.SubprocessError, OSError) as err:
            warnings.warn(
                f"Could not build native genome engine ({err});"
                " falling back to the pure-Python engine."
            )
            return None


def _load_lib():
    if os.environ.get("MAGICSOUP_TPU_NO_NATIVE") == "1":
        return None
    path = _build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        return _declare_abi(lib)
    except (OSError, AttributeError) as err:
        # e.g. a stale library from an older source revision that lacks a
        # newly-added symbol (can happen when another process rebuilt
        # concurrently) — fall back rather than crash
        warnings.warn(
            f"Could not load native genome engine ({err});"
            " falling back to the pure-Python engine."
        )
        return None


def _declare_abi(lib):
    lib.ms_free.argtypes = [ctypes.c_void_p]
    lib.ms_free.restype = None
    lib.ms_translate_genomes.argtypes = [
        _charp, _i64p, ctypes.c_int64,  # data, offsets, n
        _u8p, _u8p, _i32p, _i32p,  # codon_flags, dom_type_lut, 1c lut, 2c lut
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dom_size, type_size, threads
        _i32p,  # prot_counts out
        ctypes.POINTER(_i32p), _i64p,  # prots, n_prots
        ctypes.POINTER(_i32p), _i64p,  # doms, n_doms
    ]
    lib.ms_translate_genomes.restype = None
    lib.ms_pack_dense.argtypes = [
        _i32p, ctypes.c_int64,  # prot_counts, b
        _i32p, ctypes.c_int64,  # prots, n_prots
        _i32p, ctypes.c_int64,  # doms, n_doms
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,  # p_cap, d_cap, threads
        ctypes.POINTER(ctypes.c_int16),  # out_dense (caller-allocated, zeroed)
    ]
    lib.ms_pack_dense.restype = None
    lib.ms_point_mutations.argtypes = [
        _charp, _i64p, ctypes.c_int64,
        _i64p,  # pre-drawn per-seq mutation counts
        _i64p,  # original population indices (RNG stream keys)
        ctypes.c_float, ctypes.c_float,
        ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(_charp), ctypes.POINTER(_i64p),
        ctypes.POINTER(_i64p), _i64p,
    ]
    lib.ms_point_mutations.restype = None
    lib.ms_recombinations.argtypes = [
        _charp, _i64p, ctypes.c_int64,
        _i64p,  # pre-drawn per-pair strand-break counts
        _i64p,  # original population indices (RNG stream keys)
        ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(_charp), ctypes.POINTER(_i64p),
        ctypes.POINTER(_i64p), _i64p,
    ]
    lib.ms_recombinations.restype = None
    lib.ms_neighbor_pairs.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(_i32p), _i64p,
    ]
    lib.ms_neighbor_pairs.restype = None
    return lib


_LIB = None
_LIB_TRIED = False


def get_lib():
    """The loaded native library, or None if unavailable"""
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _load_lib()
        _LIB_TRIED = True
    return _LIB


def has_native() -> bool:
    return get_lib() is not None


def _concat(seqs: list[str]) -> tuple[bytes, np.ndarray]:
    """Concatenate strings into one byte buffer + (n+1,) int64 offsets"""
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return "".join(seqs).encode(), offsets


def translate_genomes_flat(
    genomes: list[str], tables: TranslationTables, n_threads: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """
    Flat-format genome translation (see `_pyengine` docstring for the
    format).  Deterministic: the native and Python engines produce
    identical output.
    """
    lib = get_lib()
    if lib is None:
        return _pyengine.translate_genomes_flat(genomes, tables)

    data, offsets = _concat(genomes)
    n = len(genomes)
    prot_counts = np.zeros(n, dtype=np.int32)
    out_prots = _i32p()
    out_doms = _i32p()
    n_prots = ctypes.c_int64()
    n_doms = ctypes.c_int64()
    one_lut = np.ascontiguousarray(tables.one_codon_lut, dtype=np.int32)
    two_lut = np.ascontiguousarray(tables.two_codon_lut, dtype=np.int32)
    lib.ms_translate_genomes(
        ctypes.cast(data, _charp),
        offsets.ctypes.data_as(_i64p),
        n,
        tables.codon_flags.ctypes.data_as(_u8p),
        tables.dom_type_lut.ctypes.data_as(_u8p),
        one_lut.ctypes.data_as(_i32p),
        two_lut.ctypes.data_as(_i32p),
        tables.dom_size,
        tables.dom_type_size,
        n_threads,
        prot_counts.ctypes.data_as(_i32p),
        ctypes.byref(out_prots),
        ctypes.byref(n_prots),
        ctypes.byref(out_doms),
        ctypes.byref(n_doms),
    )
    try:
        prots = np.ctypeslib.as_array(out_prots, shape=(n_prots.value, 4)).copy()
        doms = np.ctypeslib.as_array(out_doms, shape=(n_doms.value, 7)).copy()
    finally:
        lib.ms_free(out_prots)
        lib.ms_free(out_doms)
    return prot_counts, prots, doms


def pack_dense(
    prot_counts: np.ndarray,
    prots: np.ndarray,
    doms: np.ndarray,
    p_cap: int,
    d_cap: int,
    n_threads: int = 0,
) -> np.ndarray:
    """
    Pack flat translation buffers into the padded dense token tensor
    ``(b, p_cap, d_cap, 5)`` int16 — OpenMP in the native engine,
    vectorized numpy scatter in the fallback.  Both produce identical
    bytes.  Proteins/domains must fit the caps (callers grow capacities
    for every batch of a dispatch first — the capacity rule of
    :meth:`Kinetics.ensure_token_capacity`).
    """
    lib = get_lib()
    if lib is None:
        return _pyengine.pack_dense(prot_counts, prots, doms, p_cap, d_cap)
    b = len(prot_counts)
    counts = np.ascontiguousarray(prot_counts, dtype=np.int32)
    prots_c = np.ascontiguousarray(prots, dtype=np.int32)
    doms_c = np.ascontiguousarray(doms, dtype=np.int32)
    dense = np.zeros((b, int(p_cap), int(d_cap), 5), dtype=np.int16)
    if b == 0 or len(doms_c) == 0:
        return dense
    lib.ms_pack_dense(
        counts.ctypes.data_as(_i32p),
        b,
        prots_c.ctypes.data_as(_i32p),
        len(prots_c),
        doms_c.ctypes.data_as(_i32p),
        len(doms_c),
        int(p_cap),
        int(d_cap),
        n_threads,
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    return dense


def _unpack_seqs(
    lib, out_data, out_offsets, out_idxs, n: int, seqs_per_item: int
) -> list[tuple]:
    """Decode (data, offsets, idxs) triple returned by a mutation call"""
    try:
        if n == 0:
            return []
        offs = np.ctypeslib.as_array(out_offsets, shape=(seqs_per_item * n + 1,))
        total = int(offs[-1])
        buf = ctypes.string_at(out_data, total)
        idxs = np.ctypeslib.as_array(out_idxs, shape=(n,))
        out = []
        for k in range(n):
            parts = tuple(
                buf[offs[seqs_per_item * k + j] : offs[seqs_per_item * k + j + 1]].decode()
                for j in range(seqs_per_item)
            )
            out.append(parts + (int(idxs[k]),))
        return out
    finally:
        lib.ms_free(out_data)
        lib.ms_free(out_offsets)
        lib.ms_free(out_idxs)


def point_mutations(
    seqs: list[str],
    p: float,
    p_indel: float,
    p_del: float,
    seed: int,
    n_threads: int = 0,
) -> list[tuple[str, int]]:
    """
    Point mutations; returns only mutated sequences with input indices.

    The Poisson(p*len) mutation count per sequence is drawn vectorized on
    the host first, and only the (typically very few) sequences with a
    nonzero count are handed to the string engine — per-call work scales
    with the number of mutated genomes, not the population
    (reference rust/mutations.rs:11-73 iterates all genomes per call).
    """
    if len(seqs) == 0:
        return []
    with _telemetry.span("ms:lengths"):
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=len(seqs))
        sel, counts = _poisson_select(lens, p, seed)
    if len(sel) == 0:
        return []
    sub = [seqs[int(i)] for i in sel]
    orig = sel.astype(np.int64)  # RNG streams keyed by original index
    lib = get_lib()
    if lib is None:
        out = _pyengine.point_mutations_flat(sub, counts, orig, p_indel, p_del, seed)
    else:
        data, offsets = _concat(sub)
        out_data = _charp()
        out_offsets = _i64p()
        out_idxs = _i64p()
        out_n = ctypes.c_int64()
        lib.ms_point_mutations(
            ctypes.cast(data, _charp),
            offsets.ctypes.data_as(_i64p),
            len(sub),
            counts.ctypes.data_as(_i64p),
            orig.ctypes.data_as(_i64p),
            p_indel, p_del,
            seed & 0xFFFFFFFFFFFFFFFF,
            n_threads,
            ctypes.byref(out_data),
            ctypes.byref(out_offsets),
            ctypes.byref(out_idxs),
            ctypes.byref(out_n),
        )
        out = _unpack_seqs(lib, out_data, out_offsets, out_idxs, out_n.value, 1)
    return [(s, int(sel[i])) for s, i in out]


def recombinations(
    seq_pairs: list[tuple[str, str]],
    p: float,
    seed: int,
    n_threads: int = 0,
) -> list[tuple[str, str, int]]:
    """
    Strand-break recombinations; returns only recombined pairs.

    Like :func:`point_mutations`, the Poisson(p*(len0+len1)) break count
    per pair is pre-drawn vectorized on the host so only pairs with a
    break reach the string engine.
    """
    if len(seq_pairs) == 0:
        return []
    lens = np.fromiter(
        (len(a) + len(b) for a, b in seq_pairs), dtype=np.int64, count=len(seq_pairs)
    )
    sel, counts = _poisson_select(lens, p, seed)
    if len(sel) == 0:
        return []
    sub = [seq_pairs[int(i)] for i in sel]
    return _recombinations_selected(sub, counts, sel, seed, n_threads)


def recombinations_indexed(
    genomes: list[str],
    pair_idxs: np.ndarray,
    p: float,
    seed: int,
    n_threads: int = 0,
) -> list[tuple[str, str, int]]:
    """
    :func:`recombinations` over index pairs into a genome list, avoiding
    the materialization of one string-pair tuple per candidate pair —
    with ~2.4 neighbor pairs per cell and a per-pair break probability of
    ~1e-4, building the pair list costs more than the recombination
    itself.  Draws the identical Poisson stream (pair-list order), so
    ``recombinations(pairs, ...)`` and
    ``recombinations_indexed(genomes, idxs, ...)`` produce the same
    result for the same pairs.  Returned index = row into ``pair_idxs``.
    """
    if len(pair_idxs) == 0:
        return []
    with _telemetry.span("ms:lengths"):
        lens = np.fromiter(
            (len(g) for g in genomes), dtype=np.int64, count=len(genomes)
        )
        pair_lens = lens[pair_idxs[:, 0]] + lens[pair_idxs[:, 1]]
        sel, counts = _poisson_select(pair_lens, p, seed)
    if len(sel) == 0:
        return []
    sub = [
        (genomes[int(a)], genomes[int(b)])
        for a, b in pair_idxs[sel]
    ]
    return _recombinations_selected(sub, counts, sel, seed, n_threads)


def neighbor_pairs(positions: np.ndarray, map_size: int) -> np.ndarray | None:
    """Unique Moore-adjacent index pairs (smaller first, sorted) among
    ``(k, 2)`` positions — the C++ occupancy-grid scan (reference
    rust/world.rs:9-54).  Returns None when the native engine is absent
    (the caller falls back to the vectorized numpy construction)."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, dtype=np.int32)
    if len(pos) and (pos.min() < 0 or pos.max() >= map_size):
        # the C scan indexes an occupancy grid with these coordinates;
        # an out-of-range position would silently overflow the heap
        # (observed as 'corrupted size vs. prev_size' at exit), so fail
        # loudly at the boundary instead
        raise ValueError(
            f"positions out of range for map_size={map_size}: "
            f"min={pos.min()}, max={pos.max()}"
        )
    out_pairs = _i32p()
    out_n = ctypes.c_int64()
    lib.ms_neighbor_pairs(
        pos.ctypes.data_as(_i32p),
        len(pos),
        np.int32(map_size),
        ctypes.byref(out_pairs),
        ctypes.byref(out_n),
    )
    try:
        return (
            np.ctypeslib.as_array(out_pairs, shape=(out_n.value, 2))
            .astype(np.int64)
        )
    finally:
        lib.ms_free(out_pairs)


def _poisson_select(
    lens: np.ndarray, p: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pre-draw Poisson(p*len) counts; return (selected idxs, their counts)"""
    nprng = np.random.default_rng(np.random.PCG64(seed & 0xFFFFFFFFFFFFFFFF))
    n_breaks = nprng.poisson(p * lens)
    sel = np.nonzero(n_breaks > 0)[0]
    return sel, n_breaks[sel].astype(np.int64)


def _recombinations_selected(
    sub: list[tuple[str, str]],
    counts: np.ndarray,
    sel: np.ndarray,
    seed: int,
    n_threads: int,
) -> list[tuple[str, str, int]]:
    orig = sel.astype(np.int64)  # RNG streams keyed by original index
    lib = get_lib()
    if lib is None:
        out = _pyengine.recombinations_flat(sub, counts, orig, seed)
    else:
        flat = [s for pair in sub for s in pair]
        data, offsets = _concat(flat)
        out_data = _charp()
        out_offsets = _i64p()
        out_idxs = _i64p()
        out_n = ctypes.c_int64()
        lib.ms_recombinations(
            ctypes.cast(data, _charp),
            offsets.ctypes.data_as(_i64p),
            len(sub),
            counts.ctypes.data_as(_i64p),
            orig.ctypes.data_as(_i64p),
            seed & 0xFFFFFFFFFFFFFFFF,
            n_threads,
            ctypes.byref(out_data),
            ctypes.byref(out_offsets),
            ctypes.byref(out_idxs),
            ctypes.byref(out_n),
        )
        out = _unpack_seqs(lib, out_data, out_offsets, out_idxs, out_n.value, 2)
    return [(s0, s1, int(sel[i])) for s0, s1, i in out]
