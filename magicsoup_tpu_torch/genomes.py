"""
Device-resident genomes: packed token tensors and the evolution programs
over them.  Counterpart of :mod:`magicsoup_tpu.genomes` (without mesh
placement: a store lives on one explicit device).

A world's genomes live on its device as a fixed-capacity packed token
tensor instead of host strings:

- ``tokens``: ``(cap, G)`` int8, one row per cell slot (the world's slot
  capacity), ``G`` the pow2 per-genome length capacity; positions past a
  row's length hold :data:`PAD`;
- ``lengths``: ``(cap,)`` int32 genome lengths.

Token code ``i`` is nucleotide ``TOKEN_NTS[i]``, the ``TCGA`` -> ``0..3``
order of the genome engine's translation tables, so a decoded row feeds
:class:`~magicsoup_tpu_torch.genetics.Genetics` without remapping.

Evolution runs as seeded programs over those tensors, the JAX package's
jitted programs written as eager PyTorch:

- :func:`point_mutations_tokens`: substitutions and indels in one pass;
  an exclusive cumulative insert/delete offset per position maps every
  surviving source token to its destination column;
- :func:`recombinations_tokens`: each firing neighbour pair draws one cut
  per strand and exchanges tails; a row in several firing pairs takes the
  LAST one's result (an ``amax`` scatter of the pair's 1-based index).

Their random numbers are the JAX package's: threefry-2x32 draws of
:mod:`magicsoup_tpu_torch.ops.prng` over the same shapes (the whole
``(cap, G)`` store; the pair list padded with :func:`~magicsoup_tpu_torch.
ops.params.pad_idxs`), keyed by ``jax.random.PRNGKey(seed)`` as jax
builds it with 64-bit mode off, its default: the seed's low 32 bits.  On
the card each draw is one launch of the threefry kernel.  After the
draws the programs are integer-only with unique scatter destinations, so
a seed gives the JAX package's tokens bit for bit on either device; in
deterministic mode the recombination's fire probability goes through
:func:`~magicsoup_tpu_torch.ops.detmath.det_exp`, so that the one
transcendental matches too (in fast mode ``torch.exp`` may differ from
XLA's ``exp`` by an ULP, and a pair whose uniform draw lies that close
to its miss probability fires on one side only).

Out-of-bounds scatters, which JAX drops, write into a spare sink column
or row that is sliced off; out-of-bounds gathers clamp, as JAX's do.

:class:`GenomeStore` owns the tensors for a world: every mutator is
functional (it replaces the tensors and bumps a version counter, never
writes in place), so a clone shares tensors safely, and the decoded
string view and the host snapshot are cached per version.
"""
import hashlib
import random

import numpy as np
import torch

from magicsoup_tpu_torch.analysis import runtime as _runtime
from magicsoup_tpu_torch.ops import detmath
from magicsoup_tpu_torch.ops import prng as _prng
from magicsoup_tpu_torch.ops.params import pad_idxs, pad_pow2
from magicsoup_tpu_torch.parallel.tiled import sharded_attr
from magicsoup_tpu_torch.util import fetch_host, resolve_device, restored_device, sanctioned_sync

PAD = 4  # int8 fill value outside a row's live region (never a base)
TOKEN_NTS = "TCGA"  # token code i <-> TOKEN_NTS[i]; the engine's code
_MIN_G = 64  # minimum per-genome length capacity (pow2)
_G_SLACK = 8  # regrow headroom: insertions may exceed G by a few bases

_ENC = np.full(256, -1, dtype=np.int16)
for _i, _c in enumerate(TOKEN_NTS.encode()):
    _ENC[_c] = _i
_DEC = np.frombuffer(TOKEN_NTS.encode(), dtype=np.uint8)


def _download(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host, through pinned memory on a CUDA device
    (a copy into pageable memory runs several times slower there); a
    synchronizing copy either way, sanctioned as :func:`fetch_host`'s is
    (it passes ``hot_path_guard``) and metered as a fetch."""
    if t.device.type != "cuda":
        return fetch_host(t)
    from magicsoup_tpu_torch.telemetry.recorder import note_fetch

    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with sanctioned_sync():
        host.copy_(t)
    note_fetch(host.numpy().nbytes)
    return host.numpy()


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host operand on ``device`` (through pinned memory and a
    non-blocking copy on a CUDA device)."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# ------------------------------------------------------------------ #
# host codec (the string import/export boundary)                     #
# ------------------------------------------------------------------ #


def length_capacity(max_len: int) -> int:
    """The pow2 per-genome length capacity for a maximum genome length."""
    return pad_pow2(max(int(max_len), 1), minimum=_MIN_G)


def encode_genomes(
    genomes: list[str], length_cap: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pack genome strings into ``(tokens (b, G) int8, lengths (b,) int32)``.

    ``G`` is ``length_cap`` or the pow2 capacity of the longest input.
    Any byte outside ``TCGA`` raises ``ValueError``: a wrong code would
    translate to a wrong (not absent) proteome.
    """
    n = len(genomes)
    lengths = np.fromiter((len(g) for g in genomes), dtype=np.int32, count=n)
    cap = length_capacity(int(lengths.max()) if n else 1)
    if length_cap is not None:
        if n and int(lengths.max()) > length_cap:
            raise ValueError(
                f"genome of length {int(lengths.max())} exceeds the"
                f" requested length_cap={length_cap}"
            )
        cap = length_cap
    tokens = np.full((n, cap), PAD, dtype=np.int8)
    for i, g in enumerate(genomes):
        if not g:
            continue
        row = _ENC[np.frombuffer(g.encode("ascii", "replace"), dtype=np.uint8)]
        if (row < 0).any():
            bad = g[int(np.argmax(row < 0))]
            raise ValueError(
                f"genome {i} contains non-TCGA byte {bad!r}; token"
                " packing accepts only the TCGA nucleotide alphabet"
            )
        tokens[i, : len(row)] = row.astype(np.int8)
    return tokens, lengths


def decode_tokens(tokens: np.ndarray, lengths: np.ndarray) -> list[str]:
    """Unpack host token rows back into genome strings."""
    tokens = np.asarray(tokens)
    return [
        bytes(_DEC[tokens[i, : int(n)].astype(np.uint8)]).decode("ascii")
        for i, n in enumerate(np.asarray(lengths))
    ]


def token_hashes(tokens: np.ndarray, lengths: np.ndarray, idxs=None) -> list[bytes]:
    """Per-row blake2b content hashes of the live region (the token-path
    phenotype-cache key: rows with equal bases and length collide
    whatever their slot, padding or ``G``)."""
    tokens = np.asarray(tokens)
    lengths = np.asarray(lengths)
    rows = range(len(lengths)) if idxs is None else idxs
    return [
        hashlib.blake2b(tokens[i, : int(lengths[i])].tobytes(), digest_size=16).digest()
        for i in rows
    ]


# ------------------------------------------------------------------ #
# the programs                                                       #
# ------------------------------------------------------------------ #


def _point_mutations_program(tokens, lengths, live, key, p, p_indel, p_del, *, det=False):
    """Substitutions and indels in one pass (``genomes.py:182-233`` of the
    JAX package).  Integer-only after the uniform draws, every real
    scatter destination unique: no ``det`` branch is needed."""
    del det
    cap, g = tokens.shape
    dev = tokens.device
    ku, kk, kd, kb = _prng.split(key, 4).unbind(-2)
    col = torch.arange(g, dtype=torch.int64, device=dev)[None, :]
    in_len = (col < lengths.long()[:, None]) & live[:, None]

    event = (_prng.uniform(ku, (cap, g)) < p) & in_len
    kind = _prng.uniform(kk, (cap, g))
    is_indel = event & (kind < p_indel)
    is_sub = event & (kind >= p_indel)
    dd = _prng.uniform(kd, (cap, g))
    is_del = is_indel & (dd < p_del)
    is_ins = is_indel & (dd >= p_del)
    base = _prng.randint(kb, (cap, g), 0, 4, torch.int8).to(torch.int8)

    # substitutions first, at original coordinates (engine order); a draw
    # equal to the current base is a silent substitution, as in the engine
    mutated = torch.where(is_sub, base, tokens)

    # each destination column is `source + (#inserts before) - (#deletes
    # before)`; an insertion lands at its own offset column and pushes its
    # source token one further right
    ins = is_ins.long()
    delta = ins - is_del.long()
    shift = torch.cumsum(delta, dim=1) - delta  # exclusive cumsum
    dst_src = col + shift + ins
    dst_ins = col + shift

    # column g is the sink of every destination JAX drops
    keep = in_len & ~is_del
    out = torch.full((cap, g + 1), PAD, dtype=torch.int8, device=dev)
    out.scatter_(1, torch.where(keep, dst_src, g).clamp_(max=g), mutated)
    out.scatter_(1, torch.where(is_ins, dst_ins, g).clamp_(max=g), base)
    out = out[:, :g]

    n_ins = is_ins.sum(dim=1)
    n_del = is_del.sum(dim=1)
    new_len = (lengths.long() + n_ins - n_del).clamp(0, g).to(torch.int32)
    new_len = torch.where(live, new_len, lengths)
    out = torch.where(col < new_len.long()[:, None], out, PAD)
    return out, new_len, event.any(dim=1)


def _recombinations_program(tokens, lengths, pair_a, pair_b, valid, key, log1mp, *, det=False):
    """Pairwise segment swap (``genomes.py:236-312`` of the JAX package).
    Each valid pair fires with ``1 - (1-p)^(len_a + len_b)``, draws one
    cut per strand, uniform over ``[0, len]``, and exchanges tails; a row
    in several firing pairs takes the last one's result."""
    cap, g = tokens.shape
    dev = tokens.device
    npairs = pair_a.shape[0]
    kf, ka, kb = _prng.split(key, 3).unbind(-2)
    pair_a, pair_b = pair_a.long(), pair_b.long()
    lens = lengths.long()

    la = torch.where(valid, lens[pair_a.clamp(0, cap - 1)], 0)
    lb = torch.where(valid, lens[pair_b.clamp(0, cap - 1)], 0)
    x = (la + lb).to(torch.float32) * log1mp
    miss = detmath.det_exp(x) if det else torch.exp(x)
    fire = (_prng.uniform(kf, (npairs,)) >= miss) & valid

    cut_a = _prng.randint(ka, (npairs,), 0, la + 1)
    cut_b = _prng.randint(kb, (npairs,), 0, lb + 1)

    # the last firing pair wins each row: max-scatter of its 1-based index
    prio = torch.where(fire, torch.arange(1, npairs + 1, device=dev), 0)
    row_a = torch.where(fire, pair_a, cap)
    row_b = torch.where(fire, pair_b, cap)
    winner = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, row_a, prio, "amax", include_self=True)
    winner.scatter_reduce_(0, row_b, prio, "amax", include_self=True)
    write_a = fire & (winner[pair_a.clamp(0, cap)] == prio)
    write_b = fire & (winner[pair_b.clamp(0, cap)] == prio)

    col = torch.arange(g, dtype=torch.int64, device=dev)[None, :]

    def _swap(rows_keep, rows_tail, cut_keep, cut_tail, len_tail):
        """Head of `rows_keep` up to its cut + tail of `rows_tail` from
        its cut, gathered in one pass."""
        from_head = col < cut_keep[:, None]
        src_row = torch.where(from_head, rows_keep[:, None], rows_tail[:, None])
        src_col = torch.where(from_head, col, col - cut_keep[:, None] + cut_tail[:, None])
        out = tokens[src_row.clamp(0, cap - 1), src_col.clamp(0, g - 1)]
        new_len = (cut_keep + (len_tail - cut_tail)).clamp(0, g)
        out = torch.where(col < new_len[:, None], out, PAD)
        return out, new_len.to(torch.int32)

    new_a, len_a = _swap(pair_a, pair_b, cut_a, cut_b, lb)
    new_b, len_b = _swap(pair_b, pair_a, cut_b, cut_a, la)

    # row cap is the sink of every write JAX drops
    sink_row = torch.full((1, g), PAD, dtype=torch.int8, device=dev)
    out_tokens = torch.cat([tokens, sink_row])
    out_lengths = torch.cat([lengths, lengths.new_zeros(1)])
    dst_a = torch.where(write_a, pair_a, cap)
    dst_b = torch.where(write_b, pair_b, cap)
    out_tokens[dst_a] = new_a
    out_tokens[dst_b] = new_b
    out_lengths[dst_a] = len_a
    out_lengths[dst_b] = len_b
    # index_fill_ takes the fill as a kernel argument; an advanced-index
    # write of a Python scalar would copy it over from the host
    changed = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    changed.index_fill_(0, row_a, True)
    changed.index_fill_(0, row_b, True)
    return out_tokens[:cap], out_lengths[:cap], changed[:cap]


def _set_rows_program(tokens, lengths, idxs, rows, lens):
    """Scatter encoded rows into slots (padded idxs drop into the sink)."""
    cap = tokens.shape[0]
    idxs = idxs.long().clamp(max=cap)
    out_t = torch.cat([tokens, tokens.new_full((1, tokens.shape[1]), PAD)])
    out_l = torch.cat([lengths, lengths.new_zeros(1)])
    out_t[idxs] = rows
    out_l[idxs] = lens
    return out_t[:cap], out_l[:cap]


def _copy_rows_program(tokens, lengths, src, dst):
    """Parent -> child row copies (division inheritance, no decode)."""
    cap = tokens.shape[0]
    src = src.long().clamp(0, cap - 1)
    dst = dst.long().clamp(max=cap)
    out_t = torch.cat([tokens, tokens.new_full((1, tokens.shape[1]), PAD)])
    out_l = torch.cat([lengths, lengths.new_zeros(1)])
    out_t[dst] = tokens[src]
    out_l[dst] = lengths[src]
    return out_t[:cap], out_l[:cap]


def _permute_program(tokens, lengths, perm, n_keep: int):
    """Apply a compaction permutation and PAD rows past ``n_keep``."""
    perm = perm.long()
    row = torch.arange(tokens.shape[0], device=tokens.device)
    tokens = torch.where((row < n_keep)[:, None], tokens[perm], PAD)
    lengths = torch.where(row < n_keep, lengths[perm], 0)
    return tokens, lengths


def _as_key(seed: int | None, device: torch.device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed & (2**63 - 1))`` as jax builds it with
    64-bit mode off (its default): the seed's low 32 bits."""
    if seed is None:
        # graftlint: disable=GL004 entropy only when the caller passed no seed
        seed = random.SystemRandom().randrange(2**63)
    return _prng.prng_key(int(seed) & 0xFFFFFFFF, device)


def _scalar(x: float, device: torch.device) -> torch.Tensor:
    """A float32 operand on ``device`` (the JAX package uploads
    ``np.float32`` rates), filled on the device: no host->device copy.
    A Python float made from an f32 converts back to the same bits."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32, device=device)


def point_mutations_tokens(
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    *,
    p: float = 1e-6,
    p_indel: float = 0.4,
    p_del: float = 0.66,
    seed: int | None = None,
    live=None,
    det: bool = False,
):
    """Point mutations over a token tensor on its device.  Returns
    ``(tokens, lengths, changed)``: new tensors and a ``(cap,)`` mask of
    rows with any mutation event.  ``live`` (a ``(cap,)`` bool tensor or
    host array; all rows by default) selects the rows that mutate; as in
    the JAX package, every other row comes back as PAD with its length
    kept."""
    dev = tokens.device
    if live is None:
        live = torch.ones(tokens.shape[0], dtype=torch.bool, device=dev)
    elif not isinstance(live, torch.Tensor):
        live = _upload(np.asarray(live, dtype=bool), dev)
    return _point_mutations_program(
        tokens,
        lengths,
        live.to(dev),
        _as_key(seed, dev),
        _scalar(p, dev),
        _scalar(p_indel, dev),
        _scalar(p_del, dev),
        det=det,
    )


def recombinations_tokens(
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    pairs,
    *,
    p: float = 1e-7,
    seed: int | None = None,
    det: bool = False,
):
    """Pairwise recombination over a token tensor on its device.
    ``pairs`` is a host ``(n, 2)`` row-index array (e.g.
    :func:`~magicsoup_tpu_torch.util.moore_pairs`); it is padded to a
    power of two of at least ``IDX_BLOCK`` pairs, as the JAX package pads
    it, since the draws cover the padded list.  Returns ``(tokens,
    lengths, changed)``."""
    pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
    dev = tokens.device
    cap = tokens.shape[0]
    n = len(pairs)
    a = pad_idxs(pairs[:, 0], oob=cap)
    b = pad_idxs(pairs[:, 1], oob=cap)
    valid = np.zeros(len(a), dtype=bool)
    valid[:n] = True
    # log1p in float64 on the host: the per-pair miss probability is then
    # a single device exp of `total * log(1-p)`
    log1mp = np.float32(np.log1p(-min(float(p), 1.0 - 1e-12)))
    return _recombinations_program(
        tokens,
        lengths,
        _upload(a, dev),
        _upload(b, dev),
        _upload(valid, dev),
        _as_key(seed, dev),
        _scalar(log1mp, dev),
        det=det,
    )


# ------------------------------------------------------------------ #
# string-replay wrappers (engine-shaped API over the same programs)  #
# ------------------------------------------------------------------ #


def _encode_at_shape(
    seqs: list[str], cap: int | None, length_cap: int | None
) -> tuple[np.ndarray, np.ndarray]:
    """Encode ``seqs`` padded to an explicit ``(cap, G)`` shape: the
    programs' draw shapes ARE ``(cap, G)``, so a string-side replay
    reproduces a token world's call only at the world's store shape."""
    tokens, lengths = encode_genomes(seqs, length_cap=length_cap)
    if cap is not None and cap > len(seqs):
        tokens = np.pad(tokens, ((0, cap - len(seqs)), (0, 0)), constant_values=PAD)
        lengths = np.pad(lengths, (0, cap - len(seqs)))
    return tokens, lengths


def _host_rows(out_t, out_l, changed):
    return fetch_host(changed), fetch_host(out_t), fetch_host(out_l)


def point_mutations_strings(
    seqs: list[str],
    p: float = 1e-6,
    p_indel: float = 0.4,
    p_del: float = 0.66,
    seed: int | None = None,
    *,
    cap: int | None = None,
    length_cap: int | None = None,
    det: bool = False,
    device=None,
) -> list[tuple[str, int]]:
    """:func:`~magicsoup_tpu_torch.mutations.point_mutations`-shaped
    wrapper over the token program: encode, run the same program on
    ``device`` (``None``: CUDA), decode changed rows.  With
    ``cap``/``length_cap`` equal to a token world's store shape, a string
    world replaying this sees the token world's outcomes bit for bit."""
    if not seqs:
        return []
    dev = resolve_device(device, "point_mutations_strings")
    tokens, lengths = _encode_at_shape(seqs, cap, length_cap)
    live = np.zeros(tokens.shape[0], dtype=bool)
    live[: len(seqs)] = True
    changed, host_t, host_l = _host_rows(
        *point_mutations_tokens(
            _upload(tokens, dev), _upload(lengths, dev), p=p, p_indel=p_indel,
            p_del=p_del, seed=seed, live=live, det=det,
        )
    )
    idxs = np.nonzero(changed[: len(seqs)])[0]
    return [
        (bytes(_DEC[host_t[i, : host_l[i]].astype(np.uint8)]).decode(), int(i))
        for i in idxs
    ]


def recombinations_indexed_strings(
    seqs: list[str],
    pairs,
    p: float = 1e-7,
    seed: int | None = None,
    *,
    cap: int | None = None,
    length_cap: int | None = None,
    det: bool = False,
    device=None,
) -> list[tuple[str, str, int]]:
    """``engine.recombinations_indexed``-shaped wrapper over the token
    program: ``(genome_a, genome_b, pair_index)`` per pair touching a
    changed row, each with the program's final row content, so applying
    them in any order converges to the program's state."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if not len(seqs) or not len(pairs):
        return []
    dev = resolve_device(device, "recombinations_indexed_strings")
    tokens, lengths = _encode_at_shape(seqs, cap, length_cap)
    changed, host_t, host_l = _host_rows(
        *recombinations_tokens(
            _upload(tokens, dev), _upload(lengths, dev), pairs, p=p, seed=seed, det=det
        )
    )

    def _row(i: int) -> str:
        return bytes(_DEC[host_t[i, : host_l[i]].astype(np.uint8)]).decode()

    return [
        (_row(int(a)), _row(int(b)), int(k))
        for k, (a, b) in enumerate(pairs)
        if changed[a] or changed[b]
    ]


# ------------------------------------------------------------------ #
# the device store                                                   #
# ------------------------------------------------------------------ #


class GenomeStore:
    """Device-resident packed genomes for one world.

    Owns the ``(cap, G)`` token tensor and the ``(cap,)`` length vector on
    ``device`` (``None``: CUDA).  Every mutator is functional: it replaces
    the tensors and bumps ``version``; the decoded string view and the
    host snapshot are caches keyed by that version, so steady-state
    device evolution never decodes and a repeated export decodes once.
    A pickle holds the tensors as host numpy and the device as its
    string; :meth:`place` moves the store to another device.

    Under a ``mesh`` (a mesh-placed World's) each rank holds its slot
    block of both tensors, and ``tokens`` / ``lengths`` read as the
    whole store (all-gathered) and keep the rank's block when assigned:
    the programs run on the gathered store, so every draw keeps the
    global counter layout of the single-device store, and each rank keeps
    its block of the result.  A pickle is mesh-free.
    """

    tokens = sharded_attr("tokens", 0)
    lengths = sharded_attr("lengths", 0)

    def __init__(self, capacity: int, length_cap: int = _MIN_G, device=None, mesh=None):
        self._mesh = mesh
        self.device = resolve_device(device, "GenomeStore")
        self.capacity = int(capacity)
        self.length_cap = length_capacity(length_cap)
        self.tokens = torch.full(
            (self.capacity, self.length_cap), PAD, dtype=torch.int8, device=self.device
        )
        self.lengths = torch.zeros(self.capacity, dtype=torch.int32, device=self.device)
        self.version = 0
        self._decoded: tuple[int, list[str]] | None = None
        self._host: tuple[int, np.ndarray, np.ndarray] | None = None
        self._host_lens: tuple[int, np.ndarray] | None = None

    def clone(self) -> "GenomeStore":
        """Tensor-SHARING copy (no device work): safe because every
        mutator replaces the tensors, never writes into them.  The
        stepper checks out a world's genomes this way."""
        new = GenomeStore.__new__(GenomeStore)
        new._mesh = self._mesh
        new.device = self.device
        new.capacity = self.capacity
        new.length_cap = self.length_cap
        new.__dict__["tokens"] = self.__dict__["tokens"]
        new.__dict__["lengths"] = self.__dict__["lengths"]
        new.version = 0
        new._decoded = None
        new._host = None
        new._host_lens = None
        return new

    # -- placement / pickling ----------------------------------------- #

    def place(self, device) -> None:
        """Move the tensors to ``device`` (the cached host views stay
        valid: the contents do not change)."""
        self.device = torch.device(device)
        for name in ("tokens", "lengths"):
            self.__dict__[name] = self.__dict__[name].to(self.device)

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["tokens"] = fetch_host(self.tokens)
        state["lengths"] = fetch_host(self.lengths)
        state["device"] = str(self.device)
        state["_mesh"] = None
        state["_decoded"] = None
        state["_host"] = None
        state["_host_lens"] = None
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._host_lens = None
        self.tokens = torch.from_numpy(state["tokens"])
        self.lengths = torch.from_numpy(state["lengths"])
        self.place(restored_device(state["device"], "GenomeStore"))

    # -- cached host views ------------------------------------------- #

    def _bump(self) -> None:
        self.version += 1
        self._decoded = None
        self._host = None
        self._host_lens = None

    def host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Host snapshot ``(tokens, lengths)`` (cached per version; each
        fetch is counted in ``analysis.runtime.genome_stats``)."""
        if self._host is None or self._host[0] != self.version:
            tok, lens = _download(self.tokens), _download(self.lengths)
            _runtime.note_genome_fetch(tok.nbytes + lens.nbytes)
            self._host = (self.version, tok, lens)
        return self._host[1], self._host[2]

    def host_lengths(self) -> np.ndarray:
        """Host copy of the ``(cap,)`` length vector, cached per version:
        taken from the whole-store snapshot when one is cached, else one
        fetch of the lengths alone (counted in
        ``analysis.runtime.genome_stats`` as a length fetch)."""
        if self._host is not None and self._host[0] == self.version:
            return self._host[2]
        if self._host_lens is None or self._host_lens[0] != self.version:
            lens = _download(self.lengths)
            _runtime.note_genome_length_fetch(lens.nbytes)
            self._host_lens = (self.version, lens)
        return self._host_lens[1]

    def decoded(self, n: int) -> list[str]:
        """The first ``n`` rows as genome strings (cached per version;
        the export boundary: steady-state device paths never call it)."""
        cached = self._decoded
        if cached is not None and cached[0] == self.version and len(cached[1]) == n:
            return cached[1]
        tok, lens = self.host_arrays()
        out = decode_tokens(tok[:n], lens[:n])
        _runtime.note_genome_decode(rows=n)
        self._decoded = (self.version, out)
        return out

    def decode_row(self, i: int) -> str:
        """One row as a genome string."""
        tok, lens = self.host_arrays()
        _runtime.note_genome_decode(rows=1)
        return decode_tokens(tok[i : i + 1], lens[i : i + 1])[0]

    def hashes(self, idxs) -> list[bytes]:
        """Content hashes for the given rows (phenotype-cache keys)."""
        tok, lens = self.host_arrays()
        return token_hashes(tok, lens, idxs)

    def max_length(self) -> int:
        _, lens = self.host_arrays()
        return int(lens.max()) if len(lens) else 0

    # -- mutators ------------------------------------------------------ #

    def adopt(self, tokens: torch.Tensor, lengths: torch.Tensor) -> None:
        """Replace the tensors wholesale (the stepper's flush hand-back)."""
        self.capacity = int(tokens.shape[0])
        self.length_cap = int(tokens.shape[1])
        self.tokens = tokens
        self.lengths = lengths
        self._bump()

    def set_all(self, genomes: list[str]) -> None:
        """Reset the store to exactly these genomes."""
        n = len(genomes)
        if n > self.capacity:
            raise ValueError(
                f"{n} genomes exceed the store capacity {self.capacity};"
                " grow the world first"
            )
        rows, lens = encode_genomes(genomes) if n else (
            np.zeros((0, self.length_cap), dtype=np.int8),
            np.zeros(0, dtype=np.int32),
        )
        self.ensure_length_cap(rows.shape[1])
        tokens = np.full((self.capacity, self.length_cap), PAD, dtype=np.int8)
        tokens[:n, : rows.shape[1]] = rows
        lengths = np.zeros(self.capacity, dtype=np.int32)
        lengths[:n] = lens
        self.tokens = _upload(tokens, self.device)
        self.lengths = _upload(lengths, self.device)
        self._bump()

    def set_rows(self, idxs, genomes: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Encode and scatter genomes into slots; returns the encoded
        ``(rows, lens)`` so callers can hash and translate without a
        device round trip (the string import boundary)."""
        rows, lens = encode_genomes(genomes)
        self.ensure_length_cap(rows.shape[1])
        if rows.shape[1] < self.length_cap:
            rows = np.pad(
                rows, ((0, 0), (0, self.length_cap - rows.shape[1])), constant_values=PAD
            )
        idxs_pad = pad_idxs(np.asarray(idxs, dtype=np.int64), oob=self.capacity)
        b = len(idxs_pad)
        rows_pad = np.full((b, self.length_cap), PAD, dtype=np.int8)
        rows_pad[: len(genomes)] = rows
        lens_pad = np.zeros(b, dtype=np.int32)
        lens_pad[: len(genomes)] = lens
        self.tokens, self.lengths = _set_rows_program(
            self.tokens,
            self.lengths,
            _upload(idxs_pad, self.device),
            _upload(rows_pad, self.device),
            _upload(lens_pad, self.device),
        )
        self._bump()
        return rows, lens

    def copy_rows(self, src, dst) -> None:
        """Device parent -> child copies (division; no host work)."""
        src_pad = pad_idxs(np.asarray(src, dtype=np.int64), oob=self.capacity)
        dst_pad = pad_idxs(np.asarray(dst, dtype=np.int64), oob=self.capacity)
        self.tokens, self.lengths = _copy_rows_program(
            self.tokens,
            self.lengths,
            _upload(src_pad, self.device),
            _upload(dst_pad, self.device),
        )
        self._bump()

    def permute(self, perm, n_keep: int) -> None:
        """Device compaction (the kill path; no host work)."""
        self.tokens, self.lengths = _permute_program(
            self.tokens,
            self.lengths,
            _upload(np.asarray(perm, dtype=np.int64), self.device),
            int(n_keep),
        )
        self._bump()

    def apply(self, tokens: torch.Tensor, lengths: torch.Tensor) -> None:
        """Install program outputs (mutation or recombination results)."""
        self.tokens = tokens
        self.lengths = lengths
        self._bump()

    # -- capacity ------------------------------------------------------ #

    def grow_capacity(self, capacity: int) -> None:
        """Grow the slot axis to ``capacity`` (world capacity growth)."""
        if capacity <= self.capacity:
            return
        tok, lens = self.host_arrays()
        tokens = np.full((capacity, self.length_cap), PAD, dtype=np.int8)
        tokens[: self.capacity] = tok
        lengths = np.zeros(capacity, dtype=np.int32)
        lengths[: self.capacity] = lens
        self.capacity = capacity
        self.tokens = _upload(tokens, self.device)
        self.lengths = _upload(lengths, self.device)
        self._bump()

    def ensure_length_cap(self, g: int) -> None:
        """Grow the per-genome length axis to a pow2 >= ``g``.  Callers
        regrow G before the live region reaches it (``max_length()``
        against ``length_cap - _G_SLACK``), so the programs' capacity
        truncation stays a never-hit backstop."""
        if g <= self.length_cap:
            return
        new_g = length_capacity(g)
        tok, lens = self.host_arrays()
        tokens = np.full((self.capacity, new_g), PAD, dtype=np.int8)
        tokens[:, : self.length_cap] = tok
        self.length_cap = new_g
        self.tokens = _upload(tokens, self.device)
        self.lengths = _upload(lens, self.device)
        self._bump()

    def maybe_regrow(self) -> None:
        """Regrow G when insertions drift the longest genome into the
        slack band (one cached host read per store version)."""
        if self.max_length() > self.length_cap - _G_SLACK:
            self.ensure_length_cap(self.length_cap + _G_SLACK + 1)
