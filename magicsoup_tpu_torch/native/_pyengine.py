"""
Pure-Python/numpy fallback implementation of the genome engine.

The genome engine is the host-side string-processing layer of the framework:
genome -> proteome translation, point mutations, and recombinations.  The
primary implementation is the multithreaded C++ library
(`magicsoup_tpu_torch/native/src/genome.cpp`, loaded via
:mod:`magicsoup_tpu_torch.native.engine`); this module provides the same flat-array
interface in pure Python/numpy so the framework works without a compiler.

Parity reference for the algorithms: `rust/genetics.rs:13-204` (per-frame
start stacks, nested/overlapping CDS emission, domain extraction with 3-nt /
21-nt jumps) and `rust/mutations.rs:11-154` (Poisson mutation counts,
distinct sorted positions, indel offset tracking, strand-break
recombination).

Flat translation output format (shared with the C++ engine):

- ``prot_counts``: int32 (n_genomes,) — number of proteins per genome
- ``prots``: int32 (P, 4) — per protein ``[cds_start, cds_end, is_fwd, n_doms]``
- ``doms``: int32 (D, 7) — per domain ``[dom_type, i0, i1, i2, i3, start, end]``

Proteins are ordered genome-by-genome; domains protein-by-protein.
"""
import numpy as np

from magicsoup_tpu_torch.constants import CODON_SIZE

# nucleotide byte -> 2-bit code; order TCGA mirrors ALL_NTS.
# Unknown characters map to a sentinel so codons containing them are
# treated as matching nothing (the reference's Rust engine panics on
# them inside domain specs; here they are gracefully inert).
_NT_INVALID = 64
_NT_CODE = np.full(256, _NT_INVALID, dtype=np.uint8)
for _i, _nt in enumerate("TCGA"):
    _NT_CODE[ord(_nt)] = _i

_COMPLEMENT = bytes.maketrans(b"ACTG", b"TGAC")


def codon_code(codon: str) -> int:
    """Encode a 3-nt codon as a base-4 integer (T=0, C=1, G=2, A=3)"""
    c = [int(_NT_CODE[ord(d)]) for d in codon]
    return c[0] * 16 + c[1] * 4 + c[2]


def seq_code(seq: str) -> int:
    """Encode an arbitrary-length nt sequence as a base-4 integer"""
    code = 0
    for d in seq:
        code = code * 4 + int(_NT_CODE[ord(d)])
    return code


class TranslationTables:
    """
    Integer lookup tables derived from the Genetics token maps; consumed by
    both the Python and the C++ engine.

    - ``codon_flags``: uint8 (64,) — 1 for start codons, 2 for stop codons
    - ``dom_type_lut``: uint8 (4^(2*CODON_SIZE),) — 2-codon seq code ->
      domain type (0 = no domain)
    - ``one_codon_lut``: int32 (64,) — codon code -> scalar token (1-based)
    - ``two_codon_lut``: int32 (4096,) — 2-codon code -> vector token (1-based)
    """

    def __init__(
        self,
        start_codons: list[str],
        stop_codons: list[str],
        domain_map: dict[str, int],
        one_codon_map: dict[str, int],
        two_codon_map: dict[str, int],
        dom_size: int,
        dom_type_size: int,
    ):
        self.dom_size = dom_size
        self.dom_type_size = dom_type_size

        self.codon_flags = np.zeros(64, dtype=np.uint8)
        for codon in start_codons:
            self.codon_flags[codon_code(codon)] = 1
        for codon in stop_codons:
            self.codon_flags[codon_code(codon)] = 2

        # dom_type_size is in nucleotides (default 6 -> 4096 entries)
        self.dom_type_lut = np.zeros(4**dom_type_size, dtype=np.uint8)
        for seq, dom_type in domain_map.items():
            self.dom_type_lut[seq_code(seq)] = dom_type

        self.one_codon_lut = np.zeros(64, dtype=np.int32)
        for codon, idx in one_codon_map.items():
            self.one_codon_lut[codon_code(codon)] = idx

        self.two_codon_lut = np.zeros(4096, dtype=np.int32)
        for seq, idx in two_codon_map.items():
            self.two_codon_lut[seq_code(seq)] = idx


def _codon_codes(seq_bytes: bytes) -> np.ndarray:
    """Codon code at every nucleotide position i (code of seq[i:i+3]);
    -1 for codons containing a non-TCGA character."""
    nts = _NT_CODE[np.frombuffer(seq_bytes, dtype=np.uint8)].astype(np.int32)
    n = len(nts)
    if n < CODON_SIZE:
        return np.zeros(0, dtype=np.int32)
    c0, c1, c2 = nts[: n - 2], nts[1 : n - 1], nts[2:]
    codes = c0 * 16 + c1 * 4 + c2
    invalid = (c0 >= 4) | (c1 >= 4) | (c2 >= 4)
    return np.where(invalid, -1, codes)


def get_coding_regions(
    seq: str,
    min_cds_size: int,
    start_codons: list[str],
    stop_codons: list[str],
    is_fwd: bool,
) -> list[tuple[int, int, bool]]:
    """
    Find all CDSs using per-reading-frame start stacks: a stop codon closes
    *all* pending starts of its frame (nested/overlapping CDSs).  Emission
    order follows the single pass over the sequence: CDSs sorted by stop
    position, and for one stop the latest start comes first (LIFO pop).
    """
    flags = np.zeros(64, dtype=np.uint8)
    for codon in start_codons:
        flags[codon_code(codon)] = 1
    for codon in stop_codons:
        flags[codon_code(codon)] = 2
    return _coding_regions_from_codes(
        _codon_codes(seq.encode()), flags, min_cds_size, is_fwd
    )


def _coding_regions_from_codes(
    codes: np.ndarray, codon_flags: np.ndarray, min_cds_size: int, is_fwd: bool
) -> list[tuple[int, int, bool]]:
    res: list[tuple[int, int, bool]] = []
    if codes.shape[0] == 0:
        return res
    flags = np.where(codes >= 0, codon_flags[np.clip(codes, 0, None)], 0)
    interesting = np.nonzero(flags)[0]
    starts: list[list[int]] = [[], [], []]
    for i in interesting.tolist():
        frame = i % CODON_SIZE
        if flags[i] == 1:
            starts[frame].append(i)
        else:
            j = i + CODON_SIZE
            while starts[frame]:
                d = starts[frame].pop()
                if j - d >= min_cds_size:
                    res.append((d, j, is_fwd))
    return res


def _extract_domains_into(
    codes: np.ndarray,
    cdss: list[tuple[int, int, bool]],
    tables: TranslationTables,
    prots: list[list[int]],
    doms: list[list[int]],
) -> int:
    """Walk each CDS, appending protein/domain rows; returns #proteins"""
    dom_size = tables.dom_size
    dom_type_size = tables.dom_type_size
    n_codes = codes.shape[0]
    # code of the dom_type_size-nt sequence starting at i
    # (for the default 6-nt type region: codes[i]*64 + codes[i+3])
    n_prots = 0
    for cds_start, cds_stop, is_fwd in cdss:
        n = cds_stop - cds_start
        i = 0
        is_useful = False
        my_doms: list[list[int]] = []
        while i + dom_size <= n:
            dom_start = cds_start + i
            type_code = 0
            ok = True
            for k in range(0, dom_type_size, CODON_SIZE):
                p = dom_start + k
                if p >= n_codes or codes[p] < 0:
                    ok = False
                    break
                type_code = type_code * 64 + int(codes[p])
            dom_type = int(tables.dom_type_lut[type_code]) if ok else 0
            if dom_type != 0:
                if dom_type != 3:
                    is_useful = True
                spec = dom_start + dom_type_size

                def tok1(p: int) -> int:
                    c = int(codes[p])
                    return int(tables.one_codon_lut[c]) if c >= 0 else 0

                i0 = tok1(spec)
                i1 = tok1(spec + CODON_SIZE)
                i2 = tok1(spec + 2 * CODON_SIZE)
                c3a = int(codes[spec + 3 * CODON_SIZE])
                c3b = int(codes[spec + 4 * CODON_SIZE])
                i3 = (
                    int(tables.two_codon_lut[c3a * 64 + c3b])
                    if c3a >= 0 and c3b >= 0
                    else 0
                )
                my_doms.append([dom_type, i0, i1, i2, i3, i, i + dom_size])
                i += dom_size
            else:
                i += CODON_SIZE
        if is_useful:
            prots.append([cds_start, cds_stop, int(is_fwd), len(my_doms)])
            doms.extend(my_doms)
            n_prots += 1
    return n_prots


def translate_genomes_flat(
    genomes: list[str], tables: TranslationTables
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """
    Translate genomes (forward + reverse-complement) into the flat proteome
    format documented in the module docstring.
    """
    prot_counts = np.zeros(len(genomes), dtype=np.int32)
    prots: list[list[int]] = []
    doms: list[list[int]] = []
    min_cds = tables.dom_size
    for gi, genome in enumerate(genomes):
        n_prots = 0
        fwd = genome.encode()
        codes = _codon_codes(fwd)
        cdss = _coding_regions_from_codes(codes, tables.codon_flags, min_cds, True)
        n_prots += _extract_domains_into(codes, cdss, tables, prots, doms)

        bwd = fwd.translate(_COMPLEMENT)[::-1]
        codes_b = _codon_codes(bwd)
        cdss_b = _coding_regions_from_codes(
            codes_b, tables.codon_flags, min_cds, False
        )
        n_prots += _extract_domains_into(codes_b, cdss_b, tables, prots, doms)
        prot_counts[gi] = n_prots

    prots_arr = np.array(prots, dtype=np.int32).reshape(-1, 4)
    doms_arr = np.array(doms, dtype=np.int32).reshape(-1, 7)
    return prot_counts, prots_arr, doms_arr


_NTS = "ACTG"  # reference mutation alphabet order (rust/mutations.rs:6)


def point_mutations_flat(
    seqs: list[str],
    n_muts_per_seq: np.ndarray,
    orig_idxs: np.ndarray,
    p_indel: float,
    p_del: float,
    seed: int,
) -> list[tuple[str, int]]:
    """
    Apply the given number of point mutations (substitutions and indels)
    to each sequence.  Mutation counts are pre-drawn by the caller
    (vectorized Poisson); per-sequence deterministic RNG stream derived
    from ``seed`` and the sequence's index in the caller's full
    population (``orig_idxs``), so outcomes don't depend on which other
    sequences were batched in.  Returns only mutated sequences with
    their input index (position within ``seqs``).
    """
    out: list[tuple[str, int]] = []
    for idx, seq in enumerate(seqs):
        n = len(seq)
        if n < 1:
            continue
        rng = np.random.default_rng(
            np.random.PCG64(seed * 1_000_003 + int(orig_idxs[idx]))
        )
        n_muts = int(n_muts_per_seq[idx])
        if n_muts < 1:
            continue
        n_muts = min(n_muts, n)
        positions = np.sort(rng.choice(n, size=n_muts, replace=False))
        chars = list(seq)
        offset = 0
        # graftlint: disable=GL007 indel offsets shift per mutation; the scalar loop IS the algorithm (fallback path)
        for pos in positions.tolist():
            cur = pos + offset
            if rng.random() < p_indel:
                if rng.random() < p_del:
                    del chars[cur]
                    offset -= 1
                else:
                    chars.insert(cur, _NTS[rng.integers(4)])
                    offset += 1
            else:
                chars[cur] = _NTS[rng.integers(4)]
        out.append(("".join(chars), idx))
    return out


def recombinations_flat(
    seq_pairs: list[tuple[str, str]],
    n_breaks_per_pair: np.ndarray,
    orig_idxs: np.ndarray,
    seed: int,
) -> list[tuple[str, str, int]]:
    """
    Recombine sequence pairs by the given numbers of strand breaks: both
    sequences are cut at random positions, all fragments shuffled, and a
    random split point reassembles two new sequences (length-conserving).
    Break counts are pre-drawn by the caller (vectorized Poisson);
    per-pair RNG streams are keyed by ``orig_idxs`` (the pair's index in
    the caller's full pair list) for batch-independence.
    Returns only recombined pairs with their input index.
    """
    out: list[tuple[str, str, int]] = []
    for idx, (seq0, seq1) in enumerate(seq_pairs):
        n0 = len(seq0)
        n1 = len(seq1)
        n_both = n0 + n1
        if n_both < 1:
            continue
        rng = np.random.default_rng(
            np.random.PCG64(seed * 1_000_003 + int(orig_idxs[idx]))
        )
        n_muts = int(n_breaks_per_pair[idx])
        if n_muts < 1:
            continue
        n_muts = min(n_muts, n_both)
        cut_positions = np.sort(rng.choice(n_both, size=n_muts, replace=False))

        parts: list[str] = []
        i = 0
        # graftlint: disable=GL007 per-pair cut lists are tiny; this is the pure-python fallback, native engine is primary
        for j in cut_positions[cut_positions < n0].tolist():
            parts.append(seq0[i:j])
            i = j
        parts.append(seq0[i:])
        i = 0
        # graftlint: disable=GL007 see above: per-pair fallback loop
        for j in (cut_positions[cut_positions >= n0] - n0).tolist():
            parts.append(seq1[i:j])
            i = j
        parts.append(seq1[i:])

        order = rng.permutation(len(parts))
        parts = [parts[k] for k in order.tolist()]  # graftlint: disable=GL007 per-pair fallback shuffle
        s = int(rng.integers(len(parts)))
        out.append(("".join(parts[:s]), "".join(parts[s:]), idx))
    return out


def pack_dense(
    prot_counts: np.ndarray,
    prots: np.ndarray,
    doms: np.ndarray,
    p_cap: int,
    d_cap: int,
) -> np.ndarray:
    """Pack flat translation buffers into the padded dense token tensor
    (b, p_cap, d_cap, 5) int16 [dom_type, i0, i1, i2, i3] — the numpy
    fallback of the native ``ms_pack_dense`` (vectorized scatter via the
    repeat/cumsum index expansion)."""
    b = len(prot_counts)
    dense = np.zeros((b, p_cap, d_cap, 5), dtype=np.int16)
    if len(doms) == 0:
        return dense
    n_doms_per_prot = prots[:, 3]
    # cell index of each protein / protein index within its cell
    prot_cell = np.repeat(np.arange(b, dtype=np.int64), prot_counts)
    prot_starts = np.concatenate([[0], np.cumsum(prot_counts)])[:-1]
    prot_in_cell = np.arange(len(prots), dtype=np.int64) - np.repeat(
        prot_starts, prot_counts
    )
    # protein index of each domain / domain index within its protein
    dom_prot = np.repeat(np.arange(len(prots), dtype=np.int64), n_doms_per_prot)
    dom_starts = np.concatenate([[0], np.cumsum(n_doms_per_prot)])[:-1]
    dom_in_prot = np.arange(len(doms), dtype=np.int64) - np.repeat(
        dom_starts, n_doms_per_prot
    )
    dense[prot_cell[dom_prot], prot_in_cell[dom_prot], dom_in_prot] = doms[:, :5]
    return dense
