"""
Codon machinery and genome -> proteome translation.

Parity reference: `python/magicsoup/genetics.py:18-178`.  Same defaults
(start codons TTG/GTG/ATG, stop codons TGA/TAG/TAA, 2 domain-type codons +
3 one-codon scalar tokens + 1 two-codon vector token => 21-nt domains) and
the same token-map construction: all 2-codon sequences not containing a
start codon are shuffled and fractions assigned to the three domain types.

Counterpart of :mod:`magicsoup_tpu.genetics` (host code, copied):
- explicit ``seed`` — the shuffle is driven by a private
  ``random.Random(seed)``, so one seed gives the JAX package's codon maps.
- translation is engine-backed (C++/OpenMP or pure-Python fallback,
  :mod:`magicsoup_tpu_torch.native`) and returns *flat numpy index
  buffers* that feed the cell-parameter assembly; the reference's
  nested-list format is available through
  :meth:`Genetics.translate_genomes`.
"""
import random
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from magicsoup_tpu_torch.analysis import runtime as _runtime
from magicsoup_tpu_torch.constants import CODON_SIZE, ProteinSpecType
from magicsoup_tpu_torch.native import (
    TranslationTables,
    pack_dense,
    translate_genomes_flat,
)
from magicsoup_tpu_torch.telemetry import recorder as _telemetry
from magicsoup_tpu_torch.util import codons


def _get_n(p: float, s: int, name: str) -> int:
    n = int(p * s)
    if n == 0 and p > 0.0:
        warnings.warn(
            f"There will be no {name}."
            f" Increase dom_type_size to accomodate low probabilities of having {name}."
        )
    return n


class Genetics:
    """
    Class holding logic about transcribing and translating nucleotide
    sequences.

    Arguments:
        start_codons: Codons which start a coding sequence.
        stop_codons: Codons which stop a coding sequence.
        p_catal_dom: Chance of encountering a catalytic domain in a random
            nucleotide sequence.
        p_transp_dom: Chance of encountering a transporter domain in a random
            nucleotide sequence.
        p_reg_dom: Chance of encountering a regulatory domain in a random
            nucleotide sequence.
        n_dom_type_codons: Number of codons encoding the domain type.
        seed: Seed for the token-map shuffle (genotype->phenotype mapping).

    A CDS starts at every start codon and ends with the first in-frame stop
    codon; un-stopped CDSs are discarded; both strands are considered.  Each
    CDS is one protein; every matched domain-type sequence inside it adds a
    domain (see `docs/mechanics.md:22-28` of the reference).
    """

    def __init__(
        self,
        start_codons: tuple[str, ...] = ("TTG", "GTG", "ATG"),
        stop_codons: tuple[str, ...] = ("TGA", "TAG", "TAA"),
        p_catal_dom: float = 0.01,
        p_transp_dom: float = 0.01,
        p_reg_dom: float = 0.01,
        n_dom_type_codons: int = 2,
        seed: int | None = None,
    ):
        if any(len(d) != CODON_SIZE for d in start_codons):
            raise ValueError(f"Not all start codons are of length {CODON_SIZE}")
        if any(len(d) != CODON_SIZE for d in stop_codons):
            raise ValueError(f"Not all stop codons are of length {CODON_SIZE}")
        overlap = set(start_codons) & set(stop_codons)
        if len(overlap) > 0:
            raise ValueError(
                "Overlapping start and stop codons:"
                f" {','.join(str(d) for d in overlap)}"
            )
        if p_catal_dom + p_transp_dom + p_reg_dom > 1.0:
            raise ValueError(
                "p_catal_dom, p_transp_dom, p_reg_dom together must not be greater 1.0"
            )

        self.seed = seed
        self.start_codons = list(start_codons)
        self.stop_codons = list(stop_codons)

        # domain structure: type codons + 3 x 1-codon + 1 x 2-codon tokens;
        # a domain can end on the CDS-terminating stop codon, so the minimum
        # CDS size equals dom_size
        self.dom_size = (n_dom_type_codons + 5) * CODON_SIZE
        self.dom_type_size = n_dom_type_codons * CODON_SIZE

        # type sequences containing a start codon are excluded (they would
        # open nested CDSs wherever a domain occurs)
        rng = random.Random(seed)
        sets = codons(n=n_dom_type_codons, excl_codons=self.start_codons)
        rng.shuffle(sets)
        n = len(sets)

        n_catal_doms = _get_n(p=p_catal_dom, s=n, name="catalytic domains")
        n_transp_doms = _get_n(p=p_transp_dom, s=n, name="transporter domains")
        n_reg_doms = _get_n(p=p_reg_dom, s=n, name="allosteric domains")

        # 1=catalytic, 2=transporter, 3=regulatory
        self.domain_types: dict[int, list[str]] = {}
        self.domain_types[1] = sets[:n_catal_doms]
        del sets[:n_catal_doms]
        self.domain_types[2] = sets[:n_transp_doms]
        del sets[:n_transp_doms]
        self.domain_types[3] = sets[:n_reg_doms]
        del sets[:n_reg_doms]

        self.domain_map = {d: k for k, v in self.domain_types.items() for d in v}

        # premature stop codons cannot appear inside a CDS
        self.one_codon_map = {d: i + 1 for i, d in enumerate(self._get_single_codons())}

        # the second codon of a 2-codon token may be the CDS-final stop codon
        self.two_codon_map = {d: i + 1 for i, d in enumerate(self._get_double_codons())}

        # inverse maps for genome generation (factories)
        self.idx_2_one_codon = {v: k for k, v in self.one_codon_map.items()}
        self.idx_2_two_codon = {v: k for k, v in self.two_codon_map.items()}

        # integer lookup tables for the genome engine
        self.tables = TranslationTables(
            start_codons=self.start_codons,
            stop_codons=self.stop_codons,
            domain_map=self.domain_map,
            one_codon_map=self.one_codon_map,
            two_codon_map=self.two_codon_map,
            dom_size=self.dom_size,
            dom_type_size=self.dom_type_size,
        )

    def translate_genomes_flat(
        self, genomes: list[str]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """
        Translate genomes into flat index buffers:
        ``(prot_counts (g,), prots (P,4), doms (D,7))`` with protein rows
        ``[cds_start, cds_end, is_fwd, n_doms]`` and domain rows
        ``[dom_type, i0, i1, i2, i3, start, end]``.  This is the hot path
        feeding :meth:`magicsoup_tpu_torch.kinetics.Kinetics.set_cell_params`.
        """
        return translate_genomes_flat(genomes, self.tables)

    def translate_tokens_flat(
        self, tokens, lengths
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """
        :meth:`translate_genomes_flat` for host token rows (``(b, G)`` int8
        in the ``TCGA`` -> ``0..3`` code of :mod:`magicsoup_tpu_torch.
        genomes`) and their lengths.  The decode is the string boundary:
        device-resident paths reach it only for phenotype-cache misses.
        """
        from magicsoup_tpu_torch.genomes import decode_tokens

        return translate_genomes_flat(decode_tokens(tokens, lengths), self.tables)

    def translate_genomes(self, genomes: list[str]) -> list[list[ProteinSpecType]]:
        """
        Translate all genomes into proteomes.

        Returns a list (per genome) of lists (proteins) where each protein is
        a tuple ``(domains, cds_start, cds_end, is_fwd)`` and each domain is
        ``((dom_type, i0, i1, i2, i3), start, end)`` — the reference's nested
        format (`genetics.py:124-168`), built from the engine's flat buffers.
        """
        if len(genomes) < 1:
            return []
        prot_counts, prots, doms = self.translate_genomes_flat(genomes)
        # batched host conversion: ONE .tolist() per buffer plus numpy
        # cumsum offsets, instead of a per-protein/per-domain .tolist()
        prot_rows = prots.tolist()
        dom_rows = doms.tolist()
        prot_offs = np.concatenate([[0], np.cumsum(prot_counts)]).tolist()
        dom_offs = np.concatenate(
            [[0], np.cumsum(prots[:, 3])] if len(prots) else [[0]]
        ).tolist()
        out: list[list[ProteinSpecType]] = []
        for gi in range(len(genomes)):
            proteome: list[ProteinSpecType] = []
            for pi in range(prot_offs[gi], prot_offs[gi + 1]):
                cds_start, cds_end, is_fwd, n_doms = prot_rows[pi]
                d0 = dom_offs[pi]
                dom_specs = [
                    ((dt, i0, i1, i2, i3), start, end)
                    for dt, i0, i1, i2, i3, start, end in dom_rows[
                        d0 : d0 + n_doms
                    ]
                ]
                proteome.append((dom_specs, cds_start, cds_end, bool(is_fwd)))
            out.append(proteome)
        return out

    def _get_single_codons(self) -> list[str]:
        seqs = codons(n=1)
        return [d for d in seqs if d not in self.stop_codons]

    def _get_double_codons(self) -> list[str]:
        seqs = codons(n=2)
        return [d for d in seqs if d[:CODON_SIZE] not in self.stop_codons]


@dataclass
class PhenotypeEntry:
    """One cached genome phenotype: the flat translation buffers plus the
    packed dense token row per assembly rung it has been packed at."""

    n_prots: int
    max_doms: int  # max domains over this genome's proteins (0 if none)
    prots: np.ndarray  # (n_prots, 4) i32 [cds_start, cds_end, is_fwd, n_doms]
    doms: np.ndarray  # (sum n_doms, 7) i32
    # (p_cap, d_cap) -> (p_cap, d_cap, 5) i16 dense token row
    dense: dict = field(default_factory=dict)


class PhenotypeCache:
    """
    Content-addressed genome -> phenotype cache, LRU-bounded.

    Entries are keyed by the genome STRING (:meth:`lookup`) or by the
    content hash of a token row (:meth:`lookup_tokens`) and hold the flat translation
    buffers plus packed dense token rows per assembly rung, so a batch
    with repeated genomes (spawn bursts from shared seeds, division
    daughters, mutation no-ops) translates and packs each unique genome
    once, and a genome seen in an earlier step skips both entirely.

    Byte-identity contract: cached rows come from the same
    ``pack_dense`` call a cold path would make and are never mutated, so
    cached and uncached parameter assembly are BIT-identical.

    ``maxsize <= 0`` disables cross-call caching: lookups still dedupe
    within the batch, but nothing is retained.  Counters (``hits`` /
    ``misses`` / ``evictions``) count per genome occurrence.
    """

    def __init__(self, genetics: Genetics, maxsize: int = 16384):
        self.genetics = genetics
        self.maxsize = int(maxsize)
        self._entries: OrderedDict[str, PhenotypeEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop all entries (counters are kept)."""
        self._entries.clear()

    def __getstate__(self) -> dict:
        """Pickle WITHOUT the entries (cached rows would bloat a save);
        the restoring process counts the dropped entries in
        ``analysis.runtime.phenotype_cache_stats``, so that the first
        step's misses after a restore are accounted for."""
        state = self.__dict__.copy()
        state["_entries"] = OrderedDict()
        state["_pickle_dropped"] = len(self._entries)
        return state

    def __setstate__(self, state: dict) -> None:
        from magicsoup_tpu_torch.analysis import runtime

        dropped = state.pop("_pickle_dropped", 0)
        self.__dict__.update(state)
        if dropped:
            runtime.note_phenotype_pickle_drops(int(dropped))

    def _translate_misses(self, genomes: list[str]) -> list[PhenotypeEntry]:
        """Translate a batch of cache misses in ONE engine call and
        build their entries."""
        pc, prots, doms = self.genetics.translate_genomes_flat(genomes)
        dom_counts = (
            prots[:, 3] if len(prots) else np.zeros(0, dtype=np.int32)
        )
        p_offs = np.concatenate([[0], np.cumsum(pc)])
        d_offs = np.concatenate([[0], np.cumsum(dom_counts)])
        out: list[PhenotypeEntry] = []
        for i in range(len(genomes)):
            p0, p1 = int(p_offs[i]), int(p_offs[i + 1])
            d0, d1 = int(d_offs[p0]), int(d_offs[p1])
            out.append(
                PhenotypeEntry(
                    n_prots=p1 - p0,
                    max_doms=(
                        int(dom_counts[p0:p1].max()) if p1 > p0 else 0
                    ),
                    prots=np.ascontiguousarray(prots[p0:p1]),
                    doms=np.ascontiguousarray(doms[d0:d1]),
                )
            )
        return out

    # graftlint: hot
    def lookup(self, genomes: list[str]) -> list[PhenotypeEntry]:
        """Entries for ``genomes`` (one per input, duplicates aliased);
        unique misses are translated in ONE engine batch."""
        unique: list[str] = []
        seen: set[str] = set()
        for g in genomes:
            if g not in seen:
                seen.add(g)
                unique.append(g)
        entries: dict[str, PhenotypeEntry] = {}
        misses: list[str] = []
        for g in unique:
            e = self._entries.get(g)
            if e is None:
                misses.append(g)
            else:
                self._entries.move_to_end(g)
                entries[g] = e
        if misses:
            for g, e in zip(misses, self._translate_misses(misses)):
                entries[g] = e
                self._store(g, e)
        n_hits = len(genomes) - len(misses)
        self.hits += n_hits
        self.misses += len(misses)
        _runtime.note_phenotype_cache(hits=n_hits, misses=len(misses))
        _telemetry.count("phenotype.hits", n_hits)
        _telemetry.count("phenotype.misses", len(misses))
        return [entries[g] for g in genomes]

    # graftlint: hot
    def lookup_tokens(self, tokens, lengths, idxs=None, hashes=None) -> list[PhenotypeEntry]:
        """Entries keyed by token-row content hashes
        (:func:`magicsoup_tpu_torch.genomes.token_hashes`) instead of
        genome strings: only cache misses decode their rows (counted by
        ``analysis.runtime.note_genome_decode``), so a device-resident
        world's steady state translates without a string.  ``idxs``
        selects rows (all by default); ``hashes`` skips rehashing."""
        from magicsoup_tpu_torch.analysis import runtime
        from magicsoup_tpu_torch.genomes import decode_tokens, token_hashes

        tokens = np.asarray(tokens)
        lengths = np.asarray(lengths)
        idxs = list(range(len(lengths))) if idxs is None else list(idxs)
        if hashes is None:
            hashes = token_hashes(tokens, lengths, idxs)
        entries: dict[bytes, PhenotypeEntry] = {}
        miss_keys: list[bytes] = []
        miss_rows: list[int] = []
        seen: set[bytes] = set()
        for i, h in zip(idxs, hashes):
            if h in seen:
                continue
            seen.add(h)
            e = self._entries.get(h)
            if e is None:
                miss_keys.append(h)
                miss_rows.append(i)
            else:
                self._entries.move_to_end(h)
                entries[h] = e
        if miss_keys:
            genomes = decode_tokens(tokens[miss_rows], lengths[miss_rows])
            runtime.note_genome_decode(len(miss_rows))
            for h, e in zip(miss_keys, self._translate_misses(genomes)):
                entries[h] = e
                self._store(h, e)
        n_hits = len(hashes) - len(miss_keys)
        self.hits += n_hits
        self.misses += len(miss_keys)
        _runtime.note_phenotype_cache(hits=n_hits, misses=len(miss_keys))
        _telemetry.count("phenotype.hits", n_hits)
        _telemetry.count("phenotype.misses", len(miss_keys))
        return [entries[h] for h in hashes]

    # graftlint: hot
    def dense_rows(
        self, entries: list[PhenotypeEntry], p_cap: int, d_cap: int
    ) -> np.ndarray:
        """Stack the entries' dense token rows at rung ``(p_cap, d_cap)``
        into one (b, p_cap, d_cap, 5) i16 batch; rows not yet packed at
        this rung are packed in ONE engine batch and memoized on their
        entries."""
        key = (int(p_cap), int(d_cap))
        missing: list[PhenotypeEntry] = []
        seen: set[int] = set()
        for e in entries:
            if key not in e.dense and id(e) not in seen:
                seen.add(id(e))
                missing.append(e)
        if missing:
            pc = np.fromiter(
                (e.n_prots for e in missing), dtype=np.int32,
                count=len(missing),
            )
            prots = np.concatenate([e.prots for e in missing])
            doms = np.concatenate([e.doms for e in missing])
            dense = pack_dense(pc, prots, doms, key[0], key[1])
            for i, e in enumerate(missing):
                e.dense[key] = dense[i]
        if not entries:
            return np.zeros((0, key[0], key[1], 5), dtype=np.int16)
        return np.stack([e.dense[key] for e in entries])

    def _store(self, genome: str, entry: PhenotypeEntry) -> None:
        if self.maxsize <= 0:
            return
        self._entries[genome] = entry
        evicted = 0
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
            evicted += 1
        if evicted:
            self.evictions += evicted
            _runtime.note_phenotype_cache(evictions=evicted)
