"""
Codon maps and genome -> proteome translation, rebuilt from the seed.

Upstream magic-soup 1.0.5 ``genetics.py``: domains of 2 type codons, 3
one-codon scalar tokens and one two-codon vector token (21 nt); a coding
sequence runs from a start codon to the first in-frame stop codon, on
both strands, and every start codon of a frame opens one (nested coding
sequences share their stop).  A protein keeps its domains when at least
one of them is catalytic or a transporter.
"""
import random
from itertools import product

import numpy as np

NTS = "TCGA"
CODON = 3
START_CODONS = ("TTG", "GTG", "ATG")
STOP_CODONS = ("TGA", "TAG", "TAA")
N_TYPE_CODONS = 2
DOM_SIZE = (N_TYPE_CODONS + 5) * CODON
TYPE_SIZE = N_TYPE_CODONS * CODON
P_DOMAIN = 0.01  # catalytic, transporter and regulatory alike

_CODE = np.full(256, 64, dtype=np.int64)
for _i, _nt in enumerate(NTS):
    _CODE[ord(_nt)] = _i
_COMPLEMENT = bytes.maketrans(b"ACTG", b"TGAC")


def _codon_seqs(n: int) -> list[str]:
    """Every sequence of ``n`` codons, in the order the token maps use."""
    return ["".join(p) for p in product(NTS, repeat=n * CODON)]


def _code(seq: str) -> int:
    out = 0
    for c in seq:
        out = out * 4 + NTS.index(c)
    return out


class CodonMaps:
    """The genotype -> token maps that one World seed fixes."""

    def __init__(self, seed: int):
        rng = random.Random(seed)
        banned = set(START_CODONS)
        sets = [
            s for s in _codon_seqs(N_TYPE_CODONS)
            if not any(s[a : a + CODON] in banned for a in range(0, len(s), CODON))
        ]
        rng.shuffle(sets)
        n = int(P_DOMAIN * len(sets))
        self.domain_types = {1: sets[:n], 2: sets[n : 2 * n], 3: sets[2 * n : 3 * n]}
        self.one_codon = {
            c: i + 1 for i, c in enumerate(c for c in _codon_seqs(1) if c not in STOP_CODONS)
        }
        self.two_codon = {
            c: i + 1
            for i, c in enumerate(c for c in _codon_seqs(2) if c[:CODON] not in STOP_CODONS)
        }
        # integer lookups over base-4 codes
        self.flags = np.zeros(64, dtype=np.int64)
        for c in START_CODONS:
            self.flags[_code(c)] = 1
        for c in STOP_CODONS:
            self.flags[_code(c)] = 2
        self.type_lut = np.zeros(4**TYPE_SIZE, dtype=np.int64)
        for t, seqs in self.domain_types.items():
            for s in seqs:
                self.type_lut[_code(s)] = t
        self.one_lut = np.zeros(64, dtype=np.int64)
        for c, i in self.one_codon.items():
            self.one_lut[_code(c)] = i
        self.two_lut = np.zeros(4096, dtype=np.int64)
        for c, i in self.two_codon.items():
            self.two_lut[_code(c)] = i

    @property
    def scalar_tokens(self) -> int:
        return max(self.one_codon.values())

    @property
    def vector_tokens(self) -> int:
        return max(self.two_codon.values())

    def _strand(self, seq: bytes) -> list[list[tuple]]:
        nts = _CODE[np.frombuffer(seq, dtype=np.uint8)]
        if len(nts) < CODON:
            return []
        a, b, c = nts[:-2], nts[1:-1], nts[2:]
        codes = np.where((a > 3) | (b > 3) | (c > 3), -1, a * 16 + b * 4 + c)
        flags = np.where(codes >= 0, self.flags[np.clip(codes, 0, None)], 0)
        codes = codes.tolist()
        proteins = []
        opened: list[list[int]] = [[], [], []]
        for i in np.nonzero(flags)[0].tolist():
            frame = opened[i % CODON]
            if flags[i] == 1:
                frame.append(i)
                continue
            stop = i + CODON
            while frame:
                start = frame.pop()
                if stop - start >= DOM_SIZE:
                    prot = self._domains(codes, start, stop)
                    if prot is not None:
                        proteins.append(prot)
        return proteins

    def _domains(self, codes: list[int], start: int, stop: int):
        doms, useful, i, n = [], False, 0, stop - start
        while i + DOM_SIZE <= n:
            at = start + i
            t0, t1 = codes[at], codes[at + CODON]
            dom_type = int(self.type_lut[t0 * 64 + t1]) if t0 >= 0 and t1 >= 0 else 0
            if dom_type == 0:
                i += CODON
                continue
            useful |= dom_type != 3
            spec = at + TYPE_SIZE
            tok = [int(self.one_lut[codes[spec + k * CODON]]) if codes[spec + k * CODON] >= 0
                   else 0 for k in range(3)]
            c3a, c3b = codes[spec + 3 * CODON], codes[spec + 4 * CODON]
            tok.append(int(self.two_lut[c3a * 64 + c3b]) if c3a >= 0 and c3b >= 0 else 0)
            doms.append((dom_type, *tok))
            i += DOM_SIZE
        return doms if useful else None

    def translate(self, genome: str) -> list[list[tuple]]:
        """Proteins of one genome (forward strand first), each a list of
        ``(dom_type, i0, i1, i2, i3)`` domains."""
        fwd = genome.encode()
        return self._strand(fwd) + self._strand(fwd.translate(_COMPLEMENT)[::-1])


def dense_tokens(proteomes: list[list[list[tuple]]]) -> np.ndarray:
    """Proteomes -> ``(b, p, d, 5)`` int64 tokens, zero-padded."""
    p = max([len(x) for x in proteomes] + [1])
    d = max([len(doms) for x in proteomes for doms in x] + [1])
    out = np.zeros((len(proteomes), p, d, 5), dtype=np.int64)
    for ci, prots in enumerate(proteomes):
        for pi, doms in enumerate(prots):
            if doms:
                out[ci, pi, : len(doms)] = doms
    return out
