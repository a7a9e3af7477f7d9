"""
Host-side helper utilities: random sequence generation, codon enumeration,
torus geometry, and the one device->host boundary.

Counterpart of :mod:`magicsoup_tpu.util`, with the same seeded helpers
(every stochastic helper takes an optional ``rng``, a ``random.Random``,
and consumes it exactly as the JAX package does, so seeded worlds match).
The compile-warming scheduler and the background fetch workers of the JAX
package have no role here: PyTorch runs eagerly and compiles nothing.
"""
import random
import string
from itertools import product

import numpy as np
import torch

from magicsoup_tpu_torch.constants import ALL_NTS, CODON_SIZE

_DEFAULT_RNG = random.Random()

# 64 URL-safe chars: a power-of-two alphabet makes the byte-mask draw in
# randstr unbiased (256 % 64 == 0), the same C-speed path random_genome uses
_LABEL_CHARS = string.ascii_uppercase + string.ascii_lowercase + string.digits + "-_"
_LABEL_TABLE = bytes(ord(_LABEL_CHARS[b & 63]) for b in range(256))

# template wildcard -> allowed nucleotides; expansion order of each pool is
# what fixes the (token-map-relevant) enumeration order of codons()
_WILDCARDS = {"N": "TCGA", "R": "AG", "Y": "CT"}

# byte -> nucleotide translation table (b & 3 indexes ALL_NTS; 256 % 4 == 0
# keeps the map unbiased): one randbytes + translate per genome
_NT_TABLE = bytes(ord(ALL_NTS[b & 3]) for b in range(256))

_COMPLEMENT = str.maketrans("ACTG", "TGAC")


def randstr(n: int = 12, rng: random.Random | None = None) -> str:
    """Random label string of length ``n`` over 64 characters."""
    rng = rng or _DEFAULT_RNG
    return rng.randbytes(n).translate(_LABEL_TABLE).decode("ascii")


def random_genome(
    s: int = 500, excl: list[str] | None = None, rng: random.Random | None = None
) -> str:
    """
    Random nucleotide sequence of length ``s``.  Sequences in ``excl`` are
    removed (and the genome topped up until it is ``s`` long again); their
    reverse complements may still appear.
    """
    rng = rng or _DEFAULT_RNG

    def draw(k: int) -> str:
        return rng.randbytes(k).translate(_NT_TABLE).decode("ascii")

    if not excl:
        return draw(s)

    def scrub(g: str) -> str:
        for seq in excl:
            g = g.replace(seq, "")
        return g

    out = scrub(draw(s))
    while len(out) < s:
        # appending can create new matches across the seam: re-scrub all
        out = scrub(out + draw(s - len(out)))
    return out


def variants(seq: str) -> list[str]:
    """
    All nucleotide sequences matching a template: ``N`` any nucleotide,
    ``R`` purines (A/G), ``Y`` pyrimidines (C/T).
    """
    pools = [_WILDCARDS.get(c, c) for c in seq]
    return ["".join(chars) for chars in product(*pools)]


def codons(n: int, excl_codons: list[str] | None = None) -> list[str]:
    """
    All sequences of ``n`` codons, optionally excluding sequences that
    contain any codon from ``excl_codons`` at a codon boundary.
    """
    seqs = variants("N" * (n * CODON_SIZE))
    if excl_codons is None:
        return seqs
    banned = set(excl_codons)
    return [
        seq
        for seq in seqs
        if not any(
            seq[a : a + CODON_SIZE] in banned
            for a in range(0, len(seq), CODON_SIZE)
        )
    ]


def reverse_complement(seq: str) -> str:
    """Reverse complement of a DNA sequence (only 'A', 'C', 'T', 'G')"""
    return seq.translate(_COMPLEMENT)[::-1]


def resolve_device(device, owner: str) -> torch.device:
    """The port's device rule: ``None`` means ``"cuda"``, and without a
    CUDA device that is a ``RuntimeError`` naming ``device='cpu'``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{owner}(device=None) runs on CUDA, and no CUDA device is"
                " available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def fetch_host(t) -> np.ndarray:
    """Tensor -> host numpy: the port's one device->host boundary.  On a
    CUDA tensor this is a synchronizing copy."""
    return t.detach().cpu().numpy()


def moore_pairs(positions, map_size: int) -> np.ndarray:
    """Unique Moore-adjacent index pairs (smaller first, sorted ascending
    by encoded pair) among ``(k, 2)`` positions on the torus.  The C++
    occupancy-grid scan when the genome engine is built; otherwise the
    vectorized numpy construction below, which gives the same array."""
    positions = np.asarray(positions)
    k = len(positions)
    if k < 2:
        return np.zeros((0, 2), dtype=np.int64)

    from magicsoup_tpu_torch.native import engine as _engine

    native = _engine.neighbor_pairs(positions, map_size)
    if native is not None:
        return native

    m = map_size
    grid = np.full((m, m), -1, dtype=np.int64)
    grid[positions[:, 0], positions[:, 1]] = np.arange(k)
    dx = np.array([-1, -1, -1, 0, 0, 1, 1, 1])
    dy = np.array([-1, 0, 1, -1, 1, -1, 0, 1])
    nx = (positions[:, 0][:, None] + dx[None, :]) % m
    ny = (positions[:, 1][:, None] + dy[None, :]) % m
    cand = grid[nx, ny]
    src = np.broadcast_to(np.arange(k)[:, None], cand.shape)
    # cand != src guards degenerate torus wraps (map_size <= 2)
    valid = (cand >= 0) & (cand != src)
    a, b = src[valid], cand[valid]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    enc = np.unique(lo * np.int64(k) + hi)
    return np.stack([enc // k, enc % k], axis=1)


def dist_1d(a: int, b: int, m: int) -> int:
    """Distance between `a` and `b` on a circular 1D line of size `m`"""
    d0 = abs(a - b)
    return min(d0, m - d0)


def moores_nghbhd(x: int, y: int, map_size: int) -> list[tuple[int, int]]:
    """The 8 wrapped coordinates of the Moore neighborhood on a torus"""
    e = (x + 1) % map_size
    w = (x - 1) % map_size
    s = (y + 1) % map_size
    n = (y - 1) % map_size
    return [(w, n), (w, y), (w, s), (x, n), (x, s), (e, n), (e, y), (e, s)]


def free_moores_nghbhd(
    x: int, y: int, positions: list[tuple[int, int]], map_size: int
) -> list[tuple[int, int]]:
    """Moore neighbors of ``(x, y)`` not occupied per ``positions``."""
    occupied = set(positions)
    return [d for d in moores_nghbhd(x, y, map_size) if d not in occupied]
