"""
Genome mutation functions: point mutations and recombinations.

Counterpart of :mod:`magicsoup_tpu.mutations` (the string path): same
semantics and defaults (p=1e-6 per bp, 40% indels of which 66% deletions;
strand breaks at p=1e-7 per bp), same return shape (only changed sequences,
with their input indices).  Backed by the port's copy of the C++/OpenMP
genome engine (Python fallback available); a ``seed`` gives a reproducible
stream, the same one the JAX package draws.
"""
import random

from magicsoup_tpu_torch.native import engine as _engine


def point_mutations(
    seqs: list[str],
    p: float = 1e-6,
    p_indel: float = 0.4,
    p_del: float = 0.66,
    seed: int | None = None,
) -> list[tuple[str, int]]:
    """
    Add point mutations to a list of nucleotide sequences.

    Arguments:
        seqs: nucleotide sequences
        p: probability of a mutation per base pair
        p_indel: probability of any point mutation being an indel
            (vs. a substitution)
        p_del: probability of any indel being a deletion (vs. an insertion)
        seed: optional seed for a reproducible mutation stream

    Returns:
        List of mutated sequences and their indices in `seqs`; sequences
        without any mutation are not returned.
    """
    if seed is None:
        seed = random.SystemRandom().randrange(2**63)
    return _engine.point_mutations(seqs, p=p, p_indel=p_indel, p_del=p_del, seed=seed)


def recombinations(
    seq_pairs: list[tuple[str, str]],
    p: float = 1e-7,
    seed: int | None = None,
) -> list[tuple[str, str, int]]:
    """
    Recombine pairs of nucleotide sequences through random strand breaks
    and random re-joining (length-conserving over each pair).

    Arguments:
        seq_pairs: nucleotide sequence pairs
        p: probability of a strand break per base pair
        seed: optional seed for a reproducible stream

    Returns:
        List of recombined sequence pairs and their indices in `seq_pairs`;
        pairs without any strand break are not returned.
    """
    if seed is None:
        seed = random.SystemRandom().randrange(2**63)
    return _engine.recombinations(seq_pairs, p=p, seed=seed)
