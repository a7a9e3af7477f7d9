"""
Threefry-2x32 counter-based random numbers in torch integer ops: the part
of ``jax.random`` that the pipelined stepper draws from, bit-equal to
jax's ``threefry2x32`` implementation with ``jax_threefry_partitionable``
on (jax's default since 0.5).

A key is an int64 tensor whose last axis holds the two uint32 words of a
jax key (``jax.random.PRNGKey(seed)`` as ``[seed >> 32, seed & 0xFFFFFFFF]``).
Any leading axes are independent keys: the stepper keeps one key per world,
``(B, 2)``, and every draw below returns ``(B, *shape)``.  uint32
arithmetic runs in int64 with ``& 0xFFFFFFFF`` after each add, since
torch's uint32 support is thin.

- :func:`split` is ``jax.random.split(key, num)`` (fold-like split: key i
  is the hash of the 64-bit counter i);
- :func:`random_bits` is the partitionable ``random_bits`` at 32 bits: the
  hash of each element's 64-bit flat index, its two words XORed;
- :func:`uniform` is ``jax.random.uniform(key, shape)`` on [0, 1): the top
  23 bits as the mantissa of a float in [1, 2), minus 1;
- :func:`randint` is ``jax.random.randint(key, shape, lo, hi, int32)``:
  two 32-bit draws folded by the span, as jax's ``_randint`` does.
"""
import math

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) on broadcastable
    uint32-valued int64 tensors: key words ``k1, k2``, counter words
    ``x0, x1``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` int64 tensor."""
    seed = int(seed)
    return torch.tensor(
        [(seed >> 32) & _M32, seed & _M32], dtype=torch.int64, device=device
    )


def _hash_counters(key: torch.Tensor, shape: tuple[int, ...]):
    """Both hash words of every 64-bit flat index of ``shape`` under each
    key: two ``(*key.shape[:-1], *shape)`` tensors."""
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("draws of 2**32 or more elements are not supported")
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(*lead, num, 2)`` new keys."""
    b1, b2 = _hash_counters(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64)."""
    b1, b2 = _hash_counters(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def randint(
    key: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)`` for
    Python-int bounds with ``minval < maxval``: int64 values."""
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & _M32
    multiplier = (2**16) % span
    multiplier = (multiplier * multiplier) % span
    offset = ((hi % span) * multiplier) & _M32
    offset = ((offset + lo % span) & _M32) % span
    return offset + minval
