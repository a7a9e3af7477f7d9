"""
Threefry-2x32 counter-based random numbers: the part of ``jax.random``
that the pipelined stepper and the token genome programs draw from,
bit-equal to
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
- :func:`randint` is ``jax.random.randint(key, shape, lo, hi, dtype)``
  for int32 and int8, with int or tensor bounds: two 32-bit draws folded
  by the span in uint32 arithmetic, as jax's ``_randint`` does (jax 0.9
  draws int8 at 32 bits and casts).

On a CUDA key each hash of counters is one launch of the hand-written
kernel :mod:`~magicsoup_tpu_torch.ops.cuda_prng` (``csrc/threefry.cu``);
on the CPU it is :func:`hash_counters_plain` (:func:`threefry2x32` in
eager int64 ops), the kernel's plain version.  Both give the same
values, so every draw is bit-equal on either device.
"""
import math

import numpy as np
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


def key_words(seed: int) -> np.ndarray:
    """The two words of ``jax.random.PRNGKey(seed)`` as host int64."""
    seed = int(seed)
    return np.array([(seed >> 32) & _M32, seed & _M32], dtype=np.int64)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` int64 tensor, filled word
    by word on its device: no host->device copy, which would synchronize."""
    hi, lo = key_words(seed).tolist()
    key = torch.empty(2, dtype=torch.int64, device=device)
    key[0].fill_(hi)
    key[1].fill_(lo)
    return key


def hash_counters_plain(key: torch.Tensor, shape: tuple[int, ...], pair: bool = False):
    """The threefry kernel's plain version, in eager int64 ops on the
    key's device: the hash of every 64-bit flat index of ``shape`` under
    each key, its two words XORed, ``(*key.shape[:-1], *shape)``, or with
    ``pair`` both words, ``(*key.shape[:-1], *shape, 2)``."""
    n = math.prod(shape)
    lead = tuple(key.shape[:-1])
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1) if pair else b1 ^ b2


def _hash_counters(key: torch.Tensor, shape: tuple[int, ...], pair: bool = False):
    """:func:`hash_counters_plain`'s function: on a CUDA key one launch
    of the threefry kernel, on a CPU key the plain version."""
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("draws of 2**32 or more elements are not supported")
    if key.device.type == "cuda":
        from magicsoup_tpu_torch.ops import cuda_prng

        out = cuda_prng.threefry(key, n, pair)
        return out.reshape(tuple(key.shape[:-1]) + tuple(shape) + ((2,) if pair else ()))
    if key.device.type != "cpu":
        raise ValueError(f"no threefry for device {key.device}")
    return hash_counters_plain(key, shape, pair)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(*lead, num, 2)`` new keys."""
    return _hash_counters(key, (num,), pair=True)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64)."""
    return _hash_counters(key, tuple(shape))


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _where(cond, a, b):
    """``torch.where`` for a tensor condition, a plain choice for a bool."""
    return torch.where(cond, a, b) if isinstance(cond, torch.Tensor) else (a if cond else b)


def _clip(v, lo: int, hi: int):
    return v.clamp(lo, hi) if isinstance(v, torch.Tensor) else min(max(int(v), lo), hi)


def _umod(x, span):
    """Unsigned remainder as XLA defines it: ``x % 0`` is ``x``."""
    return _where(span == 0, x, x % _where(span == 0, 1, span))


def randint(
    key: torch.Tensor,
    shape: tuple[int, ...],
    minval,
    maxval,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype)`` for int32
    and int8, as jax 0.9 computes it: int64 tensors holding the dtype's
    values.  ``minval`` and ``maxval`` are ints or int64 tensors that
    broadcast against ``shape``; ``maxval <= minval`` gives ``minval``.
    A dtype narrower than 32 bits is drawn at 32 bits, its bounds clipped
    to ``[min, max]`` and ``[min, max + 1]``, and the result cast (jax's
    ``randint`` does so to keep the modulus bias small).  Int bounds stay
    host ints: no upload, so a draw on the card never synchronizes."""
    if dtype not in (torch.int32, torch.int8):
        raise TypeError(f"randint draws torch.int32 or torch.int8, not {dtype}")
    info = torch.iinfo(dtype)
    if dtype != torch.int32:
        minval = _clip(minval, info.min, info.max)
        maxval = _clip(maxval, info.min, info.max + 1)
    # jax's _randint at 32 bits: bounds clipped to int32, every step below
    # in uint32 arithmetic that wraps
    i32 = torch.iinfo(torch.int32)
    out_of_range = maxval > i32.max
    minval = _clip(minval, i32.min, i32.max)
    maxval = _clip(maxval, i32.min, i32.max)
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & _M32
    span = _where(maxval <= minval, 1, span)
    span = _where(out_of_range & (maxval > minval), (span + 1) & _M32, span)
    multiplier = _umod(1 << 16, span)
    multiplier = _umod((multiplier * multiplier) & _M32, span)
    offset = (_umod(hi, span) * multiplier) & _M32
    offset = _umod((offset + _umod(lo, span)) & _M32, span)
    # the int32 sum, then the cast to the dtype, each wrapping
    out = ((minval + offset - i32.min) & _M32) + i32.min
    mask = (1 << info.bits) - 1
    return ((out - info.min) & mask) + info.min
