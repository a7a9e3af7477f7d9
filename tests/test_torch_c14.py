"""
The token programs' device operands are filled on the device (ROADMAP
C14): ``genomes._scalar`` (a rate as a float32 operand), ``prng.prng_key``
(a threefry key) and the recombination program's ``changed`` mask.  Each
was a host->device copy, which synchronizes on the card; each is now a
fill on the device with the same bits:

- ``_scalar`` and ``prng_key`` equal the ``torch.tensor`` constructions
  they replace, bit for bit, over rates and seeds;
- both run with ``torch.tensor`` patched to raise;
- the recombination program writes its ``changed`` mask with
  ``index_fill_``, no ``index_put_`` (an advanced-index write of a Python
  scalar, which torch makes on the host and copies over), and the mask
  is the same as the old writes give.
"""
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from magicsoup_tpu_torch import genomes
from magicsoup_tpu_torch.ops import prng

RATES = [1e-4, 1e-6, 1e-30, 0.4, 0.66, float(np.log1p(-1e-7)), float(np.log1p(-1e-4))]
SEEDS = [0, 1, 2**32 - 1, 2**63 - 1]


@pytest.mark.parametrize("rate", RATES)
def test_scalar_bits_equal_the_host_copy(rate):
    got = genomes._scalar(rate, torch.device("cpu"))
    want = torch.tensor(np.float32(rate))
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape == ()
    assert got.view(torch.int32).item() == want.view(torch.int32).item()


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_bits_equal_the_host_copy(seed):
    got = prng.prng_key(seed, torch.device("cpu"))
    want = torch.tensor(prng.key_words(seed), dtype=torch.int64)
    assert got.dtype == torch.int64 and got.shape == (2,)
    assert torch.equal(got, want)
    # both words below 2**32, as jax's uint32 key words
    assert ((got >= 0) & (got < 2**32)).all()


def test_no_torch_tensor_on_the_device_operands(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.tensor copies host data over")

    cpu = torch.device("cpu")
    want_scalar = torch.tensor(np.float32(1e-6))
    want_key = torch.tensor(prng.key_words(2**40 + 5), dtype=torch.int64)
    # the token programs' key keeps the seed's low 32 bits, as jax's does
    want_low = torch.tensor(prng.key_words(5), dtype=torch.int64)
    monkeypatch.setattr(torch, "tensor", refuse)
    assert torch.equal(genomes._scalar(1e-6, cpu), want_scalar)
    assert torch.equal(prng.prng_key(2**40 + 5, cpu), want_key)
    assert torch.equal(genomes._as_key(2**40 + 5, cpu), want_low)


class _OpSpy(TorchDispatchMode):
    """Records each aten op run and the line of ``genomes.py`` it came from."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        line = next((f.line for f in reversed(traceback.extract_stack())
                     if f.filename.endswith("magicsoup_tpu_torch/genomes.py")), None)
        self.calls.append((func.overloadpacket.__name__, line, args))
        return func(*args, **(kwargs or {}))


def _recombination_inputs():
    rng = np.random.default_rng(3)
    cap, g = 16, 64
    lengths = rng.integers(10, g, cap).astype(np.int32)
    tokens = rng.integers(0, 4, (cap, g)).astype(np.int8)
    tokens[np.arange(g)[None, :] >= lengths[:, None]] = genomes.PAD
    pairs = np.array([[0, 1], [2, 3], [1, 4], [5, 6], [7, 8], [9, 10]], dtype=np.int32)
    return torch.from_numpy(tokens), torch.from_numpy(lengths), pairs


def test_recombination_changed_mask_is_a_device_fill():
    tokens, lengths, pairs = _recombination_inputs()
    with _OpSpy() as spy:
        out_t, out_l, changed = genomes.recombinations_tokens(tokens, lengths, pairs, p=0.05,
                                                              seed=11)
    puts = [line for op, line, _ in spy.calls if op == "index_put_" and "changed" in line]
    fills = [(line, args) for op, line, args in spy.calls if op == "index_fill_"]
    assert puts == []
    assert [line for line, _ in fills] == ["changed.index_fill_(0, row_a, True)",
                                           "changed.index_fill_(0, row_b, True)"]
    # the mask the advanced-index writes gave, from the same rows
    cap = tokens.shape[0]
    old = torch.zeros(cap + 1, dtype=torch.bool)
    for _, args in fills:
        old[args[2]] = True
    assert torch.equal(changed, old[:cap])
    # at least one pair fired at this rate; only rows of pairs changed
    assert changed.any()
    moved = (out_l != lengths) | (out_t != tokens).any(dim=1)
    assert not (moved & ~changed).any()
    assert set(np.flatnonzero(changed.numpy())) <= set(pairs.ravel().tolist())
