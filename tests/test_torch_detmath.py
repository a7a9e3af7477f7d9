"""
The port's deterministic math (magicsoup_tpu_torch.ops.detmath) against
the JAX package's, on the same numpy inputs: bit-equal.

The JAX package's functions run jitted, as its integrator and assembly
run them; the port's run inside ``flush_denormal``, as its deterministic
paths do (XLA's CPU code flushes subnormals).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu.ops import detmath as jdm  # noqa: E402
from magicsoup_tpu_torch.ops import detmath as tdm  # noqa: E402


def _port(fn, *arrays):
    with tdm.flush_denormal("cpu"):
        return fn(*(torch.from_numpy(a) for a in arrays)).numpy()


def _assert_bits(ref, out):
    ref = np.asarray(ref)
    assert ref.dtype == out.dtype and ref.shape == out.shape
    assert np.array_equal(ref, out, equal_nan=True)


def _floats(seed: int, shape, scale: float) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x * np.float32(scale)


def test_det_exp_bit_equal():
    x = _floats(0, 20000, 40.0)
    # specials, subnormal results and overflow
    x[:8] = [np.inf, -np.inf, np.nan, 0.0, -0.0, -95.0, 89.0, -87.5]
    _assert_bits(jax.jit(jdm.det_exp)(x), _port(tdm.det_exp, x))


def test_det_div_bit_equal():
    a = _floats(1, 20000, 100.0)
    b = _floats(2, 20000, 1e-3)
    b[:5] = [0.0, -0.0, np.inf, 1e-40, np.nan]
    a[5:8] = [1e-40, -3e-39, 0.0]
    _assert_bits(jax.jit(jdm.det_div)(a, b), _port(tdm.det_div, a, b))


@pytest.mark.parametrize("nonneg", [False, True])
def test_ipow_bit_equal(nonneg):
    rng = np.random.default_rng(3)
    x = np.abs(_floats(3, (40, 7, 9), 3.0))
    x[0, 0, :4] = [0.0, 1.0, 1e-20, 1e-40]
    lo = 0 if nonneg else -140
    n = rng.integers(lo, 140, x.shape).astype(np.int16)
    ref = jax.jit(lambda a, b: jdm.ipow(a, b, nonneg=nonneg))(x, n)
    _assert_bits(ref, _port(lambda a, b: tdm.ipow(a, b, nonneg=nonneg), x, n))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sum_axis_bit_equal(axis):
    # non-pow2 widths exercise the identity padding of the tree
    x = _floats(4, (5, 7, 13), 1e3)
    ref = jax.jit(lambda a: jdm.sum_axis(a, axis))(x)
    _assert_bits(ref, _port(lambda a: tdm.sum_axis(a, axis), x))


@pytest.mark.parametrize("axis", [1, 2])
def test_prod_axis_bit_equal(axis):
    x = np.abs(_floats(5, (6, 9, 11), 2.0))
    ref = jax.jit(lambda a: jdm.prod_axis(a, axis))(x)
    _assert_bits(ref, _port(lambda a: tdm.prod_axis(a, axis), x))


def test_tree_reduce_bit_equal():
    x = _floats(6, (3, 10), 5.0)
    ref = jax.jit(lambda a: jdm.tree_reduce(a, 1, jax.numpy.maximum, -np.inf))(x)
    _assert_bits(ref, _port(lambda a: tdm.tree_reduce(a, 1, torch.maximum, -np.inf), x))


def test_sum_hw_bit_equal():
    x = np.abs(_floats(7, (4, 32, 32), 10.0))
    _assert_bits(jax.jit(jdm.sum_hw)(x), _port(tdm.sum_hw, x))


def test_flush_denormal_scope_restores():
    threads = torch.get_num_threads()
    with tdm.flush_denormal("cpu"):
        with tdm.flush_denormal("cpu"):
            assert (torch.tensor([1e-30]) * 1e-10).item() == 0.0
        assert torch.get_num_threads() == 1
    assert torch.get_num_threads() == threads
    assert (torch.tensor([1e-30]) * 1e-10).item() != 0.0
