"""
The port's threefry-2x32 draws against ``jax.random`` (threefry with
``jax_threefry_partitionable``, jax's default): bit-equal for several seeds
and every call shape the pipelined stepper uses — ``PRNGKey``, ``split``
into 2 and 3, ``uniform`` over the row capacity, ``randint`` of spawn
positions — and with a leading axis of per-world keys.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu_torch.ops import prng  # noqa: E402

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert np.array_equal(_np(jk), tk.numpy())
    for num in (2, 3):
        assert np.array_equal(_np(jax.random.split(jk, num)), prng.split(tk, num).numpy())
    # the stepper's chain: key, sub = split(key), repeated
    for _ in range(4):
        jk, jsub = jax.random.split(jk)
        both = prng.split(tk)
        tk, tsub = both[0], both[1]
        assert np.array_equal(_np(jsub), tsub.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 128, 16384])
def test_uniform_bit_equal(seed, n):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert np.array_equal(np.asarray(jax.random.uniform(jk, (n,))), prng.uniform(tk, (n,)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("b,m", [(16, 16), (1024, 128), (3, 7)])
def test_randint_bit_equal(seed, b, m):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    ref = jax.random.randint(jk, (b, 2), 0, m, dtype=jnp.int32)
    assert np.array_equal(_np(ref), prng.randint(tk, (b, 2), 0, m).numpy())


def test_per_world_keys_draw_independently():
    seeds = [3, 4, 5]
    keys = torch.stack([prng.prng_key(s) for s in seeds])
    u = prng.uniform(keys, (64,))
    xy = prng.randint(keys, (16, 2), 0, 16)
    sub = prng.split(keys, 3)
    for w, s in enumerate(seeds):
        jk = jax.random.PRNGKey(s)
        assert np.array_equal(np.asarray(jax.random.uniform(jk, (64,))), u[w].numpy())
        ref = jax.random.randint(jk, (16, 2), 0, 16, dtype=jnp.int32)
        assert np.array_equal(_np(ref), xy[w].numpy())
        assert np.array_equal(_np(jax.random.split(jk, 3)), sub[w].numpy())
