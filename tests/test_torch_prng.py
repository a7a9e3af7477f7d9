"""
The port's threefry-2x32 draws against ``jax.random`` (threefry with
``jax_threefry_partitionable``, jax's default): bit-equal for several seeds
and every call shape the pipelined stepper uses — ``PRNGKey``, ``split``
into 2 and 3, ``uniform`` over the row capacity, ``randint`` of spawn
positions — and with a leading axis of per-world keys; and the two
``randint`` cases of the token genome programs, as jax 0.9 computes them:
int8 in [0, 4) (drawn at 32 bits and cast) and int32 with a tensor
``maxval`` (a cut per pair in ``[0, len]``, zero-length rows included),
with jax's clipping and its ``maxval <= minval`` rule.
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


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(8, 64), (64, 256), (3, 7, 5)])
def test_randint_int8_bit_equal(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    ref = jax.random.randint(jk, shape, 0, 4, dtype=jnp.int8)
    assert np.array_equal(_np(ref), prng.randint(tk, shape, 0, 4, torch.int8).numpy())
    # bounds past the int8 range are clipped as jax clips them
    for lo, hi in [(-5, 100), (-300, 300), (0, 128), (7, 7), (9, 2)]:
        ref = jax.random.randint(jk, shape, lo, hi, dtype=jnp.int8)
        assert np.array_equal(_np(ref), prng.randint(tk, shape, lo, hi, torch.int8).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 256, 1000])
def test_randint_tensor_maxval_bit_equal(seed, n):
    lens = np.random.default_rng(seed).integers(0, 2000, n).astype(np.int32)
    lens[::5] = 0  # zero-length rows: [0, 0] holds only 0
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    t = torch.from_numpy(lens).long()
    for maxval in (lens + 1, lens - 3):  # lens - 3 <= 0 gives minval
        ref = jax.random.randint(jk, (n,), 0, jnp.asarray(maxval), dtype=jnp.int32)
        out = prng.randint(tk, (n,), 0, t + int(maxval[0] - lens[0]))
        assert np.array_equal(_np(ref), out.numpy())
    ref = jax.random.randint(jk, (n,), jnp.asarray(-lens), jnp.asarray(lens + 1), dtype=jnp.int32)
    assert np.array_equal(_np(ref), prng.randint(tk, (n,), -t, t + 1).numpy())
    # the full int32 range and a per-world key axis
    ref = jax.random.randint(jk, (n,), -(2**31), 2**31 - 1, dtype=jnp.int32)
    assert np.array_equal(_np(ref), prng.randint(tk, (n,), -(2**31), 2**31 - 1).numpy())
    keys = torch.stack([tk, prng.prng_key(seed + 1)])
    both = prng.randint(keys, (n,), 0, t + 1)
    ref1 = jax.random.randint(jax.random.PRNGKey(seed + 1), (n,), 0, jnp.asarray(lens + 1),
                              dtype=jnp.int32)
    assert np.array_equal(_np(ref1), both[1].numpy())


def test_randint_rejects_other_dtypes():
    with pytest.raises(TypeError, match="int32 or torch.int8"):
        prng.randint(prng.prng_key(0), (4,), 0, 4, torch.int16)


def test_threefry_on_a_cpu_key_needs_no_card():
    # the plain version serves CPU keys; a CUDA key would launch the kernel
    from magicsoup_tpu_torch.ops import cuda_prng

    before = cuda_prng.launches
    prng.uniform(prng.prng_key(1), (33,))
    assert cuda_prng.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_prng.threefry(prng.prng_key(1), 4, pair=False)


@pytest.mark.cuda
def test_threefry_kernel_bit_equal_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from magicsoup_tpu_torch.ops import cuda_prng

    keys = torch.stack([prng.prng_key(s) for s in (0, 7, 2**31 - 1)])
    for shape in [(1,), (255,), (257,), (16, 1000)]:
        before = cuda_prng.launches
        out = prng.random_bits(keys.cuda(), shape)
        assert cuda_prng.launches == before + 1
        assert torch.equal(out.cpu(), prng.random_bits(keys, shape))
    assert torch.equal(prng.split(keys.cuda(), 4).cpu(), prng.split(keys, 4))
