"""
The port's molecule-map physics against the JAX package's on the same
numpy inputs: diffusion, permeation and degradation, bit-equal in
deterministic mode and under the fast contract in fast mode; diffusion
conserves mass.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu.ops import diffusion as jdiff  # noqa: E402
from magicsoup_tpu_torch.ops import diffusion as tdiff  # noqa: E402

_DIFFUSIVITIES = [0.1, 1.0, 0.0, 0.5, 0.01, 2.0]
_PERMEABILITIES = [0.0, 1.0, 0.3, 0.05, 0.0, 0.7]
_HALF_LIVES = [100_000, 10, 1000, 50, 7, 100_000]


def _fast_contract(out: np.ndarray, ref: np.ndarray) -> None:
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    assert rel.max() < 0.15, rel.max()


def _map(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mm = np.abs(rng.standard_normal((6, 32, 32)).astype(np.float32) + 10.0)
    mm[2, 5:9, 5:9] = 0.0
    mm[3] *= np.float32(1e-3)
    return mm


def test_factor_tables_equal():
    assert np.array_equal(
        jdiff.diffusion_kernels(_DIFFUSIVITIES), tdiff.diffusion_kernels(_DIFFUSIVITIES)
    )
    assert np.array_equal(
        jdiff.permeation_factors(_PERMEABILITIES),
        tdiff.permeation_factors(_PERMEABILITIES),
    )
    assert np.array_equal(
        jdiff.degradation_factors(_HALF_LIVES), tdiff.degradation_factors(_HALF_LIVES)
    )


@pytest.mark.parametrize("det", [True, False])
def test_diffuse_matches_jax(det):
    mm = _map()
    k = jdiff.diffusion_kernels(_DIFFUSIVITIES)
    ref = np.asarray(jdiff.diffuse(jnp.asarray(mm), jnp.asarray(k), det=det))
    out = tdiff.diffuse(torch.from_numpy(mm), torch.from_numpy(k), det=det).numpy()
    if det:
        assert np.array_equal(ref, out)
    else:
        _fast_contract(out, ref)


@pytest.mark.parametrize("det", [True, False])
def test_diffuse_conserves_mass(det):
    mm = _map(1)
    k = torch.from_numpy(tdiff.diffusion_kernels(_DIFFUSIVITIES))
    out = torch.from_numpy(mm)
    for _ in range(5):
        out = tdiff.diffuse(out, k, det=det)
    before = mm.astype(np.float64).sum(axis=(1, 2))
    after = out.numpy().astype(np.float64).sum(axis=(1, 2))
    assert np.allclose(after, before, rtol=1e-5)
    # the undiffusing species keeps its pattern exactly
    assert np.array_equal(out.numpy()[2], mm[2])


@pytest.mark.parametrize("det", [True, False])
def test_permeate_matches_jax(det):
    rng = np.random.default_rng(2)
    cm = rng.uniform(0, 5, (40, 6)).astype(np.float32)
    ext = rng.uniform(0, 5, (40, 6)).astype(np.float32)
    f = jdiff.permeation_factors(_PERMEABILITIES)
    ref = jdiff.permeate(jnp.asarray(cm), jnp.asarray(ext), jnp.asarray(f), det=det)
    out = tdiff.permeate(
        torch.from_numpy(cm), torch.from_numpy(ext), torch.from_numpy(f), det=det
    )
    for a, b in zip(ref, out):
        if det:
            assert np.array_equal(np.asarray(a), b.numpy())
        else:
            _fast_contract(b.numpy(), np.asarray(a))


def test_degrade_bit_equal():
    mm = _map(3)
    cm = np.random.default_rng(3).uniform(0, 5, (40, 6)).astype(np.float32)
    f = jdiff.degradation_factors(_HALF_LIVES)
    ref = jdiff.degrade(jnp.asarray(mm), jnp.asarray(cm), jnp.asarray(f))
    out = tdiff.degrade(torch.from_numpy(mm), torch.from_numpy(cm), torch.from_numpy(f))
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a), b.numpy())
