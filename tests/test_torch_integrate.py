"""
The port's integrator against the JAX package's, on the same numpy
inputs:

- ``torch-fast`` against ``integrate_signals(det=False)`` and the CUDA
  kernel's plain version (what ``integrate_signals_cuda`` runs on CPU
  tensors) against the Pallas kernel in interpret mode, both under the
  fast contract of tests/fast/test_pallas_integrate.py: the two sides
  differ in the rounding of exp/log and in summation order;
- ``torch-det`` against ``integrate_signals(det=True)``: bit-equal.

The kernel itself needs the card; its check here is marked ``cuda`` and
skips without one (chip_smoke.py runs it at full size).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu.ops.integrate import CellParams as JParams  # noqa: E402
from magicsoup_tpu.ops.integrate import integrate_signals as jintegrate  # noqa: E402
from magicsoup_tpu.ops.pallas_integrate import integrate_signals_pallas  # noqa: E402
from magicsoup_tpu_torch.ops import backends  # noqa: E402
from magicsoup_tpu_torch.ops import cuda_integrate as ci  # noqa: E402
from magicsoup_tpu_torch.ops.integrate import integrate_signals  # noqa: E402
from magicsoup_tpu_torch.interop import params_from_numpy  # noqa: E402


def _assert_fast_contract(out: np.ndarray, ref: np.ndarray) -> None:
    """Finite and >= 0; 99th-percentile relative error < 1e-4; maximum
    < 0.15 (a borderline cell may take a different 0.0625-granular
    equilibrium correction)."""
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    assert rel.max() < 0.15, rel.max()


def _inputs(c: int = 64, p: int = 8, s: int = 12, seed: int = 0):
    """Seeded inputs drawn as performance/pallas_bisect.py draws them."""
    rng = np.random.default_rng(seed)
    d = dict(
        Ke=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmf=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmb=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmr=rng.uniform(0.1, 10, (c, p, s)).astype(np.float32),
        Vmax=rng.uniform(0, 2, (c, p)).astype(np.float32),
        N=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
        Nf=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        Nb=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        A=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
    )
    X = rng.uniform(0, 4, (c, s)).astype(np.float32)
    return X, d


def _edge_inputs():
    """The edge cases in one batch of 64 cells (8 tiles of 8; the shapes
    of ``_inputs``, so the JAX side reuses its compiled programs)."""
    X, d = _inputs(seed=1)
    X[0] = 0.0  # all-zero signals
    d["A"][1] = 0
    d["A"][1, :, 0] = -2  # inhibitor absent: X=0 with A<0 -> active
    X[1, 0] = 0.0
    d["A"][2] = 0
    d["A"][2, :, 0] = 2  # activator absent: X=0 with A>0 -> inactive
    X[2, 0] = 0.0
    for k in d:  # dead rows: all-zero parameters are inert
        d[k][8:16] = 0
    d["N"][16:24, :, 3] = np.abs(d["N"][16:24, :, 3])  # nothing removes signal 3
    return X, d


def _jax(X, d):
    return jnp.asarray(X), JParams(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch(X, d):
    return torch.from_numpy(X), params_from_numpy(d, "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_fast_matches_xla_fast(seed):
    X, d = _inputs(seed=seed)
    ref = np.asarray(jintegrate(*_jax(X, d), det=False))
    out = backends.integrate("torch-fast", *_torch(X, d)).numpy()
    _assert_fast_contract(out, ref)


@pytest.mark.parametrize("which", ["random", "edges"])
def test_torch_det_bit_equal_xla_det(which):
    X, d = _inputs(seed=2) if which == "random" else _edge_inputs()
    ref = np.asarray(jintegrate(*_jax(X, d), det=True))
    out = backends.integrate("torch-det", *_torch(X, d)).numpy()
    assert np.array_equal(ref, out)


@pytest.mark.parametrize("tile_c", [8, 64])
def test_plain_tiled_matches_pallas_interpret(tile_c):
    X, d = _inputs(seed=3)
    ref = np.asarray(integrate_signals_pallas(*_jax(X, d), tile_c=tile_c, interpret=True))
    before = ci.launches
    out = ci.integrate_signals_cuda(*_torch(X, d), tile_c=tile_c).numpy()
    assert ci.launches == before  # CPU tensors never launch the kernel
    _assert_fast_contract(out, ref)


def test_edge_cases_match_pallas_interpret():
    X, d = _edge_inputs()
    ref = np.asarray(integrate_signals_pallas(*_jax(X, d), tile_c=8, interpret=True))
    out = ci.integrate_signals_cuda(*_torch(X, d)).numpy()
    _assert_fast_contract(out, ref)
    # dead rows are inert; an all-zero cell stays finite
    assert np.array_equal(out[8:16], X[8:16])
    assert np.isfinite(out[0]).all()


def test_log_space_edge_semantics():
    # exp of a huge negative sum is exactly 0; overflow saturates to MAX
    from magicsoup_tpu_torch.ops import integrate as ti

    logX = ti._safe_log(torch.tensor([[0.0, float("nan"), float("inf"), 2.0]]))
    assert logX[0, 0] == ti.LOG0 and logX[0, 1] == ti.LOG0
    N = torch.tensor([[[1, 0, 0, 0], [0, 0, 30000, 0]]], dtype=torch.int16)
    pp = ti._prod_pow(logX, N)
    assert pp[0, 0] == 0.0 and pp[0, 1] == torch.tensor(ti.MAX)


def test_tile_table_refuses_non_multiples():
    assert ci.select_tile_c(16) == 8
    assert ci.select_tile_c(10240) == 8
    with pytest.raises(ValueError, match="does not divide"):
        ci.select_tile_c(12)
    X, d = _inputs(c=12)
    with pytest.raises(ValueError, match="does not divide"):
        ci.integrate_signals_cuda(*_torch(X, d))


def test_wrapper_checks_inputs():
    X, d = _inputs(c=16)
    Xt, params = _torch(X, d)
    with pytest.raises(TypeError, match="N must be torch.int16"):
        ci.integrate_signals_cuda(Xt, params._replace(N=params.N.to(torch.int32)))
    with pytest.raises(TypeError, match="X must be torch.float32"):
        ci.integrate_signals_cuda(Xt.double(), params)
    with pytest.raises(ValueError, match="Kmr must be contiguous"):
        kmr = params.Kmr.transpose(1, 2).contiguous().transpose(1, 2)
        ci.integrate_signals_cuda(Xt, params._replace(Kmr=kmr))
    with pytest.raises(ValueError, match="Kmf must have shape"):
        ci.integrate_signals_cuda(Xt, params._replace(Kmf=params.Kmf[:, :4].contiguous()))


def test_backend_resolution(monkeypatch):
    monkeypatch.delenv(backends.ENV_VAR, raising=False)
    assert backends.resolve(device_type="cpu") == ("torch-fast", False)
    assert backends.resolve(device_type="cuda") == ("cuda", False)
    assert backends.resolve(deterministic=True, device_type="cuda") == ("torch-det", False)
    assert backends.resolve("cuda", device_type="cpu") == ("cuda", True)
    with pytest.raises(ValueError, match="not bit-reproducible"):
        backends.resolve("cuda", deterministic=True)
    with pytest.raises(ValueError, match="unknown integrator"):
        backends.resolve("pallas")
    monkeypatch.setenv(backends.ENV_VAR, "torch-det")
    assert backends.resolve(device_type="cuda") == ("torch-det", True)


def test_default_mode_integrate_signals_is_batch_global(monkeypatch):
    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    X, d = _inputs(seed=4)
    out = integrate_signals(*_torch(X, d)).numpy()
    tiled = ci.integrate_signals_tiled(*_torch(X, d), tile_c=64).numpy()
    assert np.array_equal(out, tiled)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    X, d = _inputs(c=1024, p=16, s=28, seed=5)
    Xt = torch.from_numpy(X).cuda()
    params = params_from_numpy(d, "cuda")
    before = ci.launches
    out = ci.integrate_signals_cuda(Xt, params)
    torch.cuda.synchronize()
    assert ci.launches == before + 1
    ref = ci.integrate_signals_tiled(Xt, params, ci.TILE_C)
    _assert_fast_contract(out.cpu().numpy(), ref.cpu().numpy())
