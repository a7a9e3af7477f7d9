"""
The port's integrator ladder (``ops/cuda_bisect.py``,
``performance/kernel_bisect.py``) against the JAX package's
(``performance/pallas_bisect.py``), on the ladder's own inputs:

- each rung's plain version against the same expression in JAX on the
  CPU, under the rung's contract: rungs 1-8 against the ``jnp`` rung
  bodies, 9-11 against ``_velocities`` / ``_integrate_part(det=False,
  mosaic_safe=True)`` per 8-cell tile, 12-13 against
  ``integrate_signals_pallas`` in interpret mode at tile 8;
- the ladder draws the JAX ladder's inputs, rung 11's plain version is
  the integrator kernel's plain version bit for bit, the ladder refuses a
  tile other than 8, and on the CPU it runs every rung and fails as a
  whole, not at the first rung, when one rung raises.

The kernels need the card; their check here is marked ``cuda`` and skips
without one (chip_smoke.py runs the ladder at full size).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
import operator  # noqa: E402
from functools import reduce  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu.constants import MAX  # noqa: E402
from magicsoup_tpu.ops.integrate import CellParams as JParams  # noqa: E402
from magicsoup_tpu.ops.integrate import _integrate_part, _safe_log, _velocities  # noqa: E402
from magicsoup_tpu.ops.pallas_integrate import integrate_signals_pallas  # noqa: E402
from magicsoup_tpu_torch.interop import params_from_numpy  # noqa: E402
from magicsoup_tpu_torch.ops import cuda_bisect as cb  # noqa: E402
from magicsoup_tpu_torch.ops import cuda_integrate as ci  # noqa: E402
from magicsoup_tpu_torch.performance import kernel_bisect as kb  # noqa: E402

C, P, S = 256, 8, 12


def _jax_draw(c, p, s):
    """``performance/pallas_bisect.py:75-88``, as written there."""
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.uniform(0, 4, (c, s)).astype(np.float32))
    int_np = np.int16
    params = JParams(
        Ke=jnp.asarray(rng.uniform(0.1, 10, (c, p)).astype(np.float32)),
        Kmf=jnp.asarray(rng.uniform(0.1, 10, (c, p)).astype(np.float32)),
        Kmb=jnp.asarray(rng.uniform(0.1, 10, (c, p)).astype(np.float32)),
        Kmr=jnp.asarray(rng.uniform(0.1, 10, (c, p, s)).astype(np.float32)),
        Vmax=jnp.asarray(rng.uniform(0, 2, (c, p)).astype(np.float32)),
        N=jnp.asarray(rng.integers(-2, 3, (c, p, s)).astype(int_np)),
        Nf=jnp.asarray(rng.integers(0, 3, (c, p, s)).astype(int_np)),
        Nb=jnp.asarray(rng.integers(0, 3, (c, p, s)).astype(int_np)),
        A=jnp.asarray(rng.integers(-2, 3, (c, p, s)).astype(int_np)),
    )
    return X, params


def _tiled(fn, X, q):
    """``fn`` on each tile of 8 cells (its early stop per tile)."""
    t = lambda a: a.reshape((a.shape[0] // 8, 8) + a.shape[1:])  # noqa: E731
    out = jax.vmap(fn)(t(X), JParams(*(t(a) for a in q)))
    return out.reshape(X.shape)


def _jax_rung(r, X, q):
    """The JAX ladder's rung ``r`` on the whole batch."""
    f32 = jnp.float32
    if r == 1:
        return X * 1.000001
    if r == 2:
        return X + jnp.sum(q.N.astype(f32), axis=1)
    if r == 3:
        return jnp.exp(jnp.log(X + 1.0)) - 1.0
    if r in (4, 5):
        e = jnp.sum(q.N.astype(f32) * _safe_log(X)[:, None, :], axis=2)
        if r == 4:
            return e
        xx = jnp.exp(e)
        return jnp.where(jnp.isinf(xx), MAX, xx)
    if r == 6:
        return jnp.sum(jnp.power(X[:, None, :] + 1.0, q.A.astype(f32)), axis=2)
    if r == 7:
        return reduce(operator.mul, [X[:, i] for i in range(X.shape[1])])[:, None] + 0.0 * X
    if r == 8:
        return jnp.prod(X, axis=1, keepdims=True) + 0.0 * X
    if r == 9:
        def body(X_, q_):
            V = _velocities(X_, q_.Vmax, q_, det=False, mosaic_safe=True)
            return X_ + jnp.sum(q_.N.astype(f32) * V[:, :, None], axis=1)
        return _tiled(body, X, q)
    if r in (10, 11):
        trims = (0.7,) if r == 10 else (0.7, 0.2, 0.1)

        def body(X_, q_):
            for trim in trims:
                X_ = _integrate_part(
                    X_, jnp.clip(q_.Vmax * trim, min=0.0), q_, det=False, mosaic_safe=True
                )
            return X_
        return _tiled(body, X, q)
    if r == 12:
        scale = 1.0 + 0.5 * jnp.arange(kb.BATCH, dtype=f32)
        pb = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (kb.BATCH,) + a.shape), q)
        return integrate_signals_pallas(X[None] * scale[:, None, None], pb, tile_c=8, interpret=True)
    return integrate_signals_pallas(X, q, tile_c=8, interpret=True)


@pytest.fixture(scope="module")
def ladder():
    X_np, d = kb.draw_inputs(C, P, S)
    X = torch.from_numpy(X_np)
    params = params_from_numpy(d, "cpu")
    return X, params, kb.steps(X, params), _jax_draw(C, P, S)


@pytest.mark.parametrize("rung", range(1, 14))
def test_plain_rung_holds_the_jax_rung(ladder, rung):
    X, params, steps, (jX, jq) = ladder
    step = steps[rung]
    before = cb.launches, ci.launches
    out = step.kernel()  # on CPU tensors: the plain version, no launch
    if step.streamed is not None:  # rungs that stage a group: 2, 4-6, 9-11
        assert cb.group_bits(rung) and torch.equal(step.streamed(), out)
    assert (cb.launches, ci.launches) == before
    assert torch.equal(out, step.plain())
    ref = torch.from_numpy(np.asarray(_jax_rung(rung, jX, jq)))
    assert out.shape == ref.shape
    ok, err = cb.holds(step.contract, out, ref, step.denom(ref))
    assert ok, (step.contract, err)


def test_ladder_draws_the_jax_ladders_inputs():
    X_np, d = kb.draw_inputs(64, 4, 6)
    jX, jq = _jax_draw(64, 4, 6)
    assert np.array_equal(X_np, np.asarray(jX))
    for name, arr in d.items():
        ref = np.asarray(getattr(jq, name))
        assert arr.dtype == ref.dtype and np.array_equal(arr, ref), name


def test_rung_11_plain_is_the_integrators_plain_version(ladder):
    X, params, steps, _ = ladder
    ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)
    assert torch.equal(cb.plain_rung(11, X, params), ref)


def test_rung_4_error_is_relative_to_its_terms(ladder):
    # the sum over signals cancels: results far below their terms
    X, params, _, _ = ladder
    ref = cb.plain_rung(4, X, params)
    terms = cb.scale(4, X, params, ref)
    assert (terms >= ref.abs()).all() and (ref.abs() < 1e-3 * terms).any()


def test_run_rung_checks_its_inputs(ladder):
    X, params, _, _ = ladder
    with pytest.raises(TypeError, match="N must be torch.int16"):
        cb.run_rung(2, X, params._replace(N=params.N.to(torch.int32)))
    with pytest.raises(ValueError, match="does not divide"):
        cb.run_rung(1, X[:12].contiguous(), params)
    with pytest.raises(ValueError, match="A must be contiguous"):
        cb.run_rung(6, X, params._replace(A=params.A.transpose(1, 2).contiguous().transpose(1, 2)))
    with pytest.raises(ValueError, match="no ladder rung 12"):
        cb.run_rung(12, X, params)
    # rungs read only what they need: a wrong Kmr does not concern rung 3
    cb.run_rung(3, X, params._replace(Kmr=params.Kmr.double()))


@pytest.mark.parametrize("rung", range(1, 12))
def test_rung_reads_only_what_it_declares(ladder, rung):
    # the ladder counts a rung's bytes from its declared reads: changing
    # any other parameter tensor must not change its result
    X, params, steps, _ = ladder
    reads = cb.RUNGS[rung].reads
    other = cb.CellParams(*(
        t if name in reads else (t + 1 if t.is_floating_point() else t.flip(0))
        for name, t in zip(cb.ALL_PARAMS, params)
    ))
    assert torch.equal(cb.plain_rung(rung, X, other), cb.plain_rung(rung, X, params))
    assert steps[rung].n_bytes == kb._nbytes(X, *(getattr(params, n) for n in reads)) + (
        cb.out_shape(rung, X, params)[0] * cb.out_shape(rung, X, params)[1] * 4
    )
    # the kernel stages only the launch plan's groups that the rung reads,
    # wherever the card's shared memory lets the plan stage them
    bits = cb.group_bits(rung)
    assert all(cb.GROUP_BIT[n] & bits for n in reads)
    for limit in (ci.SMEM_LIMIT, ci.smem_bytes(P, S, bits), ci.smem_bytes(P, S, 0)):
        how = ci.plan(P, S, limit, bits)
        staged = {n for n in cb.ALL_PARAMS if cb.GROUP_BIT[n] & how.mask}
        assert how.mask & ~bits == 0 and how.smem_bytes == ci.smem_bytes(P, S, how.mask)
        # a staged group of (p,) rows whose tensor the rung does not read
        # (rung 9's Ke) is passed as a null pointer and not copied
        assert staged - set(reads) <= ({"Ke"} if rung == 9 else set())
    assert ci.plan(P, S, ci.SMEM_LIMIT, bits).mask == bits  # all fit at the ladder's shape
    if rung == 9:
        assert "Ke" not in reads and len(reads) == 8
    if rung >= 10:
        # the trim passes' equilibrium correction reads Ke (on the drawn
        # Vmax of at most 2 no velocity is large enough for it to act)
        fast = params._replace(Vmax=params.Vmax * 100)
        bumped = fast._replace(Ke=fast.Ke * 1e-3)
        assert not torch.equal(cb.plain_rung(rung, X, bumped), cb.plain_rung(rung, X, fast))


def test_ladder_refuses_another_tile():
    with pytest.raises(SystemExit) as exc:
        kb.main(["--device", "cpu", "--tile-c", "16"])
    assert exc.value.code == 2


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])["kernel_bisect"]


def test_ladder_on_the_cpu_runs_every_rung(capsys, monkeypatch):
    assert kb.main(["--device", "cpu", "--cells", "16", "--proteins", "3", "--signals", "5"]) == 0
    got = _summary(capsys.readouterr().out)
    assert got["ok"] and got["device"] == "cpu"
    assert [row["rung"] for row in got["rungs"]] == list(range(1, 14))

    plain = cb.plain_rung

    def broken(rung, X, params):
        if rung == 5:
            raise RuntimeError("rung 5 broke")
        return plain(rung, X, params)

    monkeypatch.setattr(cb, "plain_rung", broken)
    assert kb.main(["--device", "cpu", "--cells", "16", "--proteins", "3", "--signals", "5"]) == 1
    out = capsys.readouterr().out
    assert "rung  5 FAIL" in out and "rung 5 broke" in out
    got = _summary(out)
    assert [row["rung"] for row in got["rungs"] if not row["ok"]] == [5]
    assert len(got["rungs"]) == 13


def test_library_name_follows_included_headers(tmp_path):
    from magicsoup_tpu_torch import _build

    # both kernels' sources include the integrator body's header
    for src in (cb.SRC, ci.SRC):
        names = {p.name for p in _build.source_closure(src)}
        assert names == {src.name, "integrate_body.cuh"}
    (tmp_path / "sub").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include "sub/a.cuh"\n#include <cuda_runtime.h>\n#include "missing.h"\n')
    (tmp_path / "sub" / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "sub" / "b.cuh").write_text("int b;\n")
    cmd = ["nvcc", "-O3"]
    first = _build.library_path("libk", src, cmd)
    assert _build.library_path("libk", src, cmd) == first
    (tmp_path / "sub" / "b.cuh").write_text("int b2;\n")  # a header of a header
    second = _build.library_path("libk", src, cmd)
    assert second != first
    assert _build.library_path("libk", src, cmd + ["-g"]) != second
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("libk", src, cmd) != second


@pytest.mark.cuda
def test_ladder_kernels_hold_their_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ladder's kernels have no CPU mode")
    rows, ok = kb.run_ladder(256, 8, 12, device="cuda", log=lambda line: None)
    assert ok, [row for row in rows if not row["ok"]]
    assert rows[10]["bit_equal_to_integrator"]
