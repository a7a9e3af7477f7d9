"""
The port's integrator microbenchmark
(``magicsoup_tpu_torch/performance/integrator_bench.py``) on the CPU at a
tiny shape: its input draw equals the JAX bench's
(``performance/integrator_bench.py:73-95``), and it prints one
well-formed JSON row per (backend, world count) point.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from magicsoup_tpu_torch.performance import integrator_bench as ib  # noqa: E402

ROW_KEYS = {
    "integrator_point", "backend_name", "fleet_b", "metric", "unit", "value",
    "ms_per_step", "shape", "backend", "device",
}


def _jax_draw(c, p, s, occupancy):
    """The JAX bench's draw, as written there (params as a dict)."""
    rng = np.random.default_rng(0)
    live = rng.random(c) < occupancy

    def cp(lo, hi):
        a = rng.uniform(lo, hi, (c, p)).astype(np.float32)
        a[~live] = 0.0
        return jnp.asarray(a)

    int_np = np.int16
    N = rng.integers(-2, 3, (c, p, s)).astype(int_np)
    N[~live] = 0
    Nf = np.where(N < 0, -N, 0).astype(int_np)
    Nb = np.where(N > 0, N, 0).astype(int_np)
    params = dict(
        Ke=cp(0.1, 10.0), Kmf=cp(0.5, 5.0), Kmb=cp(0.5, 5.0),
        Kmr=jnp.zeros((c, p, s), dtype=jnp.float32),
        Vmax=cp(0.0, 10.0),
        N=jnp.asarray(N), Nf=jnp.asarray(Nf), Nb=jnp.asarray(Nb),
        A=jnp.zeros((c, p, s), dtype=jnp.int16),
    )
    X = jnp.asarray(rng.uniform(0.0, 5.0, (c, s)).astype(np.float32))
    return X, params


def test_draw_equals_the_jax_benchs():
    X, d = ib.draw_inputs(64, 4, 6, 0.75)
    jX, jd = _jax_draw(64, 4, 6, 0.75)
    assert np.array_equal(X, np.asarray(jX))
    assert d.keys() == jd.keys()
    for name, arr in d.items():
        ref = np.asarray(jd[name])
        assert arr.dtype == ref.dtype and np.array_equal(arr, ref), name
    # a quarter of the rows are dead: all-zero parameters
    dead = ~d["Vmax"].any(1)
    assert 0 < dead.sum() < 64 and not d["N"][dead].any() and not d["Ke"][dead].any()


def test_bench_prints_one_row_per_point(capsys):
    argv = ["--device", "cpu", "--cells", "64", "--proteins", "4", "--signals", "6",
            "--chain", "2", "--reps", "1", "--fleet-b", "1,2"]
    assert ib.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("param bytes/step (1x read):")
    assert any(line.startswith("max |cuda - torch-fast| after 2 steps:") for line in out)
    rows = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["integrator_point"] for r in rows] == [
        "cuda.B1", "cuda.B2", "torch-fast.B1", "torch-fast.B2"
    ]
    for row in rows:
        assert set(row) == ROW_KEYS
        assert row["metric"] == "integrator_ms_per_step[c=64,p=4,s=6,chain=2]"
        assert row["unit"] == "ms" and row["shape"] == [64, 4, 6]
        assert row["value"] == row["ms_per_step"] > 0
        assert row["device"] == "cpu" and row["backend"] == "cpu"


def test_a_failing_point_fails_the_run(capsys, monkeypatch):
    real = ib.backends.integrate

    def integrate(name, X, params):
        if X.ndim == 3 and X.shape[0] > 1:
            raise RuntimeError("no batched worlds today")
        return real(name, X, params)

    monkeypatch.setattr(ib.backends, "integrate", integrate)
    argv = ["--device", "cpu", "--cells", "16", "--proteins", "2", "--signals", "3",
            "--chain", "1", "--reps", "1", "--backend", "torch-fast", "--fleet-b", "1,2"]
    assert ib.main(argv) == 1
    out = capsys.readouterr().out
    assert "grid torch-fast.B2: FAILED RuntimeError: no batched worlds today" in out
    assert [json.loads(line)["integrator_point"] for line in out.splitlines()
            if line.startswith("{")] == ["torch-fast.B1"]
