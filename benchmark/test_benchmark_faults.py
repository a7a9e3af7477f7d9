"""A run whose timed path is broken underneath reads ``correct`` false.
The harness's look for a card is skipped (``run_cell`` on the CPU); the
program's integrator is broken where it produces its answer, for every
cell: the step returns its state unchanged, half of the batch is left
out, or answers are altered.  (No cell spans chips, so no exchange
between chips can be left out.)  A live cell left on another genome's
parameter row (a stale row) fails the parameter comparison: planted in
the program's phenotype lookup, and as one row alone in a checked step."""
import json

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.conftest import TINY_CONFIG, tiny_cell
from benchmark.drivers import classic

CELLS = [w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def unchanged(X, X1):
    return X.clone()


def half_left_out(X, X1):
    # every other row: the live rows are a prefix of a padded batch
    out = X1.clone()
    out[..., 1::2, :] = X[..., 1::2, :]
    return out


def altered(X, X1):
    out = X1.clone()
    out[..., ::16, :] = out[..., ::16, :] * 1.5
    return out


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_reads_incorrect(name, fault, tiled_integrator, monkeypatch):
    from magicsoup_tpu_torch.ops import backends

    integrate = backends.integrate

    def broken(name_, X, params, mesh=None):
        return fault(X, integrate(name_, X, params, mesh=mesh))

    monkeypatch.setattr(backends, "integrate", broken)
    manifest, cell, workload, config = tiny_cell(name)
    res = run.run_cell(manifest, cell, workload, config, seed=23, seconds=0.3, trace=False,
                       device="cpu")
    assert res["correct"] is False and res["failed"] > 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_faults_change_the_answer():
    X = torch.rand(2, 32, 4)
    X1 = X + 1
    assert torch.equal(unchanged(X, X1), X)
    assert torch.equal(half_left_out(X, X1)[:, 1::2], X[:, 1::2])
    assert not torch.equal(altered(X, X1), X1)


@pytest.mark.parametrize("name", CELLS)
def test_stale_parameter_rows_read_incorrect(name, tiled_integrator, monkeypatch):
    """Each lookup of two or more genomes hands its first genome the last
    one's phenotype: that row's parameters are another genome's."""
    from magicsoup_tpu_torch.genetics import PhenotypeCache

    lookup = PhenotypeCache.lookup

    def stale(self, genomes):
        out = lookup(self, genomes)
        if len(out) > 1 and out[0].n_prots != out[-1].n_prots:
            out = [out[-1]] + out[1:]
        return out

    monkeypatch.setattr(PhenotypeCache, "lookup", stale)
    manifest, cell, workload, config = tiny_cell(name)
    res = run.run_cell(manifest, cell, workload, config, seed=29, seconds=0.3, trace=False,
                       device="cpu")
    assert res["correct"] is False
    params = res["checks"]["params_off_1e-04"]
    assert params["value"] > params["limit"]


def test_one_stale_row_fails_the_check(tiled_integrator):
    """One translated cell on another cell's parameter row, among all the
    rows of a checked step, reads beyond the limit."""
    manifest, cell, workload, config = tiny_cell("wl-10k-128.classic")
    driver = classic.Driver(config, workload, 31, "cpu")
    (s0, s1, counts, plan), = driver.check_states(check_seed=31)
    limits = workload["limits"]
    sound = run.judged([(s0, s1, counts, plan)], config, 31, "cpu")
    assert run.check(sound, limits)[1] == 0
    n_prots = (s0.params["Vmax"] > 0).sum(axis=1)
    i = int(np.argmax(n_prots))
    j = int(np.nonzero(n_prots != n_prots[i])[0][0])
    params = {k: v.copy() for k, v in s0.params.items()}
    for v in params.values():
        v[j] = v[i]
    stale = run.judged([(s0._replace(params=params), s1, counts, plan)], config, 31, "cpu")
    assert stale[0]["params_off_1e-04"] == 1 / stale[0]["params_judged"]
    assert stale[0]["params_judged"] >= TINY_CONFIG["n_cells"] // 2
    assert run.check(stale, limits)[1] == 1
