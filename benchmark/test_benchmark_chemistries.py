"""A second chemistry in one process.  The program interns a molecule by
name for the whole process, and upstream's co2_fixing chemistry gives
NADP and ADP other energies than Wood-Ljungdahl's; with the registry of
``conftest.py`` emptied for each test, a Wood-Ljungdahl world and then a
co2_fixing world (41 molecules, 82 signals, stoichiometries up to 8) run
one after another.  The co2_fixing world runs through the driver, the
judge and the limits of ``wl-10k-128.classic``, selecting on X, the
chemistry's carbon currency: it reads ``correct``, and the control and
an altered integrator each miss a limit.  On the CPU at a tiny size;
with a card, at 10,000 cells on 128x128."""
import pytest

from benchmark import readings, run
from benchmark.conftest import TINY_CONFIG, tiny_cell
from benchmark.test_benchmark_control import _assert_separates
from benchmark.test_benchmark_faults import altered

CELL = "wl-10k-128.classic"
#: the cell's configuration on the co2_fixing chemistry
CO2 = {"chemistry": "co2_fixing", "selection_molecule": "X"}
SEEDS = (5, 2**31 + 7)


def _run(overrides: dict, seed: int) -> dict:
    manifest, cell, workload, config = tiny_cell(CELL)
    return run.run_cell(manifest, cell, workload, dict(config, **overrides), seed=seed,
                        seconds=0.3, trace=False, device="cpu")


# per seed, Wood-Ljungdahl and then co2_fixing: the chemistries alternate in one process
@pytest.mark.parametrize("overrides", [{}, CO2], ids=["wood_ljungdahl", "co2_fixing"])
@pytest.mark.parametrize("seed", SEEDS)
def test_each_chemistry_reads_correct(overrides, seed, tiled_integrator):
    res = _run(overrides, seed)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    for k, c in res["checks"].items():
        assert c["value"] <= c["limit"], k


@pytest.mark.parametrize("seed", SEEDS)
def test_co2_fixing_control_misses_a_limit(seed, tiled_integrator):
    _assert_separates(CELL, readings.readings(CELL, seed, 0.3, "cpu", dict(TINY_CONFIG, **CO2)))


@pytest.mark.parametrize("seed", SEEDS)
def test_co2_fixing_altered_integrator_reads_incorrect(seed, tiled_integrator, monkeypatch):
    from magicsoup_tpu_torch.ops import backends

    integrate = backends.integrate

    def broken(name_, X, params, mesh=None):
        return altered(X, integrate(name_, X, params, mesh=mesh))

    monkeypatch.setattr(backends, "integrate", broken)
    res = _run(CO2, seed)
    assert res["correct"] is False and res["failed"] > 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.cuda
def test_co2_fixing_on_the_card(card):
    """At 10,000 cells on 128x128: the program meets the cell's limits,
    the control misses one in every world."""
    results = []
    for seed in (101, 102, 103):
        results += readings.readings(CELL, seed, 3.0, card, CO2)
    _assert_separates(CELL, results)
