"""The genome-size kill of ``co2-10k-128.classic``'s driver
(:mod:`benchmark.drivers.classic_capped`), on the CPU at a tiny size:
planted long genomes die at the hill's rate and 500-bp ones almost
never, the top-up refills the population, and a checked step taken after
planted kills reads ``correct``.  And the integrator's route metric reads
the program's counters, and nothing where there are none."""
import numpy as np
import pytest

from benchmark import program_spans, run, worlds
from benchmark.conftest import tiny_cell
from benchmark.drivers import classic_capped
from benchmark.trace import Trace

CELL = "co2-10k-128.classic"
SIZES = (500, 3000, 4000)


def _driver(seed: int):
    _, _, workload, config = tiny_cell(CELL)
    return classic_capped.Driver(config, workload, seed, "cpu"), config


def _plant(driver, config: dict) -> list[int]:
    """Replace the population by equal thirds of genomes of each of
    :data:`SIZES`; their lengths, in the world's order."""
    w = driver.world
    w.kill_cells()
    n = config["n_cells"] // len(SIZES)
    planted = [g for k, size in enumerate(SIZES)
               for g in worlds.genomes(7 + k, n, size)]
    w.spawn_cells(planted)
    return [len(g) for g in w.cell_genomes[: w.n_cells]]


def _hill(length: float, config: dict) -> float:
    h, k = config["size_kill_hill"], config["size_kill_bp"]
    return length**h / (length**h + k**h)


def test_configuration_states_the_tutorials_kill():
    _, _, workload, config = run.cell_files(CELL)
    assert workload["driver"] == "classic_capped"
    assert (config["size_kill_bp"], config["size_kill_hill"]) == (3000, 7)
    assert config["chemistry"] == "co2_fixing" and config["selection_molecule"] == "X"
    assert config["reduced"] == []


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_size_kill_follows_the_hill(seed, tiled_integrator):
    driver, config = _driver(seed)
    lengths = np.asarray(_plant(driver, config))
    killed = np.zeros(len(lengths))
    draws = 40
    for _ in range(draws):
        killed[driver.size_kill()] += 1
    for size in SIZES:
        at = lengths == size
        rate = killed[at].sum() / (draws * at.sum())
        # 4,000 draws a size: the binomial's standard deviation is at most 0.008
        assert rate == pytest.approx(_hill(size, config), abs=0.04), size
    assert killed[lengths == 500].sum() == 0  # p 3.6e-6 a draw
    driver.close()


@pytest.mark.parametrize("seed", [5, 2**31 + 13])
def test_top_up_refills_after_the_size_kill(seed, tiled_integrator):
    driver, config = _driver(seed)
    _plant(driver, config)
    before = driver.stats()["classic.size_killed"]
    driver._top_up()
    w = driver.world
    assert w.n_cells == config["n_cells"]
    killed = driver.stats()["classic.size_killed"] - before
    n = config["n_cells"] // len(SIZES)
    # of the 4-kb third about 88% die, of the 3-kb third about half
    assert 0.5 * n < killed < 1.6 * n
    assert max(len(g) for g in w.cell_genomes[: w.n_cells]) == 4000
    driver.close()


@pytest.mark.parametrize("seed", [9, 2**31 + 17])
def test_checked_step_after_planted_kills_reads_correct(seed, tiled_integrator):
    driver, config = _driver(seed)
    _plant(driver, config)
    states = driver.check_states(check_seed=seed)
    s0 = states[0][0]
    assert len(s0.pos) == config["n_cells"]
    assert driver.stats()["classic.size_killed"] > 0
    driver.close()
    _, _, workload, _ = tiny_cell(CELL)
    readings = run.judged(states, config, seed, "cpu")
    numbers, failed = run.check(readings, workload["limits"])
    assert failed == 0, numbers


def _run(trace) -> run.Run:
    return run.Run(stats={}, step_gaps=[], trace=trace, trace_steps=4,
                   activity_range="bench:activity", live=[], signals=82)


def test_staged_pct_reads_the_route_counters(monkeypatch):
    trace = Trace(window_s=1.0, busy_s=0.1, n_kernels=3, range_kernels={}, device_ops=[],
                  idle_gaps=[])
    read = run.metric_reader("integrator.staged_pct")
    counters = program_spans.counters
    monkeypatch.setattr(program_spans, "counters", lambda: {
        "integrator.param_bytes": 514048, "integrator.staged_bytes": 176128})
    assert read(_run(trace)) == pytest.approx(100 * 176128 / 514048)
    assert read(_run(None)) is None
    # the CPU launches no kernel, so counts no bytes; a program without
    # the counters reads nothing either
    monkeypatch.setattr(program_spans, "counters", lambda: {"integrator.calls": 4})
    assert read(_run(trace)) is None
    monkeypatch.setattr(program_spans, "counters", counters)
    monkeypatch.setattr(program_spans, "_telemetry", lambda: None)
    assert read(_run(trace)) is None
