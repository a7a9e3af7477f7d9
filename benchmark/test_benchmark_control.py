"""The control, the reference computed in bfloat16 and put in the
program's place, fails a limit of every cell; the program itself meets
them.  On the CPU at a tiny size; with a card, at the cells' own size."""
import json

import pytest

from benchmark import readings, run
from benchmark.conftest import TINY_CONFIG

CELLS = [w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _assert_separates(name: str, results: list[dict]) -> None:
    """Through the harness's own comparison: every world of the program
    meets the limits, every world of the control misses one."""
    limits = run.cell_files(name)[2]["limits"]
    assert run.check(results, limits)[1] == 0
    assert run.check(readings.control_readings(results), limits)[1] == len(results)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, tiled_integrator):
    _assert_separates(name, readings.readings(name, 41, 0.3, "cpu", TINY_CONFIG))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, card):
    results = []
    for seed in (101, 102, 103):
        results += readings.readings(name, seed, 3.0, card)
    _assert_separates(name, results)
