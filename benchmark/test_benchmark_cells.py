"""Every cell runs end to end at a tiny size on the CPU through its
frozen driver and the reference, and its result has the contract's keys."""
import json

import numpy as np

import pytest

from benchmark import run
from benchmark.conftest import tiny_cell

CELLS = [w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(name: str, seed: int, trace: bool) -> dict:
    manifest, cell, workload, config = tiny_cell(name)
    return run.run_cell(manifest, cell, workload, config, seed=seed, seconds=0.5,
                        trace=trace, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, tiled_integrator):
    res = _run(name, 2**31 + 17, trace=False)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    manifest = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in manifest["end_to_end"] if name in m.get("workloads", [name])}
    assert set(res["metrics"]) == want
    for k, c in res["checks"].items():
        assert c["value"] <= c["limit"], k
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_has_per_layer_keys(name, tiled_integrator):
    res = _run(name, 5, trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card: no kernel ran, so no roofline is read
    assert "activity_roofline" not in res["metrics"]
    assert res["metrics"]["world.genome_ms"]["value"] > 0
    assert res["metrics"]["loop.step_ms_p95"]["value"] > 0


def test_p95():
    assert run.p95([float(i) for i in range(101)]) == pytest.approx(95.0)
    assert run.p95([1.0, 2.0]) == pytest.approx(1.95)


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_is_given_the_same_work(name):
    """Where the configuration fixes ``world_seed``, two run seeds give the
    world the same genomes and top-ups; the judged sample follows the seed."""
    from benchmark import worlds
    from benchmark.reference import judge

    _, _, _, config = run.cell_files(name)
    assert "world_seed" in config
    a, b = 2**31 + 3, 7
    for k in (0, 1, 2):
        assert worlds.input_genomes(config, a, k, 4) == worlds.input_genomes(config, b, k, 4)
    assert worlds.input_genomes(config, a, 0, 4) != worlds.input_genomes(config, a, 1, 4)
    pos = np.stack(np.meshgrid(np.arange(config["map_size"]), np.arange(config["map_size"])),
                   -1).reshape(-1, 2)
    judged = [judge.plan(pos, config["map_size"], s).interior for s in (a, b)]
    assert not np.array_equal(*judged)
