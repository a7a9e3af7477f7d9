"""The manifest and every file it names load, found by name."""
import importlib
import json

import pytest

from benchmark import run, worlds
from benchmark.reference import judge

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
CHEMISTRIES = sorted(p.stem for p in (run.HERE / "chemistries").glob("*.json"))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_manifest_keys():
    assert set(MANIFEST) == KEYS
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    cfg = json.loads((run.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    worlds.chemistry_data(cfg["chemistry"])


@pytest.mark.parametrize("name", CELLS)
def test_workload_files(name):
    manifest, cell, workload, _ = run.cell_files(name)
    assert workload["config"] == cell["config"] and workload["traffic"] == cell["traffic"]
    driver = importlib.import_module(f"benchmark.drivers.{workload['driver']}")
    assert hasattr(driver.Driver, "activity_range")
    keys = set(judge.structural_failure())
    assert workload["limits"] and set(workload["limits"]) <= keys
    reported = [m["name"] for m in manifest["end_to_end"]
                if name in m.get("workloads", [name])]
    assert "setup_s" in reported and len(reported) >= 2
    assert any(name in m.get("workloads", [name]) for m in manifest["per_layer"])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert callable(run.metric_reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
    for cell in metric["workloads"]:
        assert cell in CELLS


@pytest.mark.parametrize("name", CHEMISTRIES)
def test_chemistry_is_the_ports_example(name):
    """Each chemistry file equals the port's example module of its name
    (imported into the test's own molecule registry)."""
    CHEMISTRY = importlib.import_module(f"magicsoup_tpu_torch.examples.{name}").CHEMISTRY
    data = worlds.chemistry_data(name)
    assert data["source"].endswith(f"/python/magicsoup/examples/{name}.py")
    assert [m["name"] for m in data["molecules"]] == [m.name for m in CHEMISTRY.molecules]
    for m, d in zip(CHEMISTRY.molecules, data["molecules"]):
        assert (m.energy, m.half_life, m.diffusivity, m.permeability) == (
            d["energy"], d["half_life"], d["diffusivity"], d["permeability"])
    assert data["reactions"] == [[[m.name for m in s], [m.name for m in p]]
                                 for s, p in CHEMISTRY.reactions]
