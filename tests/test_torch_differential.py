"""
The port's differential harness (``magicsoup_tpu_torch.check.differential``)
on the CPU:

- the committed golden files of the JAX package
  (``tests/fast/data/golden/differential_seed{11,23}.json``) reproduced by
  every ported det path at every boundary, and ``cuda_k1`` (the CUDA
  backend's plain version here, fast mode) reproducing
  ``differential_pallas_seed11.json``, as
  ``tests/fast/test_check_properties.py`` holds the JAX paths;
- a reference axis: the JAX package's full ``state_digest`` equal to the
  port's at every boundary, in deterministic mode, in one process;
- the paths that wait on other parts of the port raise, naming them.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu.check import differential as jdiff  # noqa: E402
from magicsoup_tpu_torch.check import differential  # noqa: E402

GOLDEN = Path(__file__).parent / "fast" / "data" / "golden"
DET_PATHS = differential.PATHS + differential.FLEET_PATHS + differential.TOKEN_PATHS


def _golden(name: str) -> dict:
    rec = json.loads((GOLDEN / name).read_text())
    assert rec["schema"] == "magicsoup_tpu.check.golden/1"
    assert rec["boundaries"] == list(differential.BOUNDARIES)
    return rec


@pytest.mark.parametrize("path", DET_PATHS)
@pytest.mark.parametrize("golden_file", ["differential_seed11.json", "differential_seed23.json"])
def test_golden_structural_digests(golden_file, path, monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    rec = _golden(golden_file)
    got = differential.run_path(
        path,
        seed=rec["seed"],
        map_size=rec["map_size"],
        n_cells=rec["n_cells"],
        digest_fn=differential.structural_digest,
        device="cpu",
    )
    assert got == rec["structural_digests"]


def test_cuda_k1_reproduces_the_pallas_golden_file(monkeypatch):
    monkeypatch.delenv("MAGICSOUP_TPU_DETERMINISTIC", raising=False)
    rec = _golden("differential_pallas_seed11.json")
    assert rec["path"] == "pallas_k1"
    got = differential.run_path(
        "cuda_k1",
        seed=rec["seed"],
        map_size=rec["map_size"],
        n_cells=rec["n_cells"],
        digest_fn=differential.structural_digest,
        device="cpu",
    )
    assert got == rec["structural_digests"]


@pytest.mark.parametrize("path", ["classic", "k1", "k4", "fleet1", "token_k1"])
def test_state_digests_equal_the_jax_package(path, monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    want = jdiff.run_path(path, seed=11, n_cells=12)
    got = differential.run_path(path, seed=11, n_cells=12, device="cpu")
    assert got == want


def test_run_differential_reports_every_path_equal(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    report = differential.run_differential(
        ("classic", "fleet4", "token_classic"), seed=23, device="cpu"
    )
    assert report["ok"], report["mismatches"]
    assert len(set(map(tuple, report["digests"].values()))) == 1
    assert len(report["digests"]["classic"]) == len(differential.BOUNDARIES)


@pytest.mark.parametrize("path", sorted(differential.NOT_PORTED))
def test_paths_not_ported_raise_naming_their_roadmap_item(path):
    with pytest.raises(ValueError, match=r"ROADMAP A[69]"):
        differential.run_path(path, device="cpu")


def test_unknown_path_raises():
    with pytest.raises(ValueError, match="unknown path"):
        differential.run_path("pallas_k1", device="cpu")


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        differential.run_path("classic")
