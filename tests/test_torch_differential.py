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
- the fused axis: ``fused2`` reproducing
  ``differential_fused2_seed11.json``, ``fused2`` and ``fused_fleet``
  equal to their solo paths (``k1``, ``k4``) at every boundary and to the
  JAX harness's digests;
- the mesh axis: ``mesh2`` and ``token_mesh2`` (the K=1 stepper over a
  world on a two-rank gloo process group of child processes) reproducing
  the golden files (they are det paths), equal to ``k1`` / ``token_k1``
  at every boundary and to the JAX harness's two-device digests (run in
  a process of their own, ``tests/jax_mesh_reference.py``).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import functools  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu.check import differential as jdiff  # noqa: E402
from magicsoup_tpu_torch.check import differential  # noqa: E402

from jax_mesh_reference import jax_reference  # noqa: E402

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


def test_fused2_reproduces_its_golden_file(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    rec = _golden("differential_fused2_seed11.json")
    assert rec["path"] == "fused2"
    got = differential.run_path(
        "fused2",
        seed=rec["seed"],
        map_size=rec["map_size"],
        n_cells=rec["n_cells"],
        digest_fn=differential.structural_digest,
        device="cpu",
    )
    assert got == rec["structural_digests"]


@pytest.mark.parametrize("fused_path,solo_path", [("fused2", "k1"), ("fused_fleet", "k4")])
def test_fused_paths_equal_their_solo_paths_and_the_jax_harness(
    fused_path, solo_path, monkeypatch
):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    fused = differential.run_path(fused_path, seed=11, n_cells=12, device="cpu")
    solo = differential.run_path(solo_path, seed=11, n_cells=12, device="cpu")
    for name, want, got in zip(differential.BOUNDARIES, solo, fused):
        assert want == got, f"{fused_path} forked from {solo_path} at {name}"
    assert fused == jdiff.run_path(fused_path, seed=11, n_cells=12)


@functools.lru_cache(maxsize=None)
def _jax_mesh_paths() -> dict:
    """The JAX harness's mesh paths on its two-device mesh, in a process
    of their own (``tests/jax_mesh_reference.py``)."""
    paths = differential.MESH_PATHS
    got = jax_reference([["mesh_path", {"path": p, "seed": 11, "n_cells": 12}] for p in paths])
    return dict(zip(paths, got))


@pytest.mark.parametrize(
    "path", ["classic", "k1", "k4", "fleet1", "token_k1", "mesh2", "token_mesh2"]
)
def test_state_digests_equal_the_jax_package(path, monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    if path in differential.MESH_PATHS:
        want = _jax_mesh_paths()[path]
    else:
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


@pytest.mark.parametrize("mesh_path,solo_path", [("mesh2", "k1"), ("token_mesh2", "token_k1")])
def test_mesh_paths_equal_their_solo_paths(mesh_path, solo_path, monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    assert differential.NOT_PORTED == {}
    mesh = differential.run_path(mesh_path, seed=23, n_cells=12, device="cpu")
    solo = differential.run_path(solo_path, seed=23, n_cells=12, device="cpu")
    for name, want, got in zip(differential.BOUNDARIES, solo, mesh):
        assert want == got, f"{mesh_path} forked from {solo_path} at {name}"


def test_unknown_path_raises():
    with pytest.raises(ValueError, match="unknown path"):
        differential.run_path("pallas_k1", device="cpu")


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        differential.run_path("classic")
