"""Shared fixtures of the benchmark's own tests (CPU, tiny sizes)."""
import pytest

#: a cell cut to a size the CPU runs in seconds; the program's tiled
#: integrator, whose early-stop tiles the card's kernel shares
TINY_CONFIG = {"n_cells": 300, "map_size": 24}
TINY_WORKLOAD = {"warmup_steps": 3, "trace_steps": 3}


@pytest.fixture(autouse=True)
def molecule_registry(monkeypatch):
    """An empty registry of the program's molecules for each test, the
    previous one restored after it.  The program interns a molecule by
    name for the whole process and refuses the name again with other
    values, and chemistries disagree on shared molecules (NADP, ADP): so
    each test builds its worlds as a run does, one chemistry in the
    process, and tests of two chemistries run in one process."""
    from magicsoup_tpu_torch.containers import Molecule

    monkeypatch.setattr(Molecule, "_registry", {})


@pytest.fixture
def tiled_integrator(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_TORCH_INTEGRATOR", "cuda")


@pytest.fixture
def card():
    """Skips a test without a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_cell(name: str):
    from benchmark import run

    manifest, cell, workload, config = run.cell_files(name)
    return manifest, cell, dict(workload, **TINY_WORKLOAD), dict(config, **TINY_CONFIG)
