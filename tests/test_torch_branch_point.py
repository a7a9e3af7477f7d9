"""
A branch point of the equilibrium correction on real state (ROADMAP.md C),
pinned on one tile of 8 cells that the fleet's first timed step handed the
integrator on the card (NVIDIA H100 80GB HBM3; saved by
``chip_smoke.py --dump``): fleet world 2, rows 6224-6231, with the
kernel's output and its plain version's output there.

Cell 3 sits on the branch point.  The kernel's plain version (fast mode,
tiles of 8) takes one branch; the kernel, the port's det integrator and
every integrator of the JAX package (Pallas in interpret mode, xla-fast,
xla-det) take the other, 0.58 of the cell's largest signal away.  So
``chip_smoke.py`` holds a cell that far from the plain version to the det
integrator run on its tile instead.
"""
from pathlib import Path

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu.ops.integrate import CellParams as JParams  # noqa: E402
from magicsoup_tpu.ops.integrate import integrate_signals as jintegrate  # noqa: E402
from magicsoup_tpu.ops.pallas_integrate import integrate_signals_pallas  # noqa: E402
from magicsoup_tpu_torch.ops import cuda_integrate as ci  # noqa: E402
from magicsoup_tpu_torch.ops.integrate import CellParams, integrate_signals  # noqa: E402

TILE = Path(__file__).parent / "torch_data" / "fleet_branch_point_tile.npz"
BRANCH_CELL = 3


@pytest.fixture(scope="module")
def tile():
    z = np.load(TILE)
    names = CellParams._fields
    X = z["X"]
    return {
        "X": X,
        "np": {k: z[k] for k in names},
        "torch": (torch.from_numpy(X), CellParams(*(torch.from_numpy(z[k]) for k in names))),
        "jax": (jnp.asarray(X), JParams(**{k: jnp.asarray(z[k]) for k in names})),
        "kernel": z["kernel_out"],
        "plain": z["plain_out"],
    }


def _cell_err(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per cell: the largest difference over the cell's largest value in b."""
    return np.abs(a - b).max(axis=1) / np.maximum(np.abs(b).max(axis=1), 1e-6)


def test_plain_version_on_the_cpu_matches_the_cards(tile):
    Xt, params = tile["torch"]
    out = ci.integrate_signals_tiled(Xt, params, ci.TILE_C).numpy()
    assert _cell_err(out, tile["plain"]).max() < 1e-6


def test_branch_point_cell_splits_plain_version_from_the_reference(tile):
    JX, JP = tile["jax"]
    refs = {
        "pallas": np.asarray(integrate_signals_pallas(JX, JP, tile_c=8, interpret=True)),
        "xla-fast": np.asarray(jintegrate(JX, JP, det=False)),
        "xla-det": np.asarray(jintegrate(JX, JP, det=True)),
    }
    others = np.arange(8) != BRANCH_CELL
    for name, ref in refs.items():
        assert _cell_err(tile["plain"], ref)[BRANCH_CELL] > 0.5, name
        assert _cell_err(tile["kernel"], ref)[BRANCH_CELL] < 0.01, name
        assert _cell_err(tile["kernel"], ref)[others].max() < 1e-4, name
    assert _cell_err(tile["kernel"], tile["plain"])[others].max() < 1e-4


def test_det_integrator_on_the_tile_takes_the_kernels_branch(tile):
    Xt, params = tile["torch"]
    det = integrate_signals(Xt, params, det=True).numpy()
    JX, JP = tile["jax"]
    assert np.array_equal(det, np.asarray(jintegrate(JX, JP, det=True)))
    assert _cell_err(tile["kernel"], det)[BRANCH_CELL] < 0.01
    assert _cell_err(tile["plain"], det)[BRANCH_CELL] > 0.5
