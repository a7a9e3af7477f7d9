"""
State carried into the port as numpy arrays: kinetic parameters, token
tables, a whole world's state exported from another implementation (e.g.
:class:`magicsoup_tpu.world.World`), and a pipelined stepper's device
state, one world's or a fleet group's stacked one, so that both compute
from the same state.  Takes numpy arrays only; imports neither JAX nor
the JAX package.
"""
import numpy as np
import torch

from magicsoup_tpu_torch.ops.integrate import INT_PARAM_DTYPE, CellParams
from magicsoup_tpu_torch.ops.params import TokenTables
from magicsoup_tpu_torch.util import to_device

_PARAM_DTYPES = {
    "Ke": torch.float32,
    "Kmf": torch.float32,
    "Kmb": torch.float32,
    "Kmr": torch.float32,
    "Vmax": torch.float32,
    "N": INT_PARAM_DTYPE,
    "Nf": INT_PARAM_DTYPE,
    "Nb": INT_PARAM_DTYPE,
    "A": INT_PARAM_DTYPE,
}

_TABLE_DTYPES = {
    "km_weights": torch.float32,
    "vmax_weights": torch.float32,
    "signs": torch.int32,
    "hills": torch.int32,
    "reactions": torch.int32,
    "transports": torch.int32,
    "effectors": torch.int32,
    "mol_energies": torch.float32,
}


def params_from_numpy(d: dict[str, np.ndarray], device) -> CellParams:
    """:class:`CellParams` from a dict keyed by the nine field names."""
    return CellParams(
        **{k: to_device(d[k], device, dt) for k, dt in _PARAM_DTYPES.items()}
    )


def tables_from_numpy(d: dict[str, np.ndarray], device) -> TokenTables:
    """:class:`TokenTables` from a dict keyed by the eight field names."""
    return TokenTables(
        **{k: to_device(d[k], device, dt) for k, dt in _TABLE_DTYPES.items()}
    )


def load_world_arrays(world, arrays: dict) -> None:
    """
    Set a port ``World``'s state from exported arrays:

    - ``molecule_map`` (mols, m, m), ``cell_molecules`` (n, mols);
    - ``cell_positions`` (n, 2), ``cell_lifetimes`` (n,),
      ``cell_divisions`` (n,);
    - ``cell_genomes`` (a list of n strings) and ``cell_labels`` (optional);
    - ``params``: the nine parameter arrays with at least n rows.

    The world's capacity and protein capacity grow to fit; rows past n
    are zeroed.  A mesh-placed world takes the same arrays on every rank,
    and each rank keeps its blocks.
    """
    n = len(arrays["cell_genomes"])
    world.kill_cells()
    world._ensure_capacity(max(n, 1))
    cap = world._capacity

    world.molecule_map = arrays["molecule_map"]
    world.cell_genomes = list(arrays["cell_genomes"])
    world.cell_labels = list(arrays.get("cell_labels", [""] * n))
    world.n_cells = n
    pos = np.asarray(arrays["cell_positions"], dtype=np.int32)
    world._np_positions[:] = 0
    world._np_positions[:n] = pos
    world._np_lifetimes[:] = 0
    world._np_lifetimes[:n] = arrays["cell_lifetimes"]
    world._np_divisions[:] = 0
    world._np_divisions[:n] = arrays["cell_divisions"]
    world._np_cell_map[:] = False
    world._np_cell_map[pos[:, 0], pos[:, 1]] = True
    world._sync_positions()

    cm = np.zeros((cap, world.n_molecules), dtype=np.float32)
    cm[:n] = arrays["cell_molecules"]
    world._cell_molecules = to_device(cm, world.device, torch.float32)

    src = params_from_numpy(
        {k: np.asarray(v)[:n] for k, v in arrays["params"].items()}, world.device
    )
    kin = world.kinetics
    kin.ensure_capacity(n_cells=cap, n_proteins=src.Ke.shape[1])
    p = src.Ke.shape[1]
    # a mesh-placed world: each rank takes the rows of its slot block
    lo, hi = (0, cap) if world._mesh is None else world._mesh.block(cap)
    k = max(min(n, hi) - lo, 0)
    for dst, s in zip(kin.params, src):
        dst.zero_()
        dst[:k, :p] = s[lo : lo + k]


_STATE_DTYPES = {
    "mm": torch.float32,
    "cm": torch.float32,
    "pos": torch.int64,
    "occ": torch.bool,
    "alive": torch.bool,
    "n_rows": torch.int64,
    "key": torch.int64,
}


def device_state_from_numpy(d: dict[str, np.ndarray], device):
    """A :class:`~magicsoup_tpu_torch.stepper.DeviceState` from arrays
    keyed by its seven field names (``mm`` ``(mols, m, m)``, ``cm``,
    ``pos``, ``occ``, ``alive``, ``n_rows`` and the uint32 ``key`` words),
    as one world's stepper holds them or stacked on a leading world axis
    as a fleet group holds them; one world gets a world axis of 1."""
    from magicsoup_tpu_torch.stepper import DeviceState

    solo = np.ndim(d["mm"]) == 3
    out = {}
    for k, dt in _STATE_DTYPES.items():
        arr = np.asarray(d[k])
        if dt == torch.int64:
            arr = arr.astype(np.int64)  # the key words are uint32
        out[k] = to_device(arr[None] if solo else arr, device, dt)
    return DeviceState(**out)
