"""
State carried into the port as numpy arrays: kinetic parameters, token
tables, and a whole world's state exported from another implementation
(e.g. :class:`magicsoup_tpu.world.World`), so that both compute from the
same state.  Takes numpy arrays only; imports neither JAX nor the JAX
package.
"""
import numpy as np
import torch

from magicsoup_tpu_torch.ops.integrate import INT_PARAM_DTYPE, CellParams
from magicsoup_tpu_torch.ops.params import TokenTables

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


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)


def params_from_numpy(d: dict[str, np.ndarray], device) -> CellParams:
    """:class:`CellParams` from a dict keyed by the nine field names."""
    return CellParams(
        **{k: _tensor(d[k], dt, device) for k, dt in _PARAM_DTYPES.items()}
    )


def tables_from_numpy(d: dict[str, np.ndarray], device) -> TokenTables:
    """:class:`TokenTables` from a dict keyed by the eight field names."""
    return TokenTables(
        **{k: _tensor(d[k], dt, device) for k, dt in _TABLE_DTYPES.items()}
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
    are zeroed.
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
    world._cell_molecules = _tensor(cm, torch.float32, world.device)

    src = params_from_numpy(
        {k: np.asarray(v)[:n] for k, v in arrays["params"].items()}, world.device
    )
    kin = world.kinetics
    kin.ensure_capacity(n_cells=cap, n_proteins=src.Ke.shape[1])
    p = src.Ke.shape[1]
    for dst, s in zip(kin.params, src):
        dst.zero_()
        dst[:n, :p] = s
