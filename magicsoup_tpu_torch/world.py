"""
The World: the main API object holding all simulation state and the methods
advancing it — the classic ``World`` of :mod:`magicsoup_tpu.world`, in
PyTorch.

Same surface for what the canonical workload uses (spawn/divide/update/
kill cells, enzymatic_activity, degrade/diffuse molecules,
increment_cell_lifetimes, mutate/recombinate) and the same index
semantics: cells are dense indices 0..n_cells-1, kill compacts and shifts
indices, molecules are ordered as in :class:`Chemistry`.

- **capacity pools**: device tensors are allocated at a power-of-two slot
  capacity (>= 64) and grown amortized; kill is a permutation gather
  (stable compaction), divide/spawn write rows.
- **host/device split**: genome strings, labels, positions, the boolean
  cell map, lifetimes and divisions live on the host (numpy / lists); the
  molecule map, intracellular molecules, a mirror of the positions and
  all kinetic parameter tensors live on ``device``.
- **explicit seeding**: one ``seed`` drives placement, token maps and
  mutations, drawn from ``random.Random(seed)`` and
  ``np.random.default_rng(seed)`` in the JAX package's order, so a port
  world and a JAX world from one seed take the same decisions.

The molecule tensors are replaced, never written in place, by every step
(the JAX package's arrays are immutable, and the host snapshots below are
cached by tensor identity).  Parameter rows are written in place.
"""
import random
from contextlib import nullcontext

import numpy as np
import torch

from magicsoup_tpu_torch.containers import Chemistry
from magicsoup_tpu_torch.genetics import Genetics, PhenotypeCache
from magicsoup_tpu_torch.kinetics import Kinetics
from magicsoup_tpu_torch.native import engine as _engine
from magicsoup_tpu_torch.ops import backends as _backends
from magicsoup_tpu_torch.ops import diffusion as _diff
from magicsoup_tpu_torch.ops.detmath import flush_denormal
from magicsoup_tpu_torch.ops.integrate import CellParams, default_deterministic
from magicsoup_tpu_torch.ops.params import compact_rows, pad_pow2, quantize_rows
from magicsoup_tpu_torch.util import fetch_host, moore_pairs, randstr, resolve_device

_MIN_CAPACITY = 64


# --------------------------------------------------------------------- #
# device-state programs (slot-capacity tensors, in PyTorch)             #
# --------------------------------------------------------------------- #


def _map_add(molecule_map, xs, ys, values):
    """``molecule_map.at[:, xs, ys].add(values)`` out of place; duplicate
    pixels accumulate (dead rows all sit at (0, 0) with zero deltas)."""
    mols = torch.arange(molecule_map.shape[0], device=molecule_map.device)
    return molecule_map.index_put(
        (mols[:, None], xs[None, :], ys[None, :]), values, accumulate=True
    )


def _integrator_inputs(
    molecule_map: torch.Tensor,  # (mols, m, m)
    cell_molecules: torch.Tensor,  # (cap, mols)
    positions: torch.Tensor,  # (cap, 2) int64; dead slots at (0, 0)
    params: CellParams,
    q: int,  # live-row prefix
) -> tuple[torch.Tensor, CellParams]:
    """The integrator's signals ``(q, 2 * mols)`` (intracellular, then the
    pixel's extracellular) and parameters over the live-row prefix."""
    xs, ys = positions[:q, 0], positions[:q, 1]
    ext = molecule_map[:, xs, ys].T  # (q, mols)
    X0 = torch.cat([cell_molecules[:q], ext], dim=1).contiguous()
    return X0, CellParams(*(t[:q] for t in params))


def _enzymatic_activity(
    integrator,
    molecule_map: torch.Tensor,  # (mols, m, m)
    cell_molecules: torch.Tensor,  # (cap, mols)
    positions: torch.Tensor,  # (cap, 2) int64; dead slots at (0, 0)
    n_cells: int,
    params: CellParams,
    q: int,  # live-row prefix
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather signals, run the MM integrator over the live-row prefix,
    scatter back deltas."""
    X0, params_q = _integrator_inputs(
        molecule_map, cell_molecules, positions, params, q
    )
    X1 = integrator(X0, params_q)
    n_mols = cell_molecules.shape[1]
    cm_q, ext = X0[:, :n_mols], X0[:, n_mols:]
    alive = (torch.arange(q, device=cm_q.device) < n_cells)[:, None]
    xs, ys = positions[:q, 0], positions[:q, 1]
    new_cm = cell_molecules.clone()
    new_cm[:q] = torch.where(alive, X1[:, :n_mols], cm_q)
    delta_ext = torch.where(alive, X1[:, n_mols:] - ext, torch.zeros_like(ext))
    return _map_add(molecule_map, xs, ys, delta_ext.T), new_cm


def _diffuse_and_permeate(
    molecule_map, cell_molecules, positions, n_cells, kernels, perm_factors, det
):
    """Map diffusion + membrane permeation."""
    new_map = _diff.diffuse(molecule_map, kernels, det=det)
    cap = cell_molecules.shape[0]
    alive = (torch.arange(cap, device=cell_molecules.device) < n_cells)[:, None]
    xs, ys = positions[:, 0], positions[:, 1]
    ext = new_map[:, xs, ys].T
    new_cm, new_ext = _diff.permeate(cell_molecules, ext, perm_factors, det=det)
    new_cm = torch.where(alive, new_cm, cell_molecules)
    delta_ext = torch.where(alive, new_ext - ext, torch.zeros_like(ext))
    return _map_add(new_map, xs, ys, delta_ext.T), new_cm


class World:
    """
    Main API for running the simulation; holds the state and offers methods
    to advance it.

    Parameters:
        chemistry: :class:`Chemistry` with molecules and reactions.
        map_size: Number of pixels in x and y direction of the world torus.
        abs_temp: Absolute temperature (K); influences reaction equilibria.
        mol_map_init: Initial molecule map concentrations — ``"randn"``
            (|N(10, 1)|) or ``"zeros"``.
        start_codons: Codons starting a coding sequence.
        stop_codons: Codons stopping a coding sequence.
        device: Where the device-side state lives: ``None`` means
            ``"cuda"``; pass ``"cpu"`` to run on the CPU.
        batch_size: Optional chunk size when updating cell parameters.
        seed: Seed driving all randomness (placement, token maps,
            mutations).  ``None`` draws a random seed.
        integrator: Integrator backend (``ops.backends``): ``"cuda"``,
            ``"torch-fast"`` or ``"torch-det"``; ``None`` derives it from
            the numeric mode and the device.
        phenotype_cache_size: Max entries of the genome->phenotype LRU
            cache; ``0`` disables cross-call caching.

    State is exposed with the reference's names — ``cell_genomes``,
    ``cell_labels``, ``cell_map``, ``cell_positions``, ``cell_lifetimes``,
    ``cell_divisions``, ``cell_molecules``, ``molecule_map`` — with cells
    always indexed 0..n_cells-1.
    """

    def __init__(
        self,
        chemistry: Chemistry,
        map_size: int = 128,
        abs_temp: float = 310.0,
        mol_map_init: str = "randn",
        start_codons: tuple[str, ...] = ("TTG", "GTG", "ATG"),
        stop_codons: tuple[str, ...] = ("TGA", "TAG", "TAA"),
        device: str | torch.device | None = None,
        batch_size: int | None = None,
        seed: int | None = None,
        integrator: str | None = None,
        phenotype_cache_size: int = 16384,
    ):
        self.device = resolve_device(device, "World")
        if seed is None:
            seed = random.SystemRandom().randrange(2**63)
        self.seed = seed
        self._rng = random.Random(seed)
        self._nprng = np.random.default_rng(seed)
        self.batch_size = batch_size
        self.map_size = map_size
        self.abs_temp = abs_temp
        self.chemistry = chemistry

        # numeric mode, fixed per instance at construction
        self.deterministic = default_deterministic()
        choice, pinned = _backends.resolve(
            integrator,
            deterministic=self.deterministic,
            device_type=self.device.type,
        )
        self._integrator_choice = choice if pinned else None

        self.genetics = Genetics(
            start_codons=start_codons,
            stop_codons=stop_codons,
            seed=self._rng.randrange(2**63),
        )
        # no RNG draw here: it must not shift the stream feeding Kinetics
        self.phenotypes = PhenotypeCache(self.genetics, maxsize=phenotype_cache_size)
        self.kinetics = Kinetics(
            chemistry=chemistry,
            abs_temp=abs_temp,
            scalar_enc_size=max(self.genetics.one_codon_map.values()),
            vector_enc_size=max(self.genetics.two_codon_map.values()),
            seed=self._rng.randrange(2**63),
            device=self.device,
        )

        mols = chemistry.molecules
        self.n_molecules = len(mols)
        self._diff_kernels = self._to_dev(
            _diff.diffusion_kernels([d.diffusivity for d in mols])
        )
        self._perm_factors = self._to_dev(
            _diff.permeation_factors([d.permeability for d in mols])
        )
        self._degrad_factors = self._to_dev(
            _diff.degradation_factors([d.half_life for d in mols])
        )

        # host-side state
        self.n_cells = 0
        self._genomes_list: list[str] = []
        self.cell_labels: list[str] = []
        self._capacity = 0
        self._np_cell_map = np.zeros((map_size, map_size), dtype=bool)
        self._np_positions = np.zeros((0, 2), dtype=np.int32)
        self._np_lifetimes = np.zeros(0, dtype=np.int32)
        self._np_divisions = np.zeros(0, dtype=np.int32)

        # device-side state (+ identity-keyed host snapshot caches)
        self._cell_molecules = torch.zeros(
            (0, self.n_molecules), dtype=torch.float32, device=self.device
        )
        self._positions_dev = torch.zeros((0, 2), dtype=torch.int64, device=self.device)
        self._molecule_map = self._init_molecule_map(mol_map_init)
        self._mm_cache: tuple | None = None
        self._cm_cache: tuple | None = None
        self._col_prefetch: tuple | None = None

        self._ensure_capacity(_MIN_CAPACITY)

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _ftz(self):
        """Deterministic mode flushes subnormals on the CPU as XLA does."""
        return flush_denormal(self.device) if self.deterministic else nullcontext()

    # ------------------------------------------------------------------ #
    # state views                                                        #
    # ------------------------------------------------------------------ #

    @property
    def cell_genomes(self) -> list[str]:
        """Genome strings of all living cells (the mutable host list)."""
        return self._genomes_list

    @cell_genomes.setter
    def cell_genomes(self, value):
        self._genomes_list = list(value)

    def genome_of(self, idx: int) -> str:
        """One cell's genome string."""
        return self._genomes_list[idx]

    @property
    def molecule_map(self) -> torch.Tensor:
        """(n_mols, m, m) float32 molecule concentrations on the map"""
        return self._molecule_map

    @molecule_map.setter
    def molecule_map(self, value):
        value = torch.as_tensor(value, dtype=torch.float32).to(self.device)
        if tuple(value.shape) != tuple(self._molecule_map.shape):
            raise ValueError(
                f"molecule_map must have shape {tuple(self._molecule_map.shape)}"
            )
        self._molecule_map = value.clone()

    def _host_molecule_map(self) -> np.ndarray:
        """Cached host snapshot of the molecule map (valid while the
        device tensor object is unchanged)."""
        cache = self._mm_cache
        if cache is None or cache[0] is not self._molecule_map:
            cache = (self._molecule_map, fetch_host(self._molecule_map))
            self._mm_cache = cache
        return cache[1]

    def _host_cell_molecules(self) -> np.ndarray:
        """Cached host snapshot of the full-capacity cell molecule buffer"""
        cache = self._cm_cache
        if cache is None or cache[0] is not self._cell_molecules:
            cache = (self._cell_molecules, fetch_host(self._cell_molecules))
            self._cm_cache = cache
        return cache[1]

    @property
    def cell_molecules(self) -> np.ndarray:
        """(n_cells, n_mols) float32 intracellular concentrations as a
        read-only host numpy view; copy, modify and assign back."""
        out = self._host_cell_molecules()[: self.n_cells]
        out.flags.writeable = False
        return out

    @cell_molecules.setter
    def cell_molecules(self, value):
        value = np.asarray(value, dtype=np.float32)
        if value.shape != (self.n_cells, self.n_molecules):
            raise ValueError(
                f"cell_molecules must have shape {(self.n_cells, self.n_molecules)}"
            )
        new_cm = self._cell_molecules.clone()
        new_cm[: self.n_cells] = self._to_dev(value)
        self._cell_molecules = new_cm

    def prefetch_cell_molecule_column(self, mol_idx: int):
        """Start the device->host copy of one molecule column; a later
        :meth:`cell_molecule_column` for the same state picks it up."""
        self._record_col_prefetch(mol_idx, self._cell_molecules[:, mol_idx])

    def _record_col_prefetch(self, mol_idx: int, col: torch.Tensor):
        if col.device.type == "cuda":
            host = torch.empty(col.shape, dtype=col.dtype, pin_memory=True)
            host.copy_(col, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = col.clone(), None
        self._col_prefetch = (self._cell_molecules, mol_idx, host, done)

    def cell_molecule_column(self, mol_idx: int) -> np.ndarray:
        """(n_cells,) float32 host copy of ONE molecule's intracellular
        concentrations (n_mols times less traffic than ``cell_molecules``)."""
        pf = self._col_prefetch
        self._col_prefetch = None
        if pf is not None and pf[0] is self._cell_molecules and pf[1] == mol_idx:
            _, _, host, done = pf
            if done is not None:
                done.synchronize()
            return host.numpy()[: self.n_cells]
        return fetch_host(self._cell_molecules[:, mol_idx])[: self.n_cells]

    def add_cell_molecules(self, cell_idxs: list[int], mol_idx: int, delta: float):
        """Add ``delta`` to one molecule of the given (distinct) cells on
        the device."""
        if len(cell_idxs) == 0:
            return
        idxs = self._to_dev(np.asarray(cell_idxs, dtype=np.int64))
        new_cm = self._cell_molecules.clone()
        new_cm[idxs, mol_idx] += np.float32(delta).item()
        self._cell_molecules = new_cm

    @property
    def cell_map(self) -> np.ndarray:
        """(m, m) bool — which pixels are occupied by a cell (host numpy)"""
        return self._np_cell_map

    @property
    def cell_positions(self) -> np.ndarray:
        """(n_cells, 2) int32 cell positions (host numpy)"""
        return self._np_positions[: self.n_cells]

    @property
    def cell_lifetimes(self) -> np.ndarray:
        """(n_cells,) int32 — steps alive since spawn or last division"""
        return self._np_lifetimes[: self.n_cells]

    @cell_lifetimes.setter
    def cell_lifetimes(self, value):
        self._np_lifetimes[: self.n_cells] = np.asarray(value, dtype=np.int32)

    @property
    def cell_divisions(self) -> np.ndarray:
        """(n_cells,) int32 — number of ancestor divisions"""
        return self._np_divisions[: self.n_cells]

    @cell_divisions.setter
    def cell_divisions(self, value):
        self._np_divisions[: self.n_cells] = np.asarray(value, dtype=np.int32)

    # ------------------------------------------------------------------ #
    # capacity                                                           #
    # ------------------------------------------------------------------ #

    def _ensure_capacity(self, n: int):
        if n <= self._capacity:
            return
        cap = pad_pow2(n, minimum=_MIN_CAPACITY)
        grow = cap - self._capacity
        self._np_positions = np.concatenate(
            [self._np_positions, np.zeros((grow, 2), dtype=np.int32)]
        )
        self._np_lifetimes = np.concatenate(
            [self._np_lifetimes, np.zeros(grow, dtype=np.int32)]
        )
        self._np_divisions = np.concatenate(
            [self._np_divisions, np.zeros(grow, dtype=np.int32)]
        )
        cm = torch.zeros(
            (cap, self.n_molecules), dtype=torch.float32, device=self.device
        )
        cm[: self._capacity] = self._cell_molecules
        self._cell_molecules = cm
        self._capacity = cap
        self._sync_positions()
        self.kinetics.ensure_capacity(n_cells=cap)

    def _sync_positions(self):
        self._positions_dev = self._to_dev(self._np_positions.astype(np.int64))

    def _init_molecule_map(self, init: str) -> torch.Tensor:
        shape = (self.n_molecules, self.map_size, self.map_size)
        if init == "zeros":
            return self._to_dev(np.zeros(shape, dtype=np.float32))
        if init == "randn":
            arr = np.abs(self._nprng.standard_normal(shape, dtype=np.float32) + 10.0)
            return self._to_dev(arr)
        raise ValueError(
            f"Didnt recognize mol_map_init={init}. Should be one of: 'zeros', 'randn'."
        )

    # ------------------------------------------------------------------ #
    # neighbors                                                          #
    # ------------------------------------------------------------------ #

    def get_neighbors(
        self, cell_idxs: list[int], nghbr_idxs: list[int] | None = None
    ) -> list[tuple[int, int]]:
        """Unique Moore-neighborhood pairs among cells (smaller index
        first); with ``nghbr_idxs``, partners come from that list only."""
        pairs = self._neighbor_pairs(cell_idxs, nghbr_idxs)
        return list(zip(pairs[:, 0].tolist(), pairs[:, 1].tolist()))

    def _neighbor_pairs(
        self,
        cell_idxs: list[int] | None,
        nghbr_idxs: list[int] | None = None,
    ) -> np.ndarray:
        """:meth:`get_neighbors` as a (k, 2) int64 array, smaller index
        first, sorted; ``cell_idxs=None`` means the whole population"""
        n = self.n_cells
        if cell_idxs is None and nghbr_idxs is None:
            return moore_pairs(self._np_positions[:n], self.map_size)
        if cell_idxs is None:
            from_idxs = np.arange(n, dtype=np.int64)
        else:
            if len(cell_idxs) == 0:
                return np.zeros((0, 2), dtype=np.int64)
            from_idxs = np.array(sorted(set(cell_idxs)), dtype=np.int64)
        if nghbr_idxs is None:
            to_member = None if cell_idxs is None else np.zeros(n, dtype=bool)
            if to_member is not None:
                to_member[from_idxs] = True
        else:
            if len(nghbr_idxs) == 0:
                return np.zeros((0, 2), dtype=np.int64)
            to_member = np.zeros(n, dtype=bool)
            to_member[list(set(nghbr_idxs))] = True

        m = self.map_size
        grid = np.full((m, m), -1, dtype=np.int64)
        pos = self._np_positions[:n]
        grid[pos[:, 0], pos[:, 1]] = np.arange(n)

        fp = pos[from_idxs]
        nx = (fp[:, 0][:, None] + self._MOORE_DX[None, :]) % m
        ny = (fp[:, 1][:, None] + self._MOORE_DY[None, :]) % m
        cand = grid[nx, ny]  # (k, 8)
        src = np.broadcast_to(from_idxs[:, None], cand.shape)
        # cand != src guards degenerate torus wraps (map_size <= 2)
        valid = (cand >= 0) & (cand != src)
        if to_member is not None:
            valid &= to_member[np.clip(cand, 0, None)]
        a = src[valid]
        b = cand[valid]
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        enc = np.unique(lo * np.int64(n) + hi)
        return np.stack([enc // n, enc % n], axis=1)

    # ------------------------------------------------------------------ #
    # cell lifecycle                                                     #
    # ------------------------------------------------------------------ #

    def _find_free_random_positions(self, n_cells: int) -> np.ndarray:
        free = np.argwhere(~self._np_cell_map)
        if n_cells > len(free):
            n_cells = len(free)
        chosen = self._nprng.choice(len(free), size=n_cells, replace=False)
        return free[chosen].astype(np.int32)

    def spawn_cells(self, genomes: list[str]) -> list[int]:
        """
        Create new cells from genome strings and place them on random free
        pixels.  Each new cell picks up half the molecules of its pixel,
        gets lifetime 0, 0 divisions, and a random label.  Returns the new
        cell indexes.
        """
        n_new = len(genomes)
        if n_new == 0:
            return []
        free_pos = self._find_free_random_positions(n_cells=n_new)
        if len(free_pos) == 0:
            return []
        if len(free_pos) < n_new:
            n_new = len(free_pos)
            genomes = list(genomes)
            self._rng.shuffle(genomes)
            genomes = genomes[:n_new]

        new_idxs = list(range(self.n_cells, self.n_cells + n_new))
        self._ensure_capacity(self.n_cells + n_new)
        self.n_cells += n_new
        self._genomes_list.extend(genomes)
        self.cell_labels.extend(randstr(n=12, rng=self._rng) for _ in range(n_new))

        self._np_cell_map[free_pos[:, 0], free_pos[:, 1]] = True
        self._np_positions[new_idxs] = free_pos
        self._np_lifetimes[new_idxs] = 0
        self._np_divisions[new_idxs] = 0
        self._sync_positions()

        # new cells pick up half the molecules of their pixel
        xs = self._to_dev(free_pos[:, 0].astype(np.int64))
        ys = self._to_dev(free_pos[:, 1].astype(np.int64))
        pickup = self._molecule_map[:, xs, ys] * 0.5  # (mols, b)
        self._molecule_map = _map_add(self._molecule_map, xs, ys, -pickup)
        new_cm = self._cell_molecules.clone()
        new_cm[new_idxs[0] : new_idxs[-1] + 1] += pickup.T
        self._cell_molecules = new_cm

        self._update_cell_params(genomes=genomes, idxs=new_idxs)
        return new_idxs

    _MOORE_DX = np.array([-1, -1, -1, 0, 0, 1, 1, 1], dtype=np.int64)
    _MOORE_DY = np.array([-1, 0, 1, -1, 1, -1, 0, 1], dtype=np.int64)

    def _place_in_neighborhood(
        self, idxs: np.ndarray, vacate: bool
    ) -> list[tuple[int, tuple[int, int]]]:
        """
        Place one pixel per cell in its free Moore neighborhood, no two on
        the same pixel: round-based resolution in which every pending cell
        draws a uniformly random free neighbor against the current map and
        the lowest-index cell wins a contested pixel.  The JAX package's
        algorithm and RNG draws, unchanged.
        """
        m = self.map_size
        cmap = self._np_cell_map
        pos = self._np_positions
        dx, dy = self._MOORE_DX, self._MOORE_DY
        pending = idxs
        placed: list[tuple[int, tuple[int, int]]] = []
        while len(pending) > 0:
            p = pos[pending]
            nx = (p[:, 0:1] + dx[None, :]) % m  # (k, 8)
            ny = (p[:, 1:2] + dy[None, :]) % m
            free = ~cmap[nx, ny]
            has_opts = free.sum(axis=1) > 0
            if not vacate:
                # divide: pixels only fill up, so no options is terminal
                pending = pending[has_opts]
                nx, ny, free = nx[has_opts], ny[has_opts], free[has_opts]
                active = np.arange(len(pending))
            else:
                active = np.nonzero(has_opts)[0]
            if len(active) == 0:
                break
            nx, ny, free = nx[active], ny[active], free[active]
            n_free = free.sum(axis=1)

            # rank-r free option per cell, r uniform in [0, n_free)
            rank = (self._nprng.random(len(active)) * n_free).astype(np.int64)
            opt_rank = np.cumsum(free, axis=1) - 1
            sel = np.argmax(free & (opt_rank == rank[:, None]), axis=1)
            rows = np.arange(len(active))
            tx = nx[rows, sel]
            ty = ny[rows, sel]

            # same-target conflicts: lowest cell idx wins (pending is sorted)
            target = tx * m + ty
            order = np.argsort(target, kind="stable")
            win = np.ones(len(active), dtype=bool)
            srt = target[order]
            win[order[1:]] = srt[1:] != srt[:-1]

            w_idx = pending[active[win]]
            w_x, w_y = tx[win], ty[win]
            cmap[w_x, w_y] = True
            if vacate:
                old = pos[w_idx]
                cmap[old[:, 0], old[:, 1]] = False
                pos[w_idx, 0] = w_x
                pos[w_idx, 1] = w_y
            placed.extend(
                (int(i), (int(x), int(y))) for i, x, y in zip(w_idx, w_x, w_y)
            )
            drop = np.zeros(len(pending), dtype=bool)
            drop[active[win]] = True
            pending = pending[~drop]
        placed.sort(key=lambda t: t[0])
        return placed

    def divide_cells(self, cell_idxs: list[int]) -> list[tuple[int, int]]:
        """
        Divide cells that have at least one free Moore-neighborhood pixel;
        the clone lands there.  Descendants share molecules evenly, get
        divisions + 1 and lifetime 0.  Returns ``(parent_idx, child_idx)``
        tuples of successful divisions.
        """
        if len(cell_idxs) == 0:
            return []
        cell_idxs = sorted(set(cell_idxs))
        placed = self._place_in_neighborhood(
            np.asarray(cell_idxs, dtype=np.int64), vacate=False
        )
        parent_idxs = [int(i) for i, _ in placed]
        child_pos = [p for _, p in placed]

        n_new = len(parent_idxs)
        if n_new == 0:
            return []
        child_idxs = list(range(self.n_cells, self.n_cells + n_new))
        self._ensure_capacity(self.n_cells + n_new)
        self.n_cells += n_new

        self._genomes_list.extend([self._genomes_list[d] for d in parent_idxs])
        self.cell_labels.extend([self.cell_labels[d] for d in parent_idxs])

        child_pos_arr = np.array(child_pos, dtype=np.int32)
        self._np_positions[child_idxs] = child_pos_arr
        descendant_idxs = parent_idxs + child_idxs
        self._np_divisions[child_idxs] = self._np_divisions[parent_idxs]
        self._np_divisions[descendant_idxs] += 1
        self._np_lifetimes[descendant_idxs] = 0
        self._sync_positions()

        # molecules are shared evenly; children inherit parameter rows
        parents = self._to_dev(np.asarray(parent_idxs, dtype=np.int64))
        children = self._to_dev(np.asarray(child_idxs, dtype=np.int64))
        new_cm = self._cell_molecules.clone()
        half = new_cm[parents] * 0.5
        new_cm[parents] = half
        new_cm[children] = half
        self._cell_molecules = new_cm
        self.kinetics.copy_cell_params(parent_idxs, child_idxs)
        return list(zip(parent_idxs, child_idxs))

    def update_cells(self, genome_idx_pairs: list[tuple[str, int]]):
        """Update existing cells with new genomes and re-derive their
        proteomes."""
        if len(genome_idx_pairs) == 0:
            return
        for genome, idx in genome_idx_pairs:
            self._genomes_list[idx] = genome
        genomes, idxs = map(list, zip(*genome_idx_pairs))
        self._update_cell_params(genomes=genomes, idxs=idxs)

    def kill_cells(self, cell_idxs: list[int] | None = None):
        """
        Remove cells; their molecule contents spill onto their pixel.
        Cells are compacted, so surviving cells' indexes shift down.
        """
        if cell_idxs is None:
            cell_idxs = list(range(self.n_cells))
        if len(cell_idxs) == 0:
            return
        kill = np.array(sorted(set(cell_idxs)), dtype=np.int64)

        pos = self._np_positions[kill]
        self._np_cell_map[pos[:, 0], pos[:, 1]] = False

        # stable compaction permutation over the full capacity
        keep_mask = np.ones(self._capacity, dtype=bool)
        keep_mask[kill] = False
        keep_mask[self.n_cells :] = False
        perm = np.concatenate([np.nonzero(keep_mask)[0], np.nonzero(~keep_mask)[0]])
        n_keep = int(keep_mask.sum())

        # killed cells dump their contents onto their pixel
        kill_t = self._to_dev(kill)
        spill = self._cell_molecules[kill_t]  # (b, mols)
        self._molecule_map = _map_add(
            self._molecule_map,
            self._to_dev(pos[:, 0].astype(np.int64)),
            self._to_dev(pos[:, 1].astype(np.int64)),
            spill.T,
        )
        perm_t = self._to_dev(perm.astype(np.int64))
        self._cell_molecules = compact_rows(self._cell_molecules, perm_t, n_keep)
        self.kinetics.permute_cells(perm, n_keep)

        self._np_positions = self._np_positions[perm]
        self._np_positions[n_keep:] = 0
        self._np_lifetimes = self._np_lifetimes[perm]
        self._np_lifetimes[n_keep:] = 0
        self._np_divisions = self._np_divisions[perm]
        self._np_divisions[n_keep:] = 0
        self._sync_positions()

        kill_set = set(kill.tolist())
        self._genomes_list = [
            g for i, g in enumerate(self._genomes_list) if i not in kill_set
        ]
        self.cell_labels = [
            lab for i, lab in enumerate(self.cell_labels) if i not in kill_set
        ]
        self.n_cells -= len(kill)

    # ------------------------------------------------------------------ #
    # physics                                                            #
    # ------------------------------------------------------------------ #

    @property
    def integrator(self) -> str:
        """The resolved integrator backend name (``ops.backends``): pinned
        when selected explicitly, else following the numeric mode and the
        device."""
        if self._integrator_choice is not None:
            return self._integrator_choice
        return _backends.default_backend(self.deterministic, self.device.type)

    def integrator_inputs(self) -> tuple[torch.Tensor, CellParams]:
        """What the next :meth:`enzymatic_activity` hands the integrator:
        the signals ``X0`` ``(q, 2 * n_molecules)`` and the kinetic
        parameters, both over the live-row prefix ``q``."""
        q = quantize_rows(self.n_cells, self._capacity)
        return _integrator_inputs(
            self._molecule_map,
            self._cell_molecules,
            self._positions_dev,
            self.kinetics.params,
            q,
        )

    def enzymatic_activity(self, prefetch_column: int | None = None):
        """Catalyze reactions and transport for one time step; updates
        ``molecule_map`` and ``cell_molecules``.  With ``prefetch_column``,
        that molecule's column starts its device->host copy right away
        (a later :meth:`cell_molecule_column` picks it up)."""
        if self.n_cells == 0:
            return
        q = quantize_rows(self.n_cells, self._capacity)
        with self._ftz():
            self._molecule_map, self._cell_molecules = _enzymatic_activity(
                _backends.integrator_fn(self.integrator),
                self._molecule_map,
                self._cell_molecules,
                self._positions_dev,
                self.n_cells,
                self.kinetics.params,
                q,
            )
        if prefetch_column is not None:
            self.prefetch_cell_molecule_column(prefetch_column)

    def diffuse_molecules(self):
        """Let molecules diffuse over the map and permeate membranes for
        one time step."""
        with self._ftz():
            if self.n_cells == 0:
                self._molecule_map = _diff.diffuse(
                    self._molecule_map, self._diff_kernels, det=self.deterministic
                )
                return
            self._molecule_map, self._cell_molecules = _diffuse_and_permeate(
                self._molecule_map,
                self._cell_molecules,
                self._positions_dev,
                self.n_cells,
                self._diff_kernels,
                self._perm_factors,
                self.deterministic,
            )

    def degrade_molecules(self):
        """Degrade molecules everywhere by one time step"""
        with self._ftz():
            self._molecule_map, self._cell_molecules = _diff.degrade(
                self._molecule_map, self._cell_molecules, self._degrad_factors
            )

    def degrade_and_diffuse_molecules(self):
        """:meth:`degrade_molecules` followed by :meth:`diffuse_molecules`."""
        self.degrade_molecules()
        self.diffuse_molecules()

    def increment_cell_lifetimes(self):
        """Increment ``cell_lifetimes`` by 1"""
        self._np_lifetimes[: self.n_cells] += 1

    # ------------------------------------------------------------------ #
    # evolution                                                          #
    # ------------------------------------------------------------------ #

    def mutate_cells(
        self,
        cell_idxs: list[int] | None = None,
        p: float = 1e-6,
        p_indel: float = 0.4,
        p_del: float = 0.66,
    ):
        """Point-mutate cell genomes, then update changed cells"""
        seed = int(self._nprng.integers(2**63))
        if cell_idxs is None:
            mutated = _engine.point_mutations(
                self.cell_genomes, p=p, p_indel=p_indel, p_del=p_del, seed=seed
            )
            self.update_cells(genome_idx_pairs=mutated)
        else:
            seqs = [self.cell_genomes[d] for d in cell_idxs]
            mutated = _engine.point_mutations(
                seqs, p=p, p_indel=p_indel, p_del=p_del, seed=seed
            )
            self.update_cells(
                genome_idx_pairs=[(d, cell_idxs[i]) for d, i in mutated]
            )

    def recombinate_cells(self, cell_idxs: list[int] | None = None, p: float = 1e-7):
        """Recombinate genomes of neighboring cells, then update changed
        cells."""
        pair_arr = self._neighbor_pairs(cell_idxs=cell_idxs)
        seed = int(self._nprng.integers(2**63))
        mutated = _engine.recombinations_indexed(
            self.cell_genomes, pair_arr, p=p, seed=seed
        )
        genome_idx_pairs = []
        for c0, c1, idx in mutated:
            c0_i, c1_i = pair_arr[idx]
            genome_idx_pairs.append((c0, int(c0_i)))
            genome_idx_pairs.append((c1, int(c1_i)))
        self.update_cells(genome_idx_pairs=genome_idx_pairs)

    # ------------------------------------------------------------------ #
    # parameter updates                                                  #
    # ------------------------------------------------------------------ #

    def _update_cell_params(self, genomes: list[str], idxs: list[int]):
        """Translate genomes (through the phenotype cache) and write
        kinetic parameters for these cells; duplicate slots: last wins."""
        idxs_arr = np.asarray(idxs, dtype=np.int32)
        if len(idxs_arr) == 0:
            return
        if len(np.unique(idxs_arr)) != len(idxs_arr):
            _, keep = np.unique(idxs_arr[::-1], return_index=True)
            keep = np.sort(len(idxs_arr) - 1 - keep)
            idxs_arr = idxs_arr[keep]
            genomes = [genomes[i] for i in keep]
        entries = self.phenotypes.lookup(genomes)
        has_prots = np.fromiter(
            (e.n_prots > 0 for e in entries), dtype=bool, count=len(entries)
        )
        self.kinetics.unset_cell_params(idxs_arr[~has_prots])
        set_idxs = idxs_arr[has_prots]
        if len(set_idxs) == 0:
            return
        set_entries = [e for e, h in zip(entries, has_prots) if h]
        # grow for the WHOLE dispatch before packing any batch of it
        self.kinetics.ensure_token_limits(
            max(e.n_prots for e in set_entries),
            max(e.max_doms for e in set_entries),
        )
        batch = self.batch_size or len(set_idxs)
        for a in range(0, len(set_idxs), batch):
            b = min(a + batch, len(set_idxs))
            self.kinetics.set_cell_params_cached(
                set_idxs[a:b], set_entries[a:b], self.phenotypes
            )

    def __repr__(self) -> str:
        kwargs = {
            "map_size": self.map_size,
            "abs_temp": self.abs_temp,
            "device": str(self.device),
        }
        args = [f"{k}:{repr(d)}" for k, d in kwargs.items()]
        return f"{type(self).__name__}({','.join(args)})"
