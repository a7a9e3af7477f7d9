"""
The World: the main API object holding all simulation state and the methods
advancing it — the classic ``World`` of :mod:`magicsoup_tpu.world`, in
PyTorch.

The same public surface (apart from compile warming) and the
same index semantics: cells are dense indices
0..n_cells-1, kill compacts and shifts indices, molecules are ordered as
in :class:`Chemistry`.

- **capacity pools**: device tensors are allocated at a power-of-two slot
  capacity (>= 64) and grown amortized; kill is a permutation gather
  (stable compaction), divide/spawn write rows.
- **host/device split**: labels, positions, the boolean cell map,
  lifetimes and divisions live on the host (numpy / lists); the molecule
  map, intracellular molecules, a mirror of the positions and all kinetic
  parameter tensors live on ``device``.  Genomes are host strings
  (``genome_backend="string"``) or a packed token tensor on ``device``
  (``"token"``, :class:`~magicsoup_tpu_torch.genomes.GenomeStore`),
  mutated and recombined by the device programs of
  :mod:`magicsoup_tpu_torch.genomes`.
- **explicit seeding**: one ``seed`` drives placement, token maps and
  mutations, drawn from ``random.Random(seed)`` and
  ``np.random.default_rng(seed)`` in the JAX package's order, so a port
  world and a JAX world from one seed take the same decisions.
- **spans**: each call that a step makes opens one span of the world's
  recorder (``ms:spawn``, ``ms:activity``, ``ms:fetch``, ``ms:kill``,
  ``ms:divide``, ``ms:recombinate`` over ``ms:neighbors``, ``ms:mutate``,
  the engine's ``ms:lengths``, ``ms:translate``, ``ms:assemble`` and
  ``ms:physics``): ``telemetry.phase_stats()``/``self_times()`` on the
  host, ``record_function`` ranges of those names under a profiler.
- **persistence**: a pickle holds host numpy and the device's name, so a
  world saved on the card loads anywhere (``from_file(device=...)``);
  ``save_state`` writes the JAX package's file set byte for byte.
- **meshes**: ``World(mesh=...)`` places the world over a 1D mesh of
  ranks (:mod:`magicsoup_tpu_torch.parallel`): each rank holds its rows
  of the molecule map and its slot block of every cell tensor, the host
  state is replicated, and every rank runs the same calls in the same
  order.  ``molecule_map``, ``cell_molecules`` and the other host reads
  see the global state (an all-gather, so they are collective too);
  activity integrates each rank's own slot block, diffusion exchanges
  halo rows (:mod:`magicsoup_tpu_torch.parallel.tiled`).  In
  deterministic mode a mesh world is bit-identical to the same world on
  one device.

The molecule tensors are replaced, never written in place, by every step
(the JAX package's arrays are immutable, and the host snapshots below are
cached by tensor identity).  Parameter rows are written in place.
"""
import functools
import io
import pickle
import random
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from magicsoup_tpu_torch import genomes as _genomes
from magicsoup_tpu_torch import telemetry as _telemetry
from magicsoup_tpu_torch.analysis import runtime as _runtime
from magicsoup_tpu_torch.containers import Cell, Chemistry
from magicsoup_tpu_torch.genetics import Genetics, PhenotypeCache
from magicsoup_tpu_torch.kinetics import Kinetics
from magicsoup_tpu_torch.native import engine as _engine
from magicsoup_tpu_torch.ops import backends as _backends
from magicsoup_tpu_torch.ops import cuda_integrate as _cuda_integrate
from magicsoup_tpu_torch.ops import diffusion as _diff
from magicsoup_tpu_torch.ops.detmath import flush_denormal
from magicsoup_tpu_torch.ops.integrate import CellParams, default_deterministic
from magicsoup_tpu_torch.guard.errors import CheckpointError
from magicsoup_tpu_torch.guard.io import atomic_write_bytes, atomic_write_text
from magicsoup_tpu_torch.parallel import tiled as _tiled
from magicsoup_tpu_torch.ops.params import (
    compact_rows,
    next_rung,
    pad_pow2,
    quantize_rows,
    write_new_rows,
)
from magicsoup_tpu_torch.util import (
    fetch_host,
    moore_pairs,
    randstr,
    resolve_device,
    restore_device,
    restored_device,
)

_MIN_CAPACITY = 64


def _spanned(name: str):
    """Run the method inside one span ``name`` of the world's recorder."""

    def wrap(method):
        @functools.wraps(method)
        def spanned(self, *args, **kwargs):
            with self.telemetry.span(name):
                return method(self, *args, **kwargs)

        return spanned

    return wrap


# --------------------------------------------------------------------- #
# device-state programs (slot-capacity tensors, in PyTorch)             #
# --------------------------------------------------------------------- #


def _last_wins(idxs, genomes: list[str]) -> tuple[np.ndarray, list[str]]:
    """Slots (int32) and genomes with each duplicate slot's earlier
    entries dropped: the last wins, the order is kept."""
    idxs_arr = np.asarray(idxs, dtype=np.int32)
    if len(np.unique(idxs_arr)) != len(idxs_arr):
        _, keep = np.unique(idxs_arr[::-1], return_index=True)
        keep = np.sort(len(idxs_arr) - 1 - keep)
        idxs_arr, genomes = idxs_arr[keep], [genomes[i] for i in keep]
    return idxs_arr, genomes


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
        mesh: A :class:`~magicsoup_tpu_torch.parallel.tiled.Mesh`: shard
            the world over its ranks (map rows, cell slots; module notes),
            on ``mesh.device``.  Mutually exclusive with ``device``;
            ``map_size`` must divide into the mesh's tiles.
        integrator: Integrator backend (``ops.backends``): ``"cuda"``,
            ``"torch-fast"`` or ``"torch-det"``; ``None`` derives it from
            the numeric mode and the device.
        use_pallas: Legacy flag, the JAX package's spelling: ``True``
            selects ``"cuda"`` (the counterpart of ``"pallas"``), ``False``
            the torch integrator of the numeric mode; below
            ``integrator`` and the env var, and ``ValueError`` when
            ``integrator`` disagrees with it.
        phenotype_cache_size: Max entries of the genome->phenotype LRU
            cache; ``0`` disables cross-call caching.
        telemetry: JSONL sink of the telemetry recorder: ``None`` keeps a
            detached :class:`~magicsoup_tpu_torch.telemetry.TelemetryRecorder`
            (phase timings only, no file), a path attaches one to that
            file, and a recorder passes through (shared across worlds).
            A :class:`~magicsoup_tpu_torch.PipelinedStepper` over the
            world writes its dispatch and step rows to it.
        genome_backend: ``"string"`` keeps genomes as a host list of
            strings; ``"token"`` keeps them on ``device`` as a packed
            token tensor evolved by device programs, so strings exist only
            at the import/export boundary (spawn, ``cell_genomes``,
            ``genome_of``).

    State is exposed with the reference's names — ``cell_genomes``,
    ``cell_labels``, ``cell_map``, ``cell_positions``, ``cell_lifetimes``,
    ``cell_divisions``, ``cell_molecules``, ``molecule_map`` — with cells
    always indexed 0..n_cells-1.
    """

    # the device state: the whole tensors, or under a mesh this rank's
    # block (map rows, cell slots) read back as the whole tensor
    _molecule_map = _tiled.sharded_attr("_molecule_map", 1)
    _cell_molecules = _tiled.sharded_attr("_cell_molecules", 0)

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
        mesh=None,
        integrator: str | None = None,
        use_pallas: bool | None = None,
        phenotype_cache_size: int = 16384,
        telemetry=None,
        genome_backend: str = "string",
    ):
        from magicsoup_tpu_torch.telemetry import TelemetryRecorder

        if device is not None and mesh is not None:
            raise ValueError(
                "device and mesh are mutually exclusive: a mesh-placed"
                " world is sharded over the mesh's devices"
            )
        if mesh is not None:
            if map_size % mesh.size != 0:
                raise ValueError(
                    f"map_size={map_size} must be divisible by the first"
                    f" mesh axis size {mesh.size} for row sharding"
                )
            device = mesh.device
        self._mesh = mesh
        self.device = resolve_device(device, "World")
        if seed is None:
            # graftlint: disable=GL004 entropy only when the caller passed no seed
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
            use_pallas=use_pallas,
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
        self.kinetics.mesh = mesh

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

        if genome_backend not in ("string", "token"):
            raise ValueError(
                f"genome_backend must be 'string' or 'token', got {genome_backend!r}"
            )
        self.genome_backend = genome_backend
        self._genome_store = None

        # host-side state
        self.n_cells = 0
        self._genomes_list: list[str] = []
        self.cell_labels: list[str] = []
        self._capacity = 0
        self._np_cell_map = np.zeros((map_size, map_size), dtype=bool)
        self._np_positions = np.zeros((0, 2), dtype=np.int32)
        self._np_lifetimes = np.zeros(0, dtype=np.int32)
        self._np_divisions = np.zeros(0, dtype=np.int32)
        # bumped by the host mutators that replace no array object (the
        # lifetime and division writes, a backend switch): every other
        # mutator replaces an object the stepper's flush token compares by
        # identity or writes parameter rows (``Kinetics._param_epoch``), so
        # together they let a re-attach after a flush prove that nothing
        # touched the world and skip the host-replay rebuild
        self._host_epoch = 0

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
        # the recorder touches no RNG and no device state
        self.telemetry = TelemetryRecorder.coerce(telemetry)

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
        """Genome strings of all living cells: on the string backend the
        mutable host list; on the token backend a decoded export view of
        the device store, cached per store version (read-only: assign a
        whole list, or use ``update_cells``/``spawn_cells``)."""
        if self._genome_store is not None:
            return self._genome_store.decoded(self.n_cells)
        return self._genomes_list

    @cell_genomes.setter
    def cell_genomes(self, value):
        if self._genome_store is not None:
            self._genome_store.set_all(list(value))
        else:
            self._genomes_list = list(value)

    @property
    def genome_store(self):
        """The device :class:`~magicsoup_tpu_torch.genomes.GenomeStore`
        (token backend; ``None`` on the string backend)."""
        return self._genome_store

    def genome_of(self, idx: int) -> str:
        """One cell's genome string (token backend: decodes that row)."""
        if self._genome_store is not None:
            return self._genome_store.decode_row(idx)
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

    def _block(self, name: str) -> torch.Tensor:
        """The stored tensor behind ``_molecule_map`` or
        ``_cell_molecules``: this rank's block under a mesh."""
        return self.__dict__[name]

    def _set_blocks(self, mm: torch.Tensor, cm: torch.Tensor) -> None:
        """Store ``_molecule_map`` and ``_cell_molecules`` as given: this
        rank's blocks under a mesh."""
        self.__dict__["_molecule_map"], self.__dict__["_cell_molecules"] = mm, cm

    def _host_molecule_map(self) -> np.ndarray:
        """Cached host snapshot of the molecule map (valid while the
        device tensor object is unchanged)."""
        cache = self._mm_cache
        if cache is None or cache[0] is not self._block("_molecule_map"):
            cache = (self._block("_molecule_map"), fetch_host(self._molecule_map))
            self._mm_cache = cache
        return cache[1]

    def _host_cell_molecules(self) -> np.ndarray:
        """Cached host snapshot of the full-capacity cell molecule buffer"""
        cache = self._cm_cache
        if cache is None or cache[0] is not self._block("_cell_molecules"):
            cache = (self._block("_cell_molecules"), fetch_host(self._cell_molecules))
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
        self._col_prefetch = (self._block("_cell_molecules"), mol_idx, host, done)

    @_spanned("ms:fetch")
    def cell_molecule_column(self, mol_idx: int) -> np.ndarray:
        """(n_cells,) float32 host copy of ONE molecule's intracellular
        concentrations (n_mols times less traffic than ``cell_molecules``)."""
        pf = self._col_prefetch
        self._col_prefetch = None
        if pf is not None and pf[0] is self._block("_cell_molecules") and pf[1] == mol_idx:
            _, _, host, done = pf
            if done is not None:
                done.synchronize()
            # host memory already: fetch_host meters it without a copy
            return fetch_host(host)[: self.n_cells]
        return fetch_host(self._cell_molecules[:, mol_idx])[: self.n_cells]

    def add_cell_molecules(self, cell_idxs: list[int], mol_idx: int, delta: float):
        """Add ``delta`` to one molecule of the given cells on the device;
        a cell listed m times gains m x ``delta``, as in the JAX
        package's scatter-add (the addends are equal, so the order of
        the additions changes no bit)."""
        if len(cell_idxs) == 0:
            return
        flat = np.asarray(cell_idxs, dtype=np.int64) * self.n_molecules + mol_idx
        idxs = self._to_dev(flat)
        vals = torch.full(
            idxs.shape, np.float32(delta).item(), dtype=torch.float32, device=self.device
        )
        new_cm = self._cell_molecules.clone()
        new_cm.view(-1).index_add_(0, idxs, vals)
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
        self._host_epoch += 1
        self._np_lifetimes[: self.n_cells] = np.asarray(value, dtype=np.int32)

    @property
    def cell_divisions(self) -> np.ndarray:
        """(n_cells,) int32 — number of ancestor divisions"""
        return self._np_divisions[: self.n_cells]

    @cell_divisions.setter
    def cell_divisions(self, value):
        self._host_epoch += 1
        self._np_divisions[: self.n_cells] = np.asarray(value, dtype=np.int32)

    # ------------------------------------------------------------------ #
    # capacity                                                           #
    # ------------------------------------------------------------------ #

    def _ensure_capacity(self, n: int):
        if n <= self._capacity:
            return
        cap = pad_pow2(n, minimum=_MIN_CAPACITY)
        if self._mesh is not None:
            # the cell axis is sharded: capacity must split evenly across
            # the tiles (a pow2 cap over a pow2 tile count already does)
            cap = -(-cap // self._mesh.size) * self._mesh.size
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
        if self.genome_backend == "token":
            if self._genome_store is None:
                self._genome_store = _genomes.GenomeStore(
                    cap, device=self.device, mesh=self._mesh
                )
            else:
                self._genome_store.grow_capacity(cap)
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
    # interpretation                                                     #
    # ------------------------------------------------------------------ #

    def get_cell(
        self,
        by_idx: int | None = None,
        by_position: tuple[int, int] | None = None,
    ) -> Cell:
        """A :class:`Cell` view of one cell, by index or by pixel; an
        empty pixel is a ``ValueError``."""
        idx = -1
        if by_idx is not None:
            idx = by_idx
        if by_position is not None:
            pos = np.asarray(by_position, dtype=np.int32)
            hits = np.nonzero((self.cell_positions == pos).all(axis=1))[0]
            if len(hits) == 0:
                raise ValueError(f"Cell at {by_position} not found")
            idx = int(hits[0])
        return Cell(
            world=self,
            idx=idx,
            # token backend: Cell.genome decodes this one row on first use
            genome=None if self._genome_store is not None else self._genomes_list[idx],
            position=tuple(self._np_positions[idx].tolist()),
            label=self.cell_labels[idx],
            n_steps_alive=int(self._np_lifetimes[idx]),
            n_divisions=int(self._np_divisions[idx]),
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

    @_spanned("ms:neighbors")
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

    @_spanned("ms:spawn")
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
        if self._genome_store is not None:
            # the string import boundary: encode once; the encoded rows feed
            # both the device scatter and the hash-keyed translation below
            g_rows, g_lens = self._genome_store.set_rows(new_idxs, genomes)
        else:
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

        if self._genome_store is not None:
            self._update_cell_params_rows(new_idxs, g_rows, g_lens)
        else:
            self._update_cell_params(genomes=genomes, idxs=new_idxs)
        return new_idxs

    @_spanned("ms:spawn")
    def add_cells(self, cells: list[Cell]) -> list[int]:
        """
        Place :class:`Cell` objects on random free pixels, keeping their
        genomes, molecules, lifetimes, divisions and labels.  Returns the
        new cell indexes.
        """
        n_new = len(cells)
        if n_new == 0:
            return []
        free_pos = self._find_free_random_positions(n_cells=n_new)
        if len(free_pos) == 0:
            return []
        if len(free_pos) < n_new:
            n_new = len(free_pos)
            cells = list(cells)
            self._rng.shuffle(cells)
            cells = cells[:n_new]

        n_old = self.n_cells
        new_idxs = list(range(n_old, n_old + n_new))
        self._ensure_capacity(n_old + n_new)
        self.n_cells += n_new
        genomes = [d.genome for d in cells]
        if self._genome_store is not None:
            g_rows, g_lens = self._genome_store.set_rows(new_idxs, genomes)
        else:
            self._genomes_list.extend(genomes)
        self.cell_labels.extend(d.label for d in cells)

        self._np_cell_map[free_pos[:, 0], free_pos[:, 1]] = True
        self._np_positions[new_idxs] = free_pos
        self._np_lifetimes[new_idxs] = [d.n_steps_alive for d in cells]
        self._np_divisions[new_idxs] = [d.n_divisions for d in cells]
        self._sync_positions()

        vals = np.stack([np.asarray(d.int_molecules, dtype=np.float32) for d in cells])
        new_cm = self._cell_molecules.clone()
        write_new_rows(
            new_cm[None],
            self._to_dev(np.array([n_old], dtype=np.int64)),
            self._to_dev(vals[None]),
            self._to_dev(np.array([n_new], dtype=np.int64)),
        )
        self._cell_molecules = new_cm

        if self._genome_store is not None:
            self._update_cell_params_rows(new_idxs, g_rows, g_lens)
        else:
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

    @_spanned("ms:divide")
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

        if self._genome_store is not None:
            # parent -> child copies stay on the device
            self._genome_store.copy_rows(parent_idxs, child_idxs)
        else:
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
        if self._genome_store is not None:
            # duplicate slots resolve before the scatter
            idxs_arr, genomes = _last_wins(
                [i for _, i in genome_idx_pairs], [g for g, _ in genome_idx_pairs]
            )
            g_rows, g_lens = self._genome_store.set_rows(idxs_arr.tolist(), genomes)
            self._update_cell_params_rows(idxs_arr, g_rows, g_lens)
            return
        for genome, idx in genome_idx_pairs:
            self._genomes_list[idx] = genome
        genomes, idxs = map(list, zip(*genome_idx_pairs))
        self._update_cell_params(genomes=genomes, idxs=idxs)

    @_spanned("ms:kill")
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
        if self._genome_store is not None:
            # the compaction permutation of every other cell tensor
            self._genome_store.permute(perm, n_keep)
        else:
            self._genomes_list = [
                g for i, g in enumerate(self._genomes_list) if i not in kill_set
            ]
        self.cell_labels = [
            lab for i, lab in enumerate(self.cell_labels) if i not in kill_set
        ]
        self.n_cells -= len(kill)

    def move_cells(self, cell_idxs: list[int] | None = None):
        """
        Move cells to a random free pixel in their Moore neighborhood
        (cells with no free neighbor stay); a pixel vacated in one round
        can be taken by another cell in a later one.
        """
        if cell_idxs is None:
            cell_idxs = list(range(self.n_cells))
        if len(cell_idxs) == 0:
            return
        cell_idxs = sorted(set(cell_idxs))
        self._place_in_neighborhood(np.asarray(cell_idxs, dtype=np.int64), vacate=True)
        self._sync_positions()

    def reposition_cells(self, cell_idxs: list[int] | None = None):
        """Teleport cells to random free pixels without changing them"""
        if cell_idxs is None:
            cell_idxs = list(range(self.n_cells))
        if len(cell_idxs) == 0:
            return
        cell_idxs = sorted(set(cell_idxs))
        old = self._np_positions[cell_idxs]
        self._np_cell_map[old[:, 0], old[:, 1]] = False
        new_pos = self._find_free_random_positions(n_cells=len(cell_idxs))
        self._np_cell_map[new_pos[:, 0], new_pos[:, 1]] = True
        self._np_positions[cell_idxs] = new_pos
        self._sync_positions()

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

    @property
    def use_pallas(self) -> bool:
        """Legacy spelling of ``integrator == "cuda"``, the counterpart of
        the JAX package's ``integrator == "pallas"`` (read-only)."""
        return self.integrator == "cuda"

    def integrator_inputs(self) -> tuple[torch.Tensor, CellParams]:
        """What the next :meth:`enzymatic_activity` hands the integrator:
        the signals ``X0`` ``(q, 2 * n_molecules)`` and the kinetic
        parameters, both over the live-row prefix ``q``."""
        if self._mesh is not None:
            # this rank's slot block (a mesh runs the whole capacity)
            X0, _ = _tiled.activity_inputs(
                self._mesh,
                self._block("_molecule_map"),
                self._block("_cell_molecules"),
                self._positions_dev,
            )
            return X0, self.kinetics.params
        q = quantize_rows(self.n_cells, self._capacity)
        return _integrator_inputs(
            self._molecule_map,
            self._cell_molecules,
            self._positions_dev,
            self.kinetics.params,
            q,
        )

    @_spanned("ms:activity")
    def enzymatic_activity(self, prefetch_column: int | None = None):
        """Catalyze reactions and transport for one time step; updates
        ``molecule_map`` and ``cell_molecules``.  With ``prefetch_column``,
        that molecule's column starts its device->host copy right away
        (a later :meth:`cell_molecule_column` picks it up).  Counts the
        integrator's calls, its kernel launches, and the rows and
        protein slots it was handed (``integrator.*``); where the kernel
        launched, also its parameter bytes in the kernel's layout, those
        its launch plan stages in shared memory, its launches by route
        (:func:`~magicsoup_tpu_torch.ops.cuda_integrate.route_bytes`), and
        the protein slots it was handed (``integrator.slots``, rows x p;
        the kernel counts those it walks on the device)."""
        if self.n_cells == 0:
            return
        has_col = prefetch_column is not None
        launches = _cuda_integrate.launches
        if self._mesh is not None:
            q = self._capacity // self._mesh.size
            self._mesh_activity()
            _runtime.note_program_shape(self._activity_variant_key(None, has_col))
        else:
            q = quantize_rows(self.n_cells, self._capacity)
            with self._ftz():
                self._molecule_map, self._cell_molecules = self._activity_at(q)
            _runtime.note_program_shape(self._activity_variant_key(q, has_col))
        launched = _cuda_integrate.launches - launches
        p = self.kinetics.params.Vmax.shape[1]
        _telemetry.count("integrator.calls")
        _telemetry.count("integrator.launches", launched)
        _telemetry.count("integrator.rows", q)
        _telemetry.count("integrator.p", p)
        if launched:
            self._count_route(p, q, launched)
        if has_col:
            self.prefetch_cell_molecule_column(prefetch_column)

    def _count_route(self, p: int, q: int, launched: int) -> None:
        """Count the integrator kernel's route for ``launched`` launches of
        ``q`` rows at ``p`` proteins: its plan is the launch's own
        (cached per shape)."""
        n = self.kinetics.params.N
        s = n.shape[-1]
        limit = _cuda_integrate.smem_limit(n.device.index)
        how = _cuda_integrate.launch_plan(p, s, limit)
        param, staged = _cuda_integrate.route_bytes(p, s, q, how.mask)
        _telemetry.count("integrator.param_bytes", launched * param)
        _telemetry.count("integrator.staged_bytes", launched * staged)
        _telemetry.count(f"integrator.{how.route}_launches", launched)
        _telemetry.count("integrator.slots", launched * q * p)

    def _activity_at(self, q: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The activity's new ``(molecule_map, cell_molecules)`` over the
        live-row prefix ``q``; the world's own tensors are left as they are."""
        return _enzymatic_activity(
            functools.partial(_backends.integrate, self.integrator),
            self._molecule_map,
            self._cell_molecules,
            self._positions_dev,
            self.n_cells,
            self.kinetics.params,
            q,
        )

    def prewarm_activity(self, *, q: int | None = None, has_col: bool = False) -> None:
        """Warm the activity's live-row-prefix variant ``q`` WITHOUT
        touching state, so a later :meth:`enzymatic_activity` at that rung
        starts warm (0 compiles under
        :func:`~magicsoup_tpu_torch.analysis.runtime.hot_path_guard`).
        ``q`` defaults to the rung the current population uses AND the one
        above it, as in the JAX package.

        In eager PyTorch "warm" means: the native libraries built
        (``cache.ensure_compile_cache``), the integrator kernel's
        shared-memory size set and the caching allocator grown for the
        variant — both by running the activity once on the current state
        and discarding the result, as the JAX package's warm program does
        (one integrator launch on a card) — and the variant noted warm in
        the compile census.  A no-op on a mesh or with 0 cells."""
        if self._mesh is not None or self.n_cells == 0:
            return
        if q is None:
            cur = quantize_rows(self.n_cells, self._capacity)
            self.prewarm_activity(q=cur, has_col=has_col)
            if (nxt := next_rung(cur, self._capacity)) != cur:
                self.prewarm_activity(q=nxt, has_col=has_col)
            return
        self._warm_activity(min(int(q), self._capacity))
        _runtime.note_program_shape(self._activity_variant_key(q, has_col))

    def _warm_activity(self, q: int) -> None:
        """The native builds, then the activity at ``q`` on the current
        state with its result discarded."""
        from magicsoup_tpu_torch.cache import ensure_compile_cache

        ensure_compile_cache(self.device)
        with self._ftz():
            self._activity_at(q)

    def _activity_variant_key(self, q: int | None, has_col: bool) -> tuple:
        """The activity's program shape in the compile census: the JAX
        package's ``(q, has_col, max_proteins, max_doms)`` with the device,
        the integrator and the signal count that shape every tensor."""
        return (
            "activity",
            str(self.device),
            self.integrator,
            2 * self.n_molecules,
            q,
            has_col,
            self.kinetics.max_proteins,
            self.kinetics.max_doms,
        )

    def wait_warm(self, timeout: float | None = None) -> None:
        """Return at once: :meth:`prewarm_activity` warms inline in the
        caller's thread (an eager launch costs microseconds to enqueue and
        no compile service stands behind it, so nothing is ever left warming
        in the background), which leaves nothing to wait for.  Kept for the
        JAX package's API."""

    def _mesh_activity(self) -> None:
        """Activity of a mesh-placed world: each rank integrates its slot
        block (:func:`~magicsoup_tpu_torch.parallel.tiled.sharded_activity`)."""
        mesh = self._mesh
        with self._ftz():
            mm, cm = _tiled.sharded_activity(
                mesh,
                functools.partial(_backends.integrate, self.integrator, mesh=mesh),
                self._block("_molecule_map"),
                self._block("_cell_molecules"),
                self._positions_dev,
                self.n_cells,
                self.kinetics.params,
            )
        self._set_blocks(mm, cm)

    @_spanned("ms:physics")
    def diffuse_molecules(self):
        """Let molecules diffuse over the map and permeate membranes for
        one time step."""
        self._diffuse_molecules()

    def _diffuse_molecules(self):
        if self._mesh is not None:
            with self._ftz():
                mm, cm = _tiled.sharded_diffuse_permeate(
                    self._mesh,
                    self._block("_molecule_map"),
                    self._block("_cell_molecules"),
                    self._positions_dev,
                    self.n_cells,
                    self._diff_kernels,
                    self._perm_factors,
                    self.deterministic,
                )
            self._set_blocks(mm, cm)
            return
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

    @_spanned("ms:physics")
    def degrade_molecules(self):
        """Degrade molecules everywhere by one time step"""
        self._degrade_molecules()

    def _degrade_molecules(self):
        with self._ftz():
            # elementwise: each rank's blocks under a mesh
            mm, cm = _diff.degrade(
                self._block("_molecule_map"),
                self._block("_cell_molecules"),
                self._degrad_factors,
            )
        self._set_blocks(mm, cm)

    @_spanned("ms:physics")
    def degrade_and_diffuse_molecules(self):
        """:meth:`degrade_molecules` followed by :meth:`diffuse_molecules`."""
        self._degrade_molecules()
        self._diffuse_molecules()

    def step_many(self, n_steps: int):
        """Run ``n_steps`` chemistry steps — each :meth:`enzymatic_activity`
        followed by :meth:`degrade_and_diffuse_molecules` — plus the
        matching lifetime increments.  The JAX package fuses them into one
        program; eager PyTorch enqueues them back to back without a host
        wait, with the same result as the serial calls."""
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        for _ in range(n_steps):
            self.enzymatic_activity()
            self.degrade_and_diffuse_molecules()
        self._np_lifetimes[: self.n_cells] += n_steps

    def increment_cell_lifetimes(self):
        """Increment ``cell_lifetimes`` by 1"""
        self._host_epoch += 1
        self._np_lifetimes[: self.n_cells] += 1

    # ------------------------------------------------------------------ #
    # evolution                                                          #
    # ------------------------------------------------------------------ #

    @_spanned("ms:mutate")
    def mutate_cells(
        self,
        cell_idxs: list[int] | None = None,
        p: float = 1e-6,
        p_indel: float = 0.4,
        p_del: float = 0.66,
    ):
        """Point-mutate cell genomes, then update changed cells"""
        seed = int(self._nprng.integers(2**63))
        if self._genome_store is not None:
            store = self._genome_store
            # regrow G before the live region reaches it, so the program's
            # capacity truncation stays a never-hit backstop
            store.maybe_regrow()
            live = np.zeros(store.capacity, dtype=bool)
            if cell_idxs is None:
                live[: self.n_cells] = True
            else:
                live[np.asarray(cell_idxs, dtype=np.int64)] = True
            tokens, lengths, changed = _genomes.point_mutations_tokens(
                store.tokens,
                store.lengths,
                p=p,
                p_indel=p_indel,
                p_del=p_del,
                seed=seed,
                live=live,
                det=self.deterministic,
            )
            store.apply(tokens, lengths)
            self._update_cell_params_tokens(np.nonzero(fetch_host(changed)[: self.n_cells])[0])
            return
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

    @_spanned("ms:recombinate")
    def recombinate_cells(self, cell_idxs: list[int] | None = None, p: float = 1e-7):
        """Recombinate genomes of neighboring cells, then update changed
        cells."""
        pair_arr = self._neighbor_pairs(cell_idxs=cell_idxs)
        seed = int(self._nprng.integers(2**63))
        if self._genome_store is not None:
            store = self._genome_store
            if len(pair_arr) == 0:
                return
            # a tail exchange can at most double a genome: pre-grow G so
            # the program's capacity clamp stays a never-hit backstop
            store.ensure_length_cap(_genomes.length_capacity(2 * store.max_length()))
            tokens, lengths, changed = _genomes.recombinations_tokens(
                store.tokens,
                store.lengths,
                pair_arr,
                p=p,
                seed=seed,
                det=self.deterministic,
            )
            store.apply(tokens, lengths)
            self._update_cell_params_tokens(np.nonzero(fetch_host(changed)[: self.n_cells])[0])
            return
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

    # graftlint: hot
    def _update_cell_params(self, genomes: list[str], idxs: list[int]):
        """Translate genomes (through the phenotype cache) and write
        kinetic parameters for these cells; duplicate slots: last wins."""
        if len(idxs) == 0:
            return
        idxs_arr, genomes = _last_wins(idxs, genomes)
        with self.telemetry.span("ms:translate"):
            entries = self.phenotypes.lookup(genomes)
        self._apply_phenotype_entries(idxs_arr, entries)

    # graftlint: hot
    def _update_cell_params_tokens(self, idxs):
        """Parameter update for store rows already on the device (the
        programs' changed rows): one cached host snapshot of the store,
        then hash-keyed translation; only cache misses decode."""
        idxs_arr = np.unique(np.asarray(idxs, dtype=np.int32))
        if len(idxs_arr) == 0:
            return
        tokens, lengths = self._genome_store.host_arrays()
        with self.telemetry.span("ms:translate"):
            entries = self.phenotypes.lookup_tokens(tokens, lengths, idxs_arr.tolist())
        self._apply_phenotype_entries(idxs_arr, entries)

    # graftlint: hot
    def _update_cell_params_rows(self, idxs, rows, lens):
        """Parameter update from freshly encoded host rows (the string
        import boundary: spawn, update): hashes come straight from the
        rows, with no device round trip."""
        idxs_arr = np.asarray(idxs, dtype=np.int32)
        if len(idxs_arr) == 0:
            return
        with self.telemetry.span("ms:translate"):
            entries = self.phenotypes.lookup_tokens(rows, lens)
        self._apply_phenotype_entries(idxs_arr, entries)

    # graftlint: hot
    @_spanned("ms:assemble")
    def _apply_phenotype_entries(self, idxs_arr: np.ndarray, entries) -> None:
        """The shared tail of the parameter updates: unset empty
        proteomes, grow the token limits for the whole dispatch, pack in
        chunks of ``batch_size``."""
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

    def convert_genome_backend(self, backend: str) -> None:
        """Switch genome storage in place: ``"token"`` packs the host
        string list into a device store, ``"string"`` decodes it back.
        Phenotypes and kinetics are untouched: both backends derive the
        same parameters from the same genomes."""
        if backend not in ("string", "token"):
            raise ValueError(f"genome_backend must be 'string' or 'token', got {backend!r}")
        if backend == self.genome_backend:
            return
        if backend == "token":
            store = _genomes.GenomeStore(
                max(self._capacity, _MIN_CAPACITY), device=self.device, mesh=self._mesh
            )
            store.set_all(self._genomes_list)
            self._genome_store = store
            self._genomes_list = []
        else:
            self._genomes_list = list(self._genome_store.decoded(self.n_cells))
            self._genome_store = None
        self.genome_backend = backend
        self._host_epoch += 1

    # ------------------------------------------------------------------ #
    # persistence                                                        #
    # ------------------------------------------------------------------ #

    #: device tensors that a pickle holds as host numpy
    _PICKLED_TENSORS = (
        "_cell_molecules",
        "_molecule_map",
        "_diff_kernels",
        "_perm_factors",
        "_degrad_factors",
    )

    def __getstate__(self) -> dict:
        """Device tensors go to host numpy and the device to its string;
        the position mirror (rebuilt from the host positions), the column
        prefetch (a pinned buffer and a CUDA event) and the snapshot
        caches are left out.  The phenotype cache pickles itself without
        entries, the genome store and the kinetics their tensors as
        numpy.  The Python and numpy RNG states are kept, so a restored
        world draws what the original would have drawn."""
        state = self.__dict__.copy()
        for name in self._PICKLED_TENSORS:
            state[name] = fetch_host(getattr(self, name))
        state.pop("_positions_dev")
        state.pop("_col_prefetch")
        state["_mm_cache"] = None
        state["_cm_cache"] = None
        state["device"] = str(self.device)
        # a mesh is bound to a live process group: a pickle is mesh-free
        # (restore_run(mesh=) places a restored world again)
        state["_mesh"] = None
        return state

    def __setstate__(self, state: dict):
        # a legacy (schema-1) pickle holds the genome list under the name
        # that is a property now, and no genome backend: adopt it as a
        # string world
        legacy_genomes = state.pop("cell_genomes", None)
        self.__dict__.update(state)
        self.__dict__.setdefault("genome_backend", "string")
        self.__dict__.setdefault("_genome_store", None)
        self.__dict__.setdefault("_genomes_list", [])
        self.__dict__.setdefault("_host_epoch", 0)
        self.__dict__.setdefault("_mesh", None)
        if legacy_genomes is not None:
            self._genomes_list = list(legacy_genomes)
        # recorders pickle themselves detached (no file handle survives a
        # save); a pickle from before the recorder gets a fresh one
        if self.__dict__.get("telemetry") is None:
            from magicsoup_tpu_torch.telemetry import TelemetryRecorder

            self.telemetry = TelemetryRecorder()
        self.device = restored_device(state["device"], "World")
        for name in self._PICKLED_TENSORS:
            setattr(self, name, self._to_dev(state[name]))
        self._col_prefetch = None
        self._sync_positions()

    def save(self, rundir: Path, name: str = "world.pkl"):
        """
        Write the whole world (chemistry, genetics, kinetics, state, RNG
        states) to a pickle; restore it with :meth:`from_file`.  The
        write is atomic (:mod:`magicsoup_tpu_torch.guard.io`): a crash
        mid-save leaves the previous file whole.  For small per-step
        snapshots use :meth:`save_state`.
        """
        atomic_write_bytes(Path(rundir) / name, pickle.dumps(self))

    @classmethod
    def from_file(
        cls,
        rundir: Path,
        name: str = "world.pkl",
        device: str | torch.device | None = None,
    ) -> "World":
        """Restore a world saved with :meth:`save` onto ``device``:
        ``None`` means ``"cuda"``; pass ``"cpu"`` to load onto the CPU,
        wherever the world was saved.  A truncated or garbled file is a
        :class:`~magicsoup_tpu_torch.guard.errors.CheckpointError` with
        ``check="truncated"``."""
        dev = resolve_device(device, "World.from_file")
        path = Path(rundir) / name
        data = path.read_bytes()
        try:
            with restore_device(dev):
                return pickle.loads(data)
        except (EOFError, pickle.UnpicklingError) as exc:
            raise CheckpointError(
                f"world pickle {path} is truncated or corrupt ({exc}); "
                "recover from an older snapshot",
                check="truncated",
                path=path,
            ) from exc

    def save_state(self, statedir: Path):
        """
        Lightweight per-step checkpoint: the mutable state as ``.npy``
        files plus a FASTA of genomes and labels, the JAX package's file
        set byte for byte, so a state directory written by one package
        loads into the other.
        """

        def np_save(name: str, arr: np.ndarray) -> None:
            buf = io.BytesIO()
            np.save(buf, arr)
            atomic_write_bytes(statedir / name, buf.getvalue())

        statedir = Path(statedir)
        statedir.mkdir(parents=True, exist_ok=True)
        n = self.n_cells
        np_save("cell_molecules.npy", fetch_host(self._cell_molecules)[:n])
        np_save("cell_map.npy", self._np_cell_map)
        np_save("molecule_map.npy", fetch_host(self._molecule_map))
        np_save("cell_lifetimes.npy", self._np_lifetimes[:n])
        np_save("cell_positions.npy", self._np_positions[:n])
        np_save("cell_divisions.npy", self._np_divisions[:n])
        lines = [
            f">{idx} {label}\n{genome}"
            for idx, (genome, label) in enumerate(zip(self.cell_genomes, self.cell_labels))
        ]
        atomic_write_text(statedir / "cells.fasta", "\n".join(lines))

    def load_state(self, statedir: Path, ignore_cell_params: bool = False):
        """
        Restore a state saved with :meth:`save_state`.  Unless
        ``ignore_cell_params`` is set, all cells are killed first and all
        genomes re-translated afterwards (a full parameter update).
        """
        statedir = Path(statedir)
        if not ignore_cell_params:
            self.kill_cells(cell_idxs=list(range(self.n_cells)))

        cm = np.load(statedir / "cell_molecules.npy")
        self._np_cell_map = np.load(statedir / "cell_map.npy")
        self._molecule_map = self._to_dev(np.load(statedir / "molecule_map.npy"))
        lifetimes = np.load(statedir / "cell_lifetimes.npy")
        positions = np.load(statedir / "cell_positions.npy")
        divisions = np.load(statedir / "cell_divisions.npy")

        with open(statedir / "cells.fasta", encoding="utf-8") as fh:
            entries = [d.strip() for d in fh.read().split(">") if len(d.strip()) > 0]
        genomes: list[str] = []
        labels: list[str] = []
        for entry in entries:
            parts = entry.split("\n")
            names = parts[0].split()
            genomes.append("" if len(parts) < 2 else parts[1])
            labels.append(names[1].strip() if len(names) > 1 else "")
        self.cell_labels = labels

        n = len(genomes)
        self.n_cells = 0
        self._ensure_capacity(n)
        # genomes go in AFTER the capacity grow: the token store's setter
        # scatters into slots that must already exist
        self.cell_genomes = genomes
        self.n_cells = n
        self._np_positions[:n] = positions
        self._np_positions[n:] = 0
        self._np_lifetimes[:n] = lifetimes
        self._np_lifetimes[n:] = 0
        self._np_divisions[:n] = divisions
        self._np_divisions[n:] = 0
        self._sync_positions()
        full_cm = np.zeros((self._capacity, self.n_molecules), dtype=np.float32)
        full_cm[:n] = cm
        self._cell_molecules = self._to_dev(full_cm)

        if not ignore_cell_params:
            self.update_cells(genome_idx_pairs=[(g, i) for i, g in enumerate(genomes)])

    def __repr__(self) -> str:
        kwargs = {
            "map_size": self.map_size,
            "abs_temp": self.abs_temp,
            "device": str(self.device),
        }
        args = [f"{k}:{repr(d)}" for k, d in kwargs.items()]
        return f"{type(self).__name__}({','.join(args)})"
