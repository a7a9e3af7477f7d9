"""
Tile-sharded world stepping over a 1D mesh of ranks (``torch.distributed``).
Counterpart of :mod:`magicsoup_tpu.parallel.tiled`.

One process drives one tile.  The molecule map is split by rows (rank r
holds rows ``[r * m / n, (r + 1) * m / n)``), every cell-axis tensor by
slots (rank r holds slots ``[r * cap / n, (r + 1) * cap / n)``, the nine
kinetic parameter tensors included), and the host state (positions, the
cell map, lifetimes, genomes of a string world) is replicated: every rank
takes the same host decisions from the World's seed, so the ranks stay in
lockstep and only tensors cross between them.

The JAX package leaves the cell<->map exchange to GSPMD; here each piece
is explicit, and where GSPMD would all-gather, the rank all-gathers, runs
the single-device code and keeps its own block, so every step is
bit-identical to the single-device one in deterministic mode:

- activity: the rank gathers the map (its cells sit on pixels of any
  tile), integrates its own slot block (one kernel launch per rank; the
  torch integrators all-reduce their early-stop count, so the stop stays
  batch-global), and all-gathers the cells' deltas, which every rank adds
  to the map in the single-device order before keeping its rows (a pixel
  holds at most one cell, so the other rows add exact zeros);
- diffusion: :func:`halo_diffuse`, the stencil on the rank's rows plus
  one halo row from each torus neighbour (an all-gather of the edge
  rows), with the mass fixup of the single-device step: in deterministic
  mode over the all-gathered rows (the fixed fold-in-half tree cannot be
  split into per-tile trees), in fast mode per-tile totals and an
  all-reduce;
- row moves across tile boundaries (compaction, division, capacity
  growth) gather the rows they need (:func:`gather_rows`,
  :func:`take_rows`).

The backend is chosen when the group is joined (:mod:`~.multihost`) and
recorded on the :class:`Mesh`: NCCL when every rank has a card of its
own; gloo when ranks share a card or run on the CPU.  gloo moves host
memory, so on a card its collectives stage each tensor through pinned
host buffers (``Mesh.staged``) — part of that route's design, and a
synchronization per collective.  Every collective is counted
(``analysis.runtime.collective_stats``).
"""
import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from magicsoup_tpu_torch import util as _util
from magicsoup_tpu_torch.analysis import runtime as _runtime
from magicsoup_tpu_torch.ops import detmath as _det
from magicsoup_tpu_torch.ops import diffusion as _diff
from magicsoup_tpu_torch.ops.detmath import flush_denormal
from magicsoup_tpu_torch.ops.integrate import CellParams

TILE_AXIS = "tile"


class Mesh:
    """A 1D mesh: the ranks of one process group along one named axis.

    Holds the group (``None``: the default group), this process's
    ``rank`` and the group's ``size``, the ``device`` this rank's tensors
    live on and the group's ``backend``.  ``staged`` is true where the
    backend moves host memory and the tensors live on a card (gloo on a
    card): each collective then copies through pinned host buffers.
    ``device=None`` is this rank's card (:func:`default_device`).  A mesh
    is bound to a live process group, so it does not pickle."""

    def __init__(self, group=None, *, axis_name: str = TILE_AXIS, device=None):
        self.group = group
        self.axis_name = str(axis_name)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device) if device is not None else default_device("Mesh")
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL mesh needs each rank on a CUDA device")
        self.staged = self.backend != "nccl" and self.device.type == "cuda"

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis_name,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_name: self.size}

    def __reduce__(self):
        raise TypeError("a Mesh is bound to a live process group and does not pickle")

    def __repr__(self) -> str:
        return (
            f"Mesh({self.axis_name}={self.size}, rank={self.rank},"
            f" backend={self.backend!r}, device={str(self.device)!r})"
        )

    # -- blocks --------------------------------------------------------- #

    def block(self, n: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of an axis of ``n`` entries."""
        if n % self.size:
            # graftlint: disable=GL022 shape precondition of every mesh op, not a checkpoint policy decision
            raise ValueError(f"an axis of {n} does not split over {self.size} ranks")
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """A copy of this rank's block of ``t`` along ``dim``."""
        lo, hi = self.block(t.shape[dim])
        return t.narrow(dim, lo, hi - lo).clone()

    # -- collectives ---------------------------------------------------- #

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order.  A
        byte move of any dtype; every rank passes the same shape."""
        if self.size == 1:
            return t.clone()
        t0 = time.perf_counter()
        src = t.contiguous()
        shape = list(src.shape)
        if src.numel() == 0:
            shape[dim] *= self.size
            return src.new_zeros(shape)
        flat = src.reshape(-1).view(torch.uint8)
        if self.staged:
            host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(flat)
            flat = host
        outs = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(outs, flat, group=self.group)
        out = torch.cat([o.view(src.dtype).reshape(src.shape) for o in outs], dim=dim)
        if self.staged:
            out = out.to(self.device)
        _runtime.note_collective(out.numel() * out.element_size(), time.perf_counter() - t0)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor)."""
        if self.size == 1:
            return t.clone()
        t0 = time.perf_counter()
        buf = t.detach().to("cpu", copy=True) if self.staged else t.detach().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        if self.staged:
            buf = buf.to(self.device)
        _runtime.note_collective(buf.numel() * buf.element_size(), time.perf_counter() - t0)
        return buf


def default_device(owner: str = "make_mesh") -> torch.device:
    """This rank's card: ``LOCAL_RANK`` (else the rank) modulo the cards on
    the host, so ranks beyond the count share one.  The port's device
    rule holds (``util.resolve_device``): without a card this raises a
    ``RuntimeError`` naming ``device='cpu'``, the caller's way to run
    the mesh on the CPU."""
    _util.resolve_device(None, owner)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(
    n_devices: int | None = None, *, axis_name: str = TILE_AXIS, device=None
) -> "Mesh | None":
    """1D mesh over the joined process group's ranks, in rank order (the
    map's row axis and the cell axis).  ``n_devices`` keeps the first n
    ranks: every rank must call it, and the others get ``None``.
    ``device`` defaults to this rank's card (:func:`default_device`)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: join one first (parallel.multihost.initialize())"
        )
    group = None
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        if not 1 <= n_devices <= world:
            raise ValueError(f"n_devices={n_devices} outside 1..{world}")
        group = dist.new_group(list(range(n_devices)))
        if dist.get_rank() >= n_devices:
            return None
    return Mesh(
        group,
        axis_name=axis_name,
        device=device if device is not None else default_device("make_mesh"),
    )


def map_block(mesh: Mesh, map_size: int) -> tuple[int, int]:
    """The rank's ``[lo, hi)`` map rows (the JAX package's
    ``map_sharding``: rows over the mesh axis)."""
    return mesh.block(map_size)


def cell_block(mesh: Mesh, capacity: int) -> tuple[int, int]:
    """The rank's ``[lo, hi)`` cell slots (``cell_sharding``)."""
    return mesh.block(capacity)


def shard_params(params: CellParams, mesh: Mesh) -> CellParams:
    """The rank's slot block of the nine kinetic parameter tensors."""
    return CellParams(*(mesh.local(t, 0) for t in params))


def sharded_attr(name: str, dim: int) -> property:
    """A tensor attribute of an object with a ``_mesh``: stored as this
    rank's block along ``dim``, read as the global tensor (every rank's
    block all-gathered), and assigned a global tensor of which the rank
    keeps its block.  Without a mesh it is a plain attribute.  Reads and
    writes are collective: every rank makes them in the same order."""

    def get(self):
        t = self.__dict__[name]
        mesh = self.__dict__.get("_mesh")
        return t if mesh is None else mesh.all_gather(t, dim)

    def set(self, value):
        mesh = self.__dict__.get("_mesh")
        self.__dict__[name] = value if mesh is None else mesh.local(value, dim)

    return property(get, set, doc=f"the global ``{name}`` (a block per rank under a mesh)")


# --------------------------------------------------------------------- #
# rows across tile boundaries                                           #
# --------------------------------------------------------------------- #


def gather_rows(mesh: Mesh, local: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global slot indices, any shape, the same on every
    rank) of the slot-sharded tensor whose block is ``local``, on every
    rank: each rank fills the rows it owns, one all-gather, and each row
    is taken from its owner — a selection, so no bit changes.  Shapes are
    static (no host synchronization)."""
    blk = local.shape[0]
    lo = mesh.rank * blk
    flat = idx.reshape(-1)
    rel = flat - lo
    own = (rel >= 0) & (rel < blk)
    vals = local[rel.clamp(0, blk - 1)]
    vals = torch.where(own.view((-1,) + (1,) * (local.ndim - 1)), vals, torch.zeros_like(vals))
    every = mesh.all_gather(vals[None], 0)  # (n, k, ...)
    owner = (flat // blk).clamp(0, mesh.size - 1)
    out = every[owner, torch.arange(flat.shape[0], device=flat.device)]
    return out.reshape(tuple(idx.shape) + tuple(local.shape[1:]))


def take_rows(mesh: Mesh, local: torch.Tensor, src) -> torch.Tensor:
    """This rank's block of ``global[src]``, ``src`` being a host
    ``(cap,)`` source slot per destination slot (a compaction
    permutation), the same on every rank.  Rows that stay on their rank
    move locally; the rows that cross a boundary travel in one
    all-gather, each owner sending only its own."""
    src = np.asarray(src, dtype=np.int64)
    blk = local.shape[0]
    n, r = mesh.size, mesh.rank
    lo = r * blk
    mine = src[lo : lo + blk]
    cross_all = src[(src // blk) != (np.arange(src.shape[0]) // blk)]
    need = np.unique(cross_all)
    owner = need // blk
    width = int(np.bincount(owner, minlength=n).max()) if len(need) else 0
    dev = local.device
    if width == 0:
        return local[_util.to_device(mine - lo, dev)]
    sent = need[owner == r]
    payload = local.new_zeros((width,) + tuple(local.shape[1:]))
    if len(sent):
        payload[: len(sent)] = local[_util.to_device(sent - lo, dev)]
    every = mesh.all_gather(payload, 0)  # (n * width, ...)
    # each crossing row's place in its owner's payload
    first = np.searchsorted(owner, np.arange(n))
    slot = owner * width + (np.arange(len(need)) - first[owner])
    here = (mine // blk) == r
    pick = np.where(
        here, mine - lo, blk + slot[np.searchsorted(need, np.where(here, need[0], mine))]
    )
    return torch.cat([local, every])[_util.to_device(pick, dev)]


def compact_block(mesh: Mesh, local: torch.Tensor, perm, n_keep: int) -> torch.Tensor:
    """This rank's block of a stable compaction (``compact_rows``) by a
    host permutation: :func:`take_rows`, then the rows at or past
    ``n_keep`` zeroed."""
    lo = mesh.rank * local.shape[0]
    drop = torch.arange(lo, lo + local.shape[0], device=local.device) >= n_keep
    return take_rows(mesh, local, perm).masked_fill(
        drop.view((-1,) + (1,) * (local.ndim - 1)), 0
    )


def grow_rows(mesh: Mesh, local: torch.Tensor, new_cap: int) -> torch.Tensor:
    """This rank's block of a slot-sharded tensor grown to ``new_cap``
    slots (the old rows first, zeros after): the block boundaries move,
    so the old tensor is all-gathered once (growth is rare)."""
    full = mesh.all_gather(local, 0)
    out = full.new_zeros((new_cap,) + tuple(full.shape[1:]))
    out[: full.shape[0]] = full
    return mesh.local(out, 0)


# --------------------------------------------------------------------- #
# the sharded physics                                                   #
# --------------------------------------------------------------------- #


def _halo_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``local`` (C, h, m) with the torus neighbours' edge rows above and
    below, from one all-gather of every rank's first and last row."""
    edges = mesh.all_gather(torch.stack([local[:, 0], local[:, -1]])[None], 0)
    n, r = mesh.size, mesh.rank
    above = edges[(r - 1) % n, 1]  # the last row of the tile above
    below = edges[(r + 1) % n, 0]  # the first row of the tile below
    return torch.cat([above[:, None], local, below[:, None]], dim=1)


def _stencil_rows(rows: torch.Tensor, kernels: torch.Tensor, h: int) -> torch.Tensor:
    """:func:`~magicsoup_tpu_torch.ops.diffusion.stencil_3x3` over ``h``
    rows given with one halo row on each side: the same 9 taps in the
    same order (tap (i, j) reads row x + i - 1, column y + j - 1)."""
    out = torch.zeros_like(rows[:, :h])
    for i in range(3):
        for j in range(3):
            out = out + kernels[:, i, j][:, None, None] * torch.roll(
                rows[:, i : i + h], shifts=1 - j, dims=2
            )
    return out


def halo_diffuse(
    molecule_map: torch.Tensor, kernels: torch.Tensor, mesh: Mesh, det: bool = False
) -> torch.Tensor:
    """One diffusion step on this rank's row block ``(C, m / n, m)`` of
    the map: the stencil on the rank's rows plus one halo row from each
    torus neighbour, then the single-device mass fixup — over the
    all-gathered rows in deterministic mode (bit-equal to
    :func:`~magicsoup_tpu_torch.ops.diffusion.diffuse`), from per-tile
    totals and an all-reduce in fast mode.  One tile is ``diffuse``."""
    if mesh is None or mesh.size == 1:
        return _diff.diffuse(molecule_map, kernels, det=det)
    h, m = molecule_map.shape[1], molecule_map.shape[2]
    rows = _halo_rows(molecule_map, mesh)
    if det:
        with flush_denormal(molecule_map.device):
            total_before = _det.sum_hw(mesh.all_gather(molecule_map, 1))
            out = _stencil_rows(
                # graftlint: disable=GL003 sanctioned det-mode f64, as the JAX package's det path
                rows.to(torch.float64), kernels.to(torch.float64), h
            ).to(torch.float32)
            total_after = _det.sum_hw(mesh.all_gather(out, 1))
            fix = _det.det_div(
                total_before - total_after, torch.tensor(float(m * m), device=out.device)
            )
            return torch.clamp(out + fix[:, None, None], min=0.0)
    total_before = mesh.all_reduce(_det.sum_hw(molecule_map))
    out = _stencil_rows(rows, kernels, h)
    total_after = mesh.all_reduce(_det.sum_hw(out))
    fix = (total_before - total_after) / (m * m)
    return torch.clamp(out + fix[:, None, None], min=0.0)


def _map_add(full: torch.Tensor, pos: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``full.at[:, xs, ys].add(values)`` (values ``(C, cap)``), as the
    World's single-device scatter-add."""
    mols = torch.arange(full.shape[0], device=full.device)
    return full.index_put(
        (mols[:, None], pos[None, :, 0], pos[None, :, 1]), values, accumulate=True
    )


def activity_inputs(mesh, mm, cm, pos):
    """The integrator's signals on this rank: its slot block's ``X0``
    (intracellular, then the pixel's extracellular, read from the
    gathered map), and the gathered map."""
    lo, hi = mesh.block(pos.shape[0])
    full = mesh.all_gather(mm, 1)
    ext = full[:, pos[lo:hi, 0], pos[lo:hi, 1]].T
    return torch.cat([cm, ext], dim=1).contiguous(), full


def sharded_activity(mesh, integrate, mm, cm, pos, n_cells: int, params):
    """Enzymatic activity of a tile-sharded world: ``mm`` the rank's map
    rows, ``cm`` and ``params`` its slot block, ``pos`` every slot's
    position (replicated).  Returns the new ``(mm, cm)`` blocks."""
    lo, hi = mesh.block(pos.shape[0])
    n_mols = cm.shape[1]
    X0, full = activity_inputs(mesh, mm, cm, pos)
    X1 = integrate(X0, params)
    ext = X0[:, n_mols:]
    alive = (torch.arange(lo, hi, device=cm.device) < n_cells)[:, None]
    new_cm = torch.where(alive, X1[:, :n_mols], cm)
    delta = mesh.all_gather(torch.where(alive, X1[:, n_mols:] - ext, torch.zeros_like(ext)), 0)
    return mesh.local(_map_add(full, pos, delta.T), 1), new_cm


def sharded_diffuse_permeate(mesh, mm, cm, pos, n_cells: int, kernels, perm_factors, det):
    """Diffusion (:func:`halo_diffuse`) then membrane permeation of a
    tile-sharded world; returns the new ``(mm, cm)`` blocks."""
    lo, hi = mesh.block(pos.shape[0])
    new_mm = halo_diffuse(mm, kernels, mesh, det=det)
    if n_cells == 0:
        return new_mm, cm
    full = mesh.all_gather(new_mm, 1)
    ext = full[:, pos[lo:hi, 0], pos[lo:hi, 1]].T
    new_cm, new_ext = _diff.permeate(cm, ext, perm_factors, det=det)
    alive = (torch.arange(lo, hi, device=cm.device) < n_cells)[:, None]
    new_cm = torch.where(alive, new_cm, cm)
    delta = mesh.all_gather(torch.where(alive, new_ext - ext, torch.zeros_like(ext)), 0)
    return mesh.local(_map_add(full, pos, delta.T), 1), new_cm


def make_sharded_step(
    mesh: Mesh,
    kernels: torch.Tensor,
    perm_factors: torch.Tensor,
    degrad_factors: torch.Tensor,
    det: bool = False,
    integrator: str | None = None,
):
    """The one-step simulation function of a tile-sharded world:
    enzymatic activity (each rank integrates its slot block), halo
    diffusion, membrane permeation and degradation.  ``step(mm, cm, pos,
    n_cells, params)`` takes the rank's map rows, its cell slot block, all
    positions ``(cap, 2)``, the cell count and the rank's parameter block,
    and returns the new ``(mm, cm)`` blocks.  ``integrator`` defaults to
    the numeric mode's backend on ``mesh.device``."""
    from magicsoup_tpu_torch.ops import backends as _backends

    name = integrator or _backends.default_backend(det, mesh.device.type)

    def integrate(X, params):
        return _backends.integrate(name, X, params, mesh=mesh)

    def step(mm, cm, pos, n_cells, params):
        n_cells = int(n_cells)
        with flush_denormal(cm.device) if det else contextlib.nullcontext():
            mm, cm = sharded_activity(mesh, integrate, mm, cm, pos, n_cells, params)
            mm, cm = sharded_diffuse_permeate(
                mesh, mm, cm, pos, n_cells, kernels, perm_factors, det
            )
            return _diff.degrade(mm, cm, degrad_factors)

    return step


def shard_world_state(world, mesh: Mesh):
    """This rank's blocks of a single-device :class:`World`'s state — map
    rows, cell slots, all positions and the parameter block — for
    :func:`make_sharded_step`, without changing the world."""
    mm = mesh.local(world._molecule_map.to(mesh.device), 1)
    cm = mesh.local(world._cell_molecules.to(mesh.device), 0)
    pos = world._positions_dev.to(mesh.device)
    params = shard_params(CellParams(*(t.to(mesh.device) for t in world.kinetics.params)), mesh)
    return mm, cm, pos, params
