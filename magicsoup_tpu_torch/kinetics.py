"""
Protein kinetics: random genotype->phenotype token maps and the per-cell
parameter tensors.

Counterpart of :mod:`magicsoup_tpu.kinetics`.  Same state semantics — 9
tensors over (c cells, p proteins, s = 2 * n_molecules signals): ``Ke,
Kmf, Kmb, Vmax`` (c,p) f32, ``Kmr`` (c,p,s) f32, ``N, Nf, Nb, A`` (c,p,s)
i16 — and the same seeded token->parameter sampling (the factories below
are the JAX package's numpy code), so one seed gives the same tables.

The tensors live on ``device`` at slot capacity; dead slots are all-zero
rows and inert.  Parameter assembly groups cells by their rung (the pow2
of their own protein count and domains per protein) and assembles each
group at that rung, as the JAX package does, writing rows in place.
"""
import math
import random

import numpy as np
import torch

from magicsoup_tpu_torch.constants import ProteinSpecType
from magicsoup_tpu_torch.containers import Chemistry, Molecule, Protein
from magicsoup_tpu_torch.native import pack_dense
from magicsoup_tpu_torch.ops.integrate import INT_PARAM_DTYPE, CellParams
from magicsoup_tpu_torch.ops.params import (
    IDX_BLOCK,
    RUNG_D_MIN,
    RUNG_P_MIN,
    TokenTables,
    assemble_rows,
    copy_rows,
    pad_pow2,
    permute_params,
    rung_pow2,
    unset_rows,
)
from magicsoup_tpu_torch.util import resolve_device


def _gather_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(start, start + count)`` runs — the
    vectorized flat-buffer row gather of the rung-grouped assembly."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    starts = np.asarray(starts, dtype=np.int64)
    return np.repeat(starts - (ends - counts), counts) + np.arange(total)


def _token_rng(rng: random.Random) -> np.random.Generator:
    """Derive a numpy Generator for vectorized table sampling from the
    instance's seeded ``random.Random``."""
    return np.random.default_rng(rng.randrange(2**63))


class _HillMapFact:
    """Token -> 1,2,3,4,5 with chances 52/26/13/6/3% respectively"""

    _HILL_P = np.array([16.0, 8.0, 4.0, 2.0, 1.0]) / 31.0  # hill = 1..5

    def __init__(self, rng: random.Random, max_token: int, zero_value: int = 0):
        drawn = _token_rng(rng).choice(
            np.arange(1, 6), size=max_token, p=self._HILL_P
        )
        self.numbers = np.concatenate([[zero_value], drawn]).astype(np.int32)

    def __call__(self, t: np.ndarray) -> np.ndarray:
        return self.numbers[t]

    def inverse(self) -> dict[int, list[int]]:
        out = {}
        for v in (1, 3, 5):
            out[v] = np.argwhere(self.numbers == v).flatten().tolist()
        return out


class _LogNormWeightMapFact:
    """Token -> float sampled from a range-rejected log-normal distribution"""

    def __init__(
        self,
        rng: random.Random,
        max_token: int,
        weight_range: tuple[float, float],
        zero_value: float = math.nan,
    ):
        lo, hi = sorted(weight_range)
        mu = (math.log(lo) + math.log(hi)) / 2.0
        sig = math.log(hi) - math.log(lo)
        nprng = _token_rng(rng)
        # vectorized rejection: redraw the whole remainder until full
        # (the acceptance rate is ~2/3, so this converges in a few rounds)
        vals = np.empty(max_token, dtype=np.float64)  # host precompute, stored f32
        n_ok = 0
        while n_ok < max_token:
            draw = np.exp(nprng.normal(mu, sig, size=max_token - n_ok))
            draw = draw[(draw >= lo) & (draw <= hi)]
            vals[n_ok : n_ok + len(draw)] = draw
            n_ok += len(draw)
        self.weights = np.concatenate([[zero_value], vals]).astype(np.float32)

    def __call__(self, t: np.ndarray) -> np.ndarray:
        return self.weights[t]

    def inverse(self) -> dict[float, list[int]]:
        out: dict[float, list[int]] = {}
        for i in range(1, len(self.weights)):
            out.setdefault(float(self.weights[i]), []).append(i)
        return out


class _SignMapFact:
    """Token -> +1 or -1 with 50% probability each"""

    def __init__(self, rng: random.Random, max_token: int, zero_value: int = 0):
        drawn = np.where(_token_rng(rng).random(max_token) < 0.5, 1, -1)
        self.signs = np.concatenate([[zero_value], drawn]).astype(np.int32)

    def __call__(self, t: np.ndarray) -> np.ndarray:
        return self.signs[t]

    def inverse(self) -> dict[bool, list[int]]:
        return {
            True: np.argwhere(self.signs == 1).flatten().tolist(),
            False: np.argwhere(self.signs == -1).flatten().tolist(),
        }


class _VectorMapFact:
    """Token -> one of a list of vectors, each mapped with equal frequency"""

    def __init__(
        self,
        rng: random.Random,
        max_token: int,
        n_signals: int,
        vectors: list[list[int]],
        zero_value: int = 0,
    ):
        M = np.full((max_token + 1, n_signals), zero_value, dtype=np.int32)
        if len(vectors) == 0:
            self.M = M
            return

        V = np.asarray(vectors, dtype=np.int32)
        if V.ndim != 2 or V.shape[1] != n_signals:
            raise ValueError(
                f"every vector must have one entry per signal ({n_signals})"
            )
        if len(V) > max_token:
            raise ValueError(
                f"{len(V)} vectors cannot all get a token: only"
                f" {max_token} tokens are available"
            )
        if (V == 0).all(axis=1).any():
            raise ValueError("all-zero vectors cannot be mapped to tokens")

        M[1:] = V[_token_rng(rng).integers(0, len(V), size=max_token)]
        self.M = M

    def __call__(self, t: np.ndarray) -> np.ndarray:
        return self.M[t]


class _ReactionMapFact(_VectorMapFact):
    """Token -> signed stoichiometry vector of one reaction over 2n signals"""

    def __init__(
        self,
        rng: random.Random,
        molmap: dict[Molecule, int],
        reactions: list[tuple[list[Molecule], list[Molecule]]],
        max_token: int,
        zero_value: int = 0,
    ):
        n_signals = 2 * len(molmap)
        vectors = [[0] * n_signals for _ in range(len(reactions))]
        for ri, (lft, rgt) in enumerate(reactions):
            for mol in lft:
                vectors[ri][molmap[mol]] -= 1
            for mol in rgt:
                vectors[ri][molmap[mol]] += 1
        super().__init__(
            rng=rng,
            vectors=vectors,
            n_signals=n_signals,
            max_token=max_token,
            zero_value=zero_value,
        )

    def inverse(
        self,
        molmap: dict[Molecule, int],
        reactions: list[tuple[list[Molecule], list[Molecule]]],
        n_signals: int,
    ) -> dict[tuple[tuple[Molecule, ...], tuple[Molecule, ...]], list[int]]:
        react_map = {}
        for subs, prods in reactions:
            t = np.zeros(n_signals, dtype=np.int32)
            for sub in subs:
                t[molmap[sub]] -= 1
            for prod in prods:
                t[molmap[prod]] += 1
            idxs = np.argwhere((self.M == t).all(axis=1)).flatten().tolist()
            react_map[(tuple(subs), tuple(prods))] = idxs
        return react_map


class _TransporterMapFact(_VectorMapFact):
    """Token -> transport vector (-1 intracellular, +1 extracellular)"""

    def __init__(
        self,
        rng: random.Random,
        n_molecules: int,
        max_token: int,
        zero_value: int = 0,
    ):
        n_signals = 2 * n_molecules
        vectors = [[0] * n_signals for _ in range(n_molecules)]
        for mi in range(n_molecules):
            vectors[mi][mi] = -1
            vectors[mi][mi + n_molecules] = 1
        super().__init__(
            rng=rng,
            vectors=vectors,
            n_signals=n_signals,
            max_token=max_token,
            zero_value=zero_value,
        )

    def inverse(self, molecules: list[Molecule]) -> dict[Molecule, list[int]]:
        return {
            mol: np.argwhere(self.M[:, mi] != 0).flatten().tolist()
            for mi, mol in enumerate(molecules)
        }


class _RegulatoryMapFact(_VectorMapFact):
    """Token -> one-hot effector vector over 2n signals"""

    def __init__(
        self,
        rng: random.Random,
        n_molecules: int,
        max_token: int,
        zero_value: int = 0,
    ):
        n_signals = 2 * n_molecules
        vectors = [[0] * n_signals for _ in range(n_signals)]
        for mi in range(n_signals):
            vectors[mi][mi] = 1
        super().__init__(
            rng=rng,
            vectors=vectors,
            n_signals=n_signals,
            max_token=max_token,
            zero_value=zero_value,
        )

    def inverse(
        self, molecules: list[Molecule]
    ) -> dict[tuple[Molecule, bool], list[int]]:
        n = len(molecules)
        reg_map = {}
        for mi, mol in enumerate(molecules):
            reg_map[(mol, False)] = np.argwhere(self.M[:, mi] != 0).flatten().tolist()
            reg_map[(mol, True)] = (
                np.argwhere(self.M[:, mi + n] != 0).flatten().tolist()
            )
        return reg_map



class Kinetics:
    """
    Class holding the cell parameter tensors.  Usually instantiated by
    :class:`~magicsoup_tpu_torch.world.World` — access it on
    ``world.kinetics``.

    Parameters:
        chemistry: Simulation :class:`Chemistry`.
        abs_temp: Absolute temperature (K); influences reaction equilibria.
        km_range: Range for sampled Michaelis-Menten constants (mM).
        vmax_range: Range for sampled maximum velocities (mM/s).
        scalar_enc_size: Number of tokens encoding scalars (Vmax, Km, sign);
            ``max(genetics.one_codon_map.values())``.
        vector_enc_size: Number of tokens encoding vectors (reactions,
            molecules); ``max(genetics.two_codon_map.values())``.
        seed: Seed for the token->parameter sampling.
        device: Where the parameter tensors and token tables live:
            ``None`` means ``"cuda"``; pass ``"cpu"`` to run on the CPU.

    Cells are slot rows, proteins are ordered as translated; signals are
    all intracellular molecules (chemistry order) then all extracellular
    ones.  Dead/empty slots hold all-zero rows and do not react.
    """

    def __init__(
        self,
        chemistry: Chemistry,
        abs_temp: float = 310.0,
        km_range: tuple[float, float] = (1e-2, 100.0),
        vmax_range: tuple[float, float] = (1e-3, 100.0),
        scalar_enc_size: int = 64 - 3,
        vector_enc_size: int = 4096 - 3 * 64,
        seed: int | None = None,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device, "Kinetics")
        self.abs_temp = abs_temp
        self.seed = seed
        self.chemistry = chemistry
        self.mol_names = [d.name for d in chemistry.molecules]
        self.n_molecules = len(chemistry.molecules)
        self.n_signals = 2 * self.n_molecules
        mol_energies = np.array(
            [d.energy for d in chemistry.molecules] * 2, dtype=np.float32
        )

        # sampling order follows the reference so distributions match
        rng = random.Random(seed)
        mol_2_mi = {d: i for i, d in enumerate(chemistry.molecules)}
        self.km_map = _LogNormWeightMapFact(
            rng=rng, max_token=scalar_enc_size, weight_range=km_range
        )
        self.vmax_map = _LogNormWeightMapFact(
            rng=rng, max_token=scalar_enc_size, weight_range=vmax_range
        )
        self.sign_map = _SignMapFact(rng=rng, max_token=scalar_enc_size)
        self.hill_map = _HillMapFact(rng=rng, max_token=scalar_enc_size)
        self.reaction_map = _ReactionMapFact(
            rng=rng,
            molmap=mol_2_mi,
            reactions=chemistry.reactions,
            max_token=vector_enc_size,
        )
        self.transport_map = _TransporterMapFact(
            rng=rng, n_molecules=self.n_molecules, max_token=vector_enc_size
        )
        self.effector_map = _RegulatoryMapFact(
            rng=rng, n_molecules=self.n_molecules, max_token=vector_enc_size
        )

        # inverse maps for genome generation
        self.km_2_idxs = self.km_map.inverse()
        self.vmax_2_idxs = self.vmax_map.inverse()
        self.sign_2_idxs = self.sign_map.inverse()
        self.hill_2_idxs = self.hill_map.inverse()
        self.trnsp_2_idxs = self.transport_map.inverse(molecules=chemistry.molecules)
        self.regul_2_idxs = self.effector_map.inverse(molecules=chemistry.molecules)
        self.catal_2_idxs = self.reaction_map.inverse(
            molmap=mol_2_mi, reactions=chemistry.reactions, n_signals=self.n_signals
        )

        dev = self.device
        self.tables = TokenTables(
            km_weights=torch.from_numpy(self.km_map.weights).to(dev),
            vmax_weights=torch.from_numpy(self.vmax_map.weights).to(dev),
            signs=torch.from_numpy(self.sign_map.signs).to(dev),
            hills=torch.from_numpy(self.hill_map.numbers).to(dev),
            reactions=torch.from_numpy(self.reaction_map.M).to(dev),
            transports=torch.from_numpy(self.transport_map.M).to(dev),
            effectors=torch.from_numpy(self.effector_map.M).to(dev),
            mol_energies=torch.from_numpy(mol_energies).to(dev),
        )
        self._abs_temp_t = torch.tensor(abs_temp, dtype=torch.float32, device=dev)

        self.max_cells = 0
        self.max_proteins = 0
        self.max_doms = 1
        self.params = self._alloc(0, 0)

    # ------------------------------------------------------------------ #
    # capacity management                                                #
    # ------------------------------------------------------------------ #

    def _alloc(self, c: int, p: int) -> CellParams:
        s = self.n_signals

        def f32(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        def i16(*shape):
            return torch.zeros(shape, dtype=INT_PARAM_DTYPE, device=self.device)

        return CellParams(
            Ke=f32(c, p),
            Kmf=f32(c, p),
            Kmb=f32(c, p),
            Kmr=f32(c, p, s),
            Vmax=f32(c, p),
            N=i16(c, p, s),
            Nf=i16(c, p, s),
            Nb=i16(c, p, s),
            A=i16(c, p, s),
        )

    def _resize(self, c: int, p: int):
        """Grow-only: new tensors at (c, p), the old rows copied in."""
        old = self.params
        new = self._alloc(c, p)
        oc, op = old.Ke.shape
        for o, n in zip(old, new):
            n[:oc, :op] = o
        self.params = new
        self.max_cells = c
        self.max_proteins = p

    def ensure_capacity(self, n_cells: int | None = None, n_proteins: int | None = None):
        """Grow slot capacity (cells and/or proteins); never shrinks."""
        c = max(self.max_cells, n_cells or 0)
        p = max(self.max_proteins, n_proteins or 0)
        if c != self.max_cells or p != self.max_proteins:
            self._resize(c, p)

    # ------------------------------------------------------------------ #
    # parameter assembly                                                 #
    # ------------------------------------------------------------------ #

    def ensure_token_capacity(
        self, prot_counts: np.ndarray, prots: np.ndarray
    ) -> None:
        """Grow the protein/domain capacities (grow-only, pow2) to cover
        a translated batch."""
        max_prots = int(prot_counts.max()) if len(prot_counts) else 0
        max_doms = int(prots[:, 3].max()) if len(prots) else 1
        self.ensure_token_limits(max_prots, max_doms)

    def ensure_token_limits(self, max_prots: int, max_doms: int) -> None:
        """Scalar form of :meth:`ensure_token_capacity`."""
        if max_prots > self.max_proteins:
            self.ensure_capacity(n_proteins=pad_pow2(max_prots, minimum=1))
        self.max_doms = max(
            self.max_doms, pad_pow2(max(max_doms, 1), minimum=1)
        )

    def set_cell_params_flat(
        self,
        cell_idxs: np.ndarray | list[int],
        prot_counts: np.ndarray,
        prots: np.ndarray,
        doms: np.ndarray,
    ):
        """
        Translate flat genome-engine buffers into kinetic parameters and
        write them to the given cell slots.  Cells are grouped by their
        assembly rung — the pow2 of their own (protein count, max domains
        per protein), floored at (RUNG_P_MIN, RUNG_D_MIN) and clamped to
        the capacities — and each group is packed and assembled at ITS
        rung; the result is bit-identical to full-width assembly.
        Duplicate target slots: the last one wins.
        """
        cell_idxs = np.asarray(cell_idxs, dtype=np.int32)
        b = len(cell_idxs)
        if b == 0:
            return
        prot_counts = np.asarray(prot_counts, dtype=np.int32)
        prots = np.asarray(prots, dtype=np.int32).reshape(-1, 4)
        doms = np.asarray(doms, dtype=np.int32).reshape(-1, 7)
        self.ensure_token_capacity(prot_counts, prots)

        if len(np.unique(cell_idxs)) != b:
            _, keep = np.unique(cell_idxs[::-1], return_index=True)
            keep = np.sort(b - 1 - keep)
            prot_offs = np.concatenate([[0], np.cumsum(prot_counts)])
            pidx = _gather_ranges(prot_offs[keep], prot_counts[keep])
            dom_offs = np.concatenate([[0], np.cumsum(prots[:, 3])])
            didx = _gather_ranges(dom_offs[pidx], prots[pidx, 3])
            cell_idxs = cell_idxs[keep]
            prot_counts = prot_counts[keep]
            prots = prots[pidx]
            doms = doms[didx]
            b = len(cell_idxs)

        # per-cell rung: pow2 of (n_prots, max doms over its proteins)
        dmax = np.zeros(b, dtype=np.int64)
        if len(prots):
            prot_cell = np.repeat(np.arange(b, dtype=np.int64), prot_counts)
            np.maximum.at(dmax, prot_cell, prots[:, 3].astype(np.int64))

        prot_offs = np.concatenate([[0], np.cumsum(prot_counts)])
        dom_offs = np.concatenate([[0], np.cumsum(prots[:, 3])])
        for sel, p_r, d_r in self._rung_groups(prot_counts, dmax):
            pidx = _gather_ranges(prot_offs[sel], prot_counts[sel])
            g_prots = prots[pidx]
            didx = _gather_ranges(dom_offs[pidx], g_prots[:, 3])
            dense = pack_dense(prot_counts[sel], g_prots, doms[didx], p_r, d_r)
            self.scatter_dense(cell_idxs[sel], dense)

    def _rung_groups(
        self, counts: np.ndarray, dmax: np.ndarray
    ) -> list[tuple[np.ndarray, int, int]]:
        """Group cells by assembly rung -> ``[(sel, p_rung, d_rung)]``;
        groups smaller than IDX_BLOCK rows fold into the full-capacity
        rung, as in the JAX package."""
        p_rung = rung_pow2(counts, RUNG_P_MIN, self.max_proteins)
        d_rung = rung_pow2(dmax, RUNG_D_MIN, self.max_doms)
        key = p_rung * (self.max_doms + 1) + d_rung
        uniq, n_per = np.unique(key, return_counts=True)
        if len(uniq) > 1:
            small = np.isin(key, uniq[n_per < IDX_BLOCK])
            if small.any():
                p_rung = np.where(small, self.max_proteins, p_rung)
                d_rung = np.where(small, self.max_doms, d_rung)
                key = p_rung * (self.max_doms + 1) + d_rung
        return [
            (
                sel := np.nonzero(key == k)[0],
                int(p_rung[sel[0]]),
                int(d_rung[sel[0]]),
            )
            for k in np.unique(key)
        ]

    def set_cell_params_cached(self, cell_idxs, entries, cache):
        """Write parameters for cells whose phenotypes come from a
        :class:`~magicsoup_tpu_torch.genetics.PhenotypeCache` — the same
        rung grouping as :meth:`set_cell_params_flat`, with each group's
        dense token rows served by the cache.  Callers pre-dedupe
        duplicate slots."""
        cell_idxs = np.asarray(cell_idxs, dtype=np.int32)
        b = len(cell_idxs)
        if b == 0:
            return
        counts = np.fromiter((e.n_prots for e in entries), dtype=np.int64, count=b)
        dmax = np.fromiter((e.max_doms for e in entries), dtype=np.int64, count=b)
        self.ensure_token_limits(int(counts.max()), int(dmax.max()))
        for sel, p_r, d_r in self._rung_groups(counts, dmax):
            rows = cache.dense_rows([entries[i] for i in sel], p_r, d_r)
            self.scatter_dense(cell_idxs[sel], rows)

    def scatter_dense(self, cell_idxs: np.ndarray, dense: np.ndarray):
        """Assemble one packed token batch into parameter rows, in chunks
        that bound the (b, p, d, s) assembly temporaries."""
        cell_idxs = np.asarray(cell_idxs, dtype=np.int64)
        b = len(cell_idxs)
        if b == 0:
            return
        p_r, d_r = int(dense.shape[1]), int(dense.shape[2])
        chunk = self._assembly_chunk(p_r, d_r)
        for a in range(0, b, chunk):
            assemble_rows(
                self.params,
                torch.from_numpy(np.ascontiguousarray(dense[a : a + chunk])).to(
                    self.device
                ),
                self.tables,
                self._abs_temp_t,
                torch.from_numpy(cell_idxs[a : a + chunk]).to(self.device),
            )

    def _assembly_chunk(self, p_cap: int, d_cap: int) -> int:
        """Largest pow2 batch whose (b, p, d, s) temporaries stay ~<= 256 MB
        each at the given rung."""
        per_row = max(p_cap * d_cap * self.n_signals, 1)
        chunk = 1 << max((2**26 // per_row).bit_length() - 1, 0)
        return max(IDX_BLOCK, chunk)

    def unset_cell_params(self, cell_idxs: np.ndarray | list[int]):
        """Zero the parameter rows of the given cell slots"""
        cell_idxs = np.asarray(cell_idxs, dtype=np.int64)
        if len(cell_idxs) == 0:
            return
        unset_rows(self.params, torch.from_numpy(cell_idxs).to(self.device))

    def copy_cell_params(
        self, from_idxs: np.ndarray | list[int], to_idxs: np.ndarray | list[int]
    ):
        """Copy parameter rows between cell slots (same-length index lists)"""
        from_idxs = np.asarray(from_idxs, dtype=np.int64)
        to_idxs = np.asarray(to_idxs, dtype=np.int64)
        if len(from_idxs) == 0:
            return
        copy_rows(
            self.params,
            torch.from_numpy(from_idxs).to(self.device),
            torch.from_numpy(to_idxs).to(self.device),
        )

    def permute_cells(self, perm: np.ndarray, n_keep: int):
        """Gather slot rows by a full-capacity permutation; zero the tail"""
        perm_t = torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(self.device)
        self.params = permute_params(self.params, perm_t, n_keep)

    def get_proteome(self, proteome: list[ProteinSpecType]) -> list[Protein]:
        """
        Interpret one index-level proteome as human-readable
        :class:`Protein` objects (replaces the reference's native dict
        builder, `rust/kinetics.rs:101-202`).
        """
        out = []
        for dom_specs, cds_start, cds_end, is_fwd in proteome:
            domains = []
            for (dt, i0, i1, i2, i3), start, end in dom_specs:
                dct = self._domain_dict(dt, i0, i1, i2, i3, start, end)
                if dct is not None:
                    domains.append(dct)
            out.append(
                Protein.from_dict(
                    {
                        "domains": domains,
                        "cds_start": cds_start,
                        "cds_end": cds_end,
                        "is_fwd": is_fwd,
                    }
                )
            )
        return out

    def _domain_dict(
        self, dt: int, i0: int, i1: int, i2: int, i3: int, start: int, end: int
    ) -> dict | None:
        mols = self.mol_names
        n_mols = self.n_molecules
        km = float(self.km_map.weights[i1])
        sign = int(self.sign_map.signs[i2])
        if dt == 1:
            vmax = float(self.vmax_map.weights[i0])
            react = self.reaction_map.M[i3]
            lfts: list[str] = []
            rgts: list[str] = []
            for mol_i, n in enumerate(react[:n_mols].tolist()):
                signed_n = n * sign
                if signed_n > 0:
                    rgts.extend([mols[mol_i]] * abs(n))
                elif signed_n < 0:
                    lfts.extend([mols[mol_i]] * abs(n))
            spec = {
                "reaction": (lfts, rgts),
                "km": km,
                "vmax": vmax,
                "start": start,
                "end": end,
            }
            return {"type": "C", "spec": spec}
        if dt == 2:
            vmax = float(self.vmax_map.weights[i0])
            trnspt = self.transport_map.M[i3]
            nz = np.nonzero(trnspt)[0]
            if len(nz) == 0:
                raise ValueError("No transporter molecule identified")
            mol_i = int(nz[0])
            signed_n = int(trnspt[mol_i]) * sign
            spec = {
                "molecule": mols[mol_i % n_mols],
                "km": km,
                "vmax": vmax,
                "is_exporter": signed_n < 0,
                "start": start,
                "end": end,
            }
            return {"type": "T", "spec": spec}
        if dt == 3:
            hill = int(self.hill_map.numbers[i0])
            eff = self.effector_map.M[i3]
            nz = np.nonzero(eff)[0]
            if len(nz) == 0:
                raise ValueError("No effector molecule identified")
            i = int(nz[0])
            signed_n = int(eff[i]) * sign
            is_trns = i >= n_mols
            spec = {
                "effector": mols[i % n_mols],
                "km": km,
                "hill": hill,
                "is_inhibiting": signed_n < 0,
                "is_transmembrane": is_trns,
                "start": start,
                "end": end,
            }
            return {"type": "R", "spec": spec}
        return None
