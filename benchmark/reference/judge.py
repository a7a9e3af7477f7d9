"""
Holds one simulation step of the program to the reference.

The program steps its world once more after the measured window, from
state S0 to S1, through the same entry the window drove.  The reference
follows that step from S0: it translates the genomes, assembles the
kinetic parameters, integrates, selects (kill below, divide above at a
cost), degrades, diffuses and permeates.  Where the step is random
(where a child lands, which candidates the program's per-step budget let
try), the reference takes the program's outcome from S1 and checks the
rest.

A step couples a pixel to its 8 neighbours only, and a cell to the 7
others of its integrator tile (8 consecutive rows vote the early stop of
the equilibrium correction).  So the check reads patches of the map
drawn from the seed: the pixels inside them, the cells on those pixels,
and the cells of every tile those cells are in.

Readings, each a share of what the patches hold: cells whose molecules
differ from the reference by more than a threshold of the cell's largest
value (or that exist on one side only), pixels likewise, and translated
cells whose kinetic parameters differ (or whose proteins do).
"""
import random
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import kinetics as rk
from benchmark.reference import physics
from benchmark.reference.genetics import CodonMaps, dense_tokens

THRESHOLDS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 3e-1, 1.0)
N_PATCHES = 4
PATCH_SIDE = 12
FLOAT_PARAMS = ("Ke", "Kmf", "Kmb", "Vmax")


class Snapshot(NamedTuple):
    """A world's state between two steps, on the host."""

    pos: np.ndarray  # (n, 2) int64 cell pixels, row order
    cm: np.ndarray  # (n, mols) float32
    mm: np.ndarray  # (mols, m, m) float32
    div: np.ndarray  # (n,) divisions per cell
    genomes: dict  # row -> genome, for the rows the check reads (S0)
    params: dict  # name -> the program's parameter rows, in ``genomes``' row order (S0)


class Setting(NamedTuple):
    """What the configuration fixes, as both sides get it."""

    chem: dict
    seed: int  # the world's seed
    abs_temp: float
    atp: int  # column of the selection molecule
    kill_below: float
    divide_above: float
    divide_cost: float


class Plan(NamedTuple):
    interior: np.ndarray  # (m, m) bool: the pixels judged
    region: np.ndarray  # (m, m) bool: interior and its 8-neighbourhood
    rows: np.ndarray  # sorted rows the reference integrates (whole tiles)


def plan(pos0: np.ndarray, m: int, check_seed: int) -> Plan:
    """Patches drawn from ``check_seed`` and the rows they need."""
    rng = random.Random(check_seed)
    interior = np.zeros((m, m), dtype=bool)
    side = min(PATCH_SIDE, m)
    for _ in range(N_PATCHES):
        x0, y0 = rng.randrange(m), rng.randrange(m)
        xs = (x0 + np.arange(side)) % m
        ys = (y0 + np.arange(side)) % m
        interior[np.ix_(xs, ys)] = True
    region = interior.copy()
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            region |= np.roll(interior, (dx, dy), axis=(0, 1))
    n0 = len(pos0)
    in_region = np.nonzero(region[pos0[:, 0], pos0[:, 1]])[0]
    tiles = np.unique(in_region // rk.TILE)
    rows = (tiles[:, None] * rk.TILE + np.arange(rk.TILE)[None, :]).reshape(-1)
    return Plan(interior, region, rows[rows < n0])


class Outcome(NamedTuple):
    """The program's step as S0 -> S1 shows it."""

    survivor: np.ndarray  # (n0,) S1 row of each S0 cell, -1 if killed
    parents: np.ndarray  # S0 rows that divided, ascending
    child_pos: np.ndarray  # (len(parents), 2) where their children landed


def outcome(s0: Snapshot, s1: Snapshot, kills: int, placed: int) -> Outcome | None:
    """Survivors keep their order and pixel; children follow in the order
    of their parents.  ``None`` when S1 is not such a successor of S0."""
    n0, n1 = len(s0.pos), len(s1.pos)
    n_surv = n0 - kills
    if n_surv < 0 or n1 != n_surv + placed:
        return None
    survivor = np.full(n0, -1, dtype=np.int64)
    j = 0
    for i in range(n0):
        if j < n_surv and s1.pos[j, 0] == s0.pos[i, 0] and s1.pos[j, 1] == s0.pos[i, 1]:
            survivor[i] = j
            j += 1
    if j != n_surv:
        return None
    alive = survivor >= 0
    divided = np.zeros(n0, dtype=bool)
    divided[alive] = s1.div[survivor[alive]] == s0.div[alive] + 1
    parents = np.nonzero(divided)[0]
    if len(parents) != placed:
        return None
    return Outcome(survivor, parents, s1.pos[n_surv:])


def translate(s0: Snapshot, setting: Setting, rows: np.ndarray):
    """Proteomes of ``rows`` and the token tables, from the seed."""
    r = random.Random(setting.seed)
    maps = CodonMaps(r.randrange(2**63))
    tables = rk.token_tables(r.randrange(2**63), setting.chem, maps.scalar_tokens,
                             maps.vector_tokens)
    return [maps.translate(s0.genomes[int(i)]) for i in rows], tables


class Prediction(NamedTuple):
    params: rk.Params  # of the plan's rows
    n_prots: np.ndarray  # real proteins per row
    cells: dict  # (x, y) in the interior -> (mols,) after the step
    cells_alt: dict  # the other prediction of cells the budget may have stopped
    pixels: np.ndarray  # (mols, k) after the step, interior pixels in order
    pixels_alt: np.ndarray
    kill_flips: int  # region cells killed on one side only
    divide_flips: int  # program's parents that the reference does not divide


def predict(s0: Snapshot, out: Outcome, plan_: Plan, setting: Setting, proteomes,
            tables, ambiguous: bool, device, dtype) -> Prediction:
    """The step from S0 in ``dtype``.  ``ambiguous``: the program's budget
    may have kept some candidates from trying, so a candidate that did not
    divide is predicted without the cost paid and, in ``cells_alt`` and
    ``pixels_alt``, with it."""
    M = s0.cm.shape[1]
    rows = plan_.rows
    # whole tiles: padding rows hold no proteins and take no vote
    tile_of = rows // rk.TILE
    tiles = np.unique(tile_of)
    slot = np.searchsorted(tiles, tile_of) * rk.TILE + rows % rk.TILE
    c = len(tiles) * rk.TILE
    tok = dense_tokens(proteomes)
    p = rk.assemble(tok, tables, setting.abs_temp, device, dtype)
    n_prots = np.array([len(x) for x in proteomes], dtype=np.int64)
    idx = torch.as_tensor(slot, device=device)

    def spread(t):
        z = torch.zeros((c,) + tuple(t.shape[1:]), dtype=t.dtype, device=device)
        z[idx] = t
        return z

    mm0 = torch.as_tensor(s0.mm, device=device).to(dtype)
    pos = torch.as_tensor(s0.pos[rows], device=device)
    ext = mm0[:, pos[:, 0], pos[:, 1]].T
    X0 = torch.cat([torch.as_tensor(s0.cm[rows], device=device).to(dtype), ext], dim=1)
    X1 = rk.integrate(spread(X0), rk.Params(*(spread(t) for t in p)))[idx]

    # selection over the cells on region pixels
    reg = plan_.region[s0.pos[rows, 0], s0.pos[rows, 1]]
    cm_act = X1[:, :M]
    atp = cm_act[:, setting.atp].float().cpu().numpy()
    kill = atp < setting.kill_below
    cand = ~kill & (atp > setting.divide_above)
    prog_kill = out.survivor[rows] < 0
    kill_flips = int((reg & (kill != prog_kill)).sum())
    parent_rank = {int(r): k for k, r in enumerate(out.parents)}
    placed = np.array([int(r) in parent_rank for r in rows])
    divide_flips = int((reg & placed & ~cand).sum())
    divides = placed & cand
    maybe = cand & ~divides if ambiguous else np.zeros_like(cand)
    paid = cand & ~maybe

    onehot = torch.zeros(M, dtype=dtype, device=device)
    onehot[setting.atp] = 1
    cost = torch.as_tensor(paid, device=device)[:, None].to(dtype) * setting.divide_cost * onehot
    cm_paid = cm_act - cost
    cm_maybe = cm_act - setting.divide_cost * onehot
    half = torch.as_tensor(divides, device=device)[:, None]
    cm_paid = torch.where(half, cm_paid * 0.5, cm_paid)

    off, centre, perm, decay = physics.factors(setting.chem, device, dtype)
    mm = mm0.clone()
    sel = torch.as_tensor(reg, device=device)
    dx = torch.where(sel[:, None], X1[:, M:] - ext, torch.zeros_like(ext))
    spill = torch.where((sel & torch.as_tensor(kill, device=device))[:, None], cm_act,
                        torch.zeros_like(cm_act))
    mm.index_put_((torch.arange(M, device=device)[:, None], pos[:, 0][None], pos[:, 1][None]),
                  (dx + spill).T, accumulate=True)
    mm = mm * decay[:, None, None]
    ix, iy = np.nonzero(plan_.interior)
    txs, tys = torch.as_tensor(ix, device=device), torch.as_tensor(iy, device=device)
    diffused = physics.diffuse_at(mm, txs, tys, off, centre)  # (M, k)
    pix_of = {(int(x), int(y)): k for k, (x, y) in enumerate(zip(ix, iy))}

    # cells on interior pixels after the step: survivors, then children
    entries = []  # (pixel, cm before physics, the other prediction or None)
    for k, r in enumerate(rows):
        key = (int(s0.pos[r, 0]), int(s0.pos[r, 1]))
        if key in pix_of and not kill[k]:
            entries.append((key, cm_paid[k], cm_maybe[k] if maybe[k] else None))
        if divides[k]:
            cp = out.child_pos[parent_rank[int(r)]]
            ckey = (int(cp[0]), int(cp[1]))
            if ckey in pix_of:
                entries.append((ckey, cm_paid[k], None))

    pixels = diffused.clone()
    pixels_alt = diffused.clone()
    cells, cells_alt = {}, {}
    for key, cm_b, cm_u in entries:
        k = pix_of[key]
        for cm_x, cells_x, pix_x in ((cm_b, cells, pixels), (cm_u, cells_alt, pixels_alt)):
            if cm_x is None:
                continue
            ext_k = diffused[:, k]
            new_cm, new_ext = physics.permeate(cm_x * decay, ext_k, perm)
            cells_x[key] = new_cm.float().cpu().numpy()
            pix_x[:, k] = pix_x[:, k] + (new_ext - ext_k)
    for key in cells:
        if key not in cells_alt:
            # a cell with one prediction: its pixel agrees in both
            pixels_alt[:, pix_of[key]] = pixels[:, pix_of[key]]
    return Prediction(
        params=rk.Params(*(t.float() if t.dtype.is_floating_point else t for t in p)),
        n_prots=n_prots,
        cells=cells,
        cells_alt=cells_alt,
        pixels=pixels.float().cpu().numpy(),
        pixels_alt=pixels_alt.float().cpu().numpy(),
        kill_flips=kill_flips,
        divide_flips=divide_flips,
    )


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest difference over a cell's or pixel's molecules, as a share
    of the reference's largest value there."""
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-12))


def _shares(gaps: list[float], prefix: str) -> dict:
    g = np.asarray(gaps, dtype=np.float64)
    out = {f"{prefix}_judged": len(g), f"{prefix}_max_gap": float(g.max()) if len(g) else 0.0}
    for t in THRESHOLDS:
        out[f"{prefix}_off_{t:.0e}"] = float((g > t).mean()) if len(g) else 0.0
    return out


def param_gaps(ref: Prediction, prog: dict, why: list | None = None) -> list[float]:
    """Per translated cell: the largest relative gap of its float
    parameters over its real proteins (Kmr where A is nonzero), or inf
    when an integer parameter, a protein or an empty slot differs (the
    cell's position in the plan's rows and which of these, into ``why``)."""
    gaps = []
    R = {k: v.cpu().numpy() for k, v in ref.params._asdict().items()}
    for i, n in enumerate(ref.n_prots):
        p_prog = prog["N"].shape[1]
        bad = "proteins" if n > p_prog else None
        if bad is None and not all(
                np.array_equal(prog[k][i, :n].astype(np.int64), R[k][i, :n].astype(np.int64))
                for k in ("N", "Nf", "Nb", "A")):
            bad = "integers"
        if bad is None and (prog["N"][i, n:].any() or prog["A"][i, n:].any()
                            or prog["Vmax"][i, n:].any()):
            bad = "extra slots"
        if bad is not None:
            if why is not None:
                why.append((i, bad, int(n), int((prog["Vmax"][i] > 0).sum())))
            gaps.append(np.inf)
            continue
        g = 0.0
        for k in FLOAT_PARAMS:
            a, b = prog[k][i, :n], R[k][i, :n]
            g = max(g, float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max(initial=0.0)))
        mask = R["A"][i, :n] != 0
        if mask.any():
            a, b = prog["Kmr"][i, :n][mask], R["Kmr"][i, :n][mask]
            g = max(g, float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max()))
        gaps.append(g)
    return gaps


def compare(cells: dict, pixels: np.ndarray, params: dict, ref: Prediction) -> dict:
    """Readings of one side's step (the program's, or the control's)
    against the reference's prediction."""
    cell_gaps = []
    for key in set(cells) | set(ref.cells):
        if key not in cells or key not in ref.cells:
            cell_gaps.append(np.inf)
            continue
        g = _gap(cells[key], ref.cells[key])
        if key in ref.cells_alt:
            g = min(g, _gap(cells[key], ref.cells_alt[key]))
        cell_gaps.append(g)
    pix_gaps = [
        min(_gap(pixels[:, k], ref.pixels[:, k]), _gap(pixels[:, k], ref.pixels_alt[:, k]))
        for k in range(pixels.shape[1])
    ]
    out = {}
    out.update(_shares(cell_gaps, "cells"))
    out.update(_shares(pix_gaps, "pixels"))
    why: list = []
    out.update(_shares(param_gaps(ref, params, why), "params"))
    out["params_mismatches"] = why[:8]
    out["kill_flips"] = ref.kill_flips
    out["divide_flips"] = ref.divide_flips
    return out


def program_view(s1: Snapshot, plan_: Plan) -> tuple[dict, np.ndarray]:
    """The program's cells and pixels in the interior after the step."""
    ix, iy = np.nonzero(plan_.interior)
    inside = plan_.interior[s1.pos[:, 0], s1.pos[:, 1]]
    cells = {(int(x), int(y)): s1.cm[r] for r, (x, y) in enumerate(s1.pos) if inside[r]}
    return cells, s1.mm[:, ix, iy]


def structural_failure() -> dict:
    out = {}
    for prefix in ("cells", "pixels", "params"):
        out[f"{prefix}_judged"] = 0
        out[f"{prefix}_max_gap"] = np.inf
        for t in THRESHOLDS:
            out[f"{prefix}_off_{t:.0e}"] = 1.0
    out["kill_flips"] = out["divide_flips"] = -1
    return out


def judge(s0: Snapshot, s1: Snapshot, counts: dict, plan_: Plan, setting: Setting,
          device, control: bool = False) -> dict:
    """Readings of the program's step S0 -> S1, and with ``control`` also
    of the reference in bfloat16 put in the program's place (keys
    prefixed ``control.``).  ``counts``: the step's ``kills``,
    ``placed`` and ``drops`` (candidates the budget kept from trying)."""
    out = outcome(s0, s1, counts["kills"], counts["placed"])
    if out is None:
        res = structural_failure()
        if control:
            res.update({f"control.{k}": v for k, v in structural_failure().items()})
        return res
    proteomes, tables = translate(s0, setting, plan_.rows)
    amb = counts["drops"] > 0
    with torch.no_grad():
        ref = predict(s0, out, plan_, setting, proteomes, tables, amb, device, torch.float32)
        cells, pixels = program_view(s1, plan_)
        res = compare(cells, pixels, s0.params, ref)
        # the world's row and its genome, for a reader to translate again
        res["params_mismatches"] = [
            (int(plan_.rows[i]), bad, n, n_prog, s0.genomes[int(plan_.rows[i])])
            for i, bad, n, n_prog in res["params_mismatches"]]
        if control:
            low = predict(s0, out, plan_, setting, proteomes, tables, False, device,
                          torch.bfloat16)
            low_params = {k: v.cpu().numpy() for k, v in low.params._asdict().items()}
            res.update({f"control.{k}": v
                        for k, v in compare(low.cells, low.pixels, low_params, ref).items()})
    return res
