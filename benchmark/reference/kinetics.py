"""
Token tables, kinetic parameters and the reversible Michaelis-Menten
integrator, in plain PyTorch.

Upstream magic-soup 1.0.5 ``kinetics.py`` in the form the port computes
it: scalar tokens map to log-normal Km and Vmax, signs and Hill numbers;
vector tokens to reaction, transport and effector vectors.  A protein's
Vmax and Km are means over its domains, its stoichiometry the signed sum,
Ke = exp(-N.E / RT), and the sampled Km sits on the smaller side of Ke.
The integrator runs three passes with trimmed Vmax (0.7, 0.2, 0.1); each
pass takes reversible MM velocities with allosteric factors, slows
proteins so no signal goes negative, and corrects overshoot of Ke in four
halving steps, stopping for a tile of ``TILE`` cells once none of its
impactful proteins needs it.  ``dtype`` selects the precision the whole
computation runs in.
"""
import math
import random
from typing import NamedTuple

import numpy as np
import torch

GAS_CONSTANT = 8.31446261815324
EPS, MAX, MIN = 1e-36, 1e36, -1e36
LOG0 = -1e12
TRIMS = (0.7, 0.2, 0.1)
INCREMENTS = (0.5, 0.25, 0.125, 0.0625)
UPPER, LOWER = 1.5, 1 / 1.5
TILE = 8  # cells per early-stop vote


class Params(NamedTuple):
    Ke: torch.Tensor  # (c, p)
    Kmf: torch.Tensor  # (c, p)
    Kmb: torch.Tensor  # (c, p)
    Kmr: torch.Tensor  # (c, p, s)
    Vmax: torch.Tensor  # (c, p)
    N: torch.Tensor  # (c, p, s) integers
    Nf: torch.Tensor
    Nb: torch.Tensor
    A: torch.Tensor


def _np_rng(rng: random.Random) -> np.random.Generator:
    return np.random.default_rng(rng.randrange(2**63))


def _lognormal(rng, n: int, lo: float, hi: float) -> np.ndarray:
    mu, sig = (math.log(lo) + math.log(hi)) / 2, math.log(hi) - math.log(lo)
    g, vals = _np_rng(rng), []
    while sum(len(v) for v in vals) < n:
        d = np.exp(g.normal(mu, sig, size=n - sum(len(v) for v in vals)))
        vals.append(d[(d >= lo) & (d <= hi)])
    return np.concatenate([[math.nan], np.concatenate(vals)]).astype(np.float32)


def _vectors(rng, n_tokens: int, vectors: np.ndarray) -> np.ndarray:
    out = np.zeros((n_tokens + 1, vectors.shape[1]), dtype=np.int64)
    out[1:] = vectors[_np_rng(rng).integers(0, len(vectors), size=n_tokens)]
    return out


class Tables(NamedTuple):
    km: np.ndarray
    vmax: np.ndarray
    signs: np.ndarray
    hills: np.ndarray
    reactions: np.ndarray
    transports: np.ndarray
    effectors: np.ndarray
    energies: np.ndarray  # (s,)


def token_tables(seed: int, chem: dict, scalar_tokens: int, vector_tokens: int) -> Tables:
    """The token -> value tables that the kinetics seed fixes, drawn in
    upstream's order: Km, Vmax, signs, Hill numbers, reactions,
    transporters, effectors."""
    rng = random.Random(seed)
    names = [m["name"] for m in chem["molecules"]]
    n = len(names)
    km = _lognormal(rng, scalar_tokens, 1e-2, 100.0)
    vmax = _lognormal(rng, scalar_tokens, 1e-3, 100.0)
    signs = np.where(_np_rng(rng).random(scalar_tokens) < 0.5, 1, -1)
    hill_p = np.array([16.0, 8.0, 4.0, 2.0, 1.0]) / 31.0
    hills = _np_rng(rng).choice(np.arange(1, 6), size=scalar_tokens, p=hill_p)
    react = np.zeros((len(chem["reactions"]), 2 * n), dtype=np.int64)
    for r, (subs, prods) in enumerate(chem["reactions"]):
        for m in subs:
            react[r, names.index(m)] -= 1
        for m in prods:
            react[r, names.index(m)] += 1
    trnsp = np.zeros((n, 2 * n), dtype=np.int64)
    trnsp[np.arange(n), np.arange(n)] = -1
    trnsp[np.arange(n), np.arange(n) + n] = 1
    energies = np.array([m["energy"] for m in chem["molecules"]] * 2, dtype=np.float32)
    return Tables(
        km=km,
        vmax=vmax,
        signs=np.concatenate([[0], signs]),
        hills=np.concatenate([[0], hills]),
        reactions=_vectors(rng, vector_tokens, react),
        transports=_vectors(rng, vector_tokens, trnsp),
        effectors=_vectors(rng, vector_tokens, np.eye(2 * n, dtype=np.int64)),
        energies=energies,
    )


def _nanmean(x: torch.Tensor, dim: int) -> torch.Tensor:
    ok = ~torch.isnan(x)
    total = torch.where(ok, x, torch.zeros_like(x)).sum(dim)
    count = ok.sum(dim)
    return torch.where(count > 0, total / count.clamp(min=1), torch.zeros_like(total))


def assemble(tokens: np.ndarray, tables: Tables, abs_temp: float, device, dtype) -> Params:
    """``(b, p, d, 5)`` domain tokens -> the kinetic parameters of b cells."""
    t = torch.as_tensor(tokens, device=device)
    dtype_, i0, i1, i2, i3 = (t[..., k] for k in range(5))
    cat, trn, reg = dtype_ == 1, dtype_ == 2, dtype_ == 3
    tab = {k: torch.as_tensor(v, device=device) for k, v in tables._asdict().items()}
    vmaxs = tab["vmax"][i0 * (cat | trn)].to(dtype)
    hills = tab["hills"][i0 * reg]
    kms = tab["km"][i1].to(dtype)
    signs = tab["signs"][i2]
    reacts = tab["reactions"][i3 * cat]
    trnsps = tab["transports"][i3 * trn]
    effs = tab["effectors"][i3 * reg]

    Vmax = _nanmean(vmaxs, 2)
    A = (effs * (signs * hills)[..., None]).sum(2)
    kmr = torch.where(reg, kms, torch.full_like(kms, math.nan))
    kmr = effs.to(dtype) * kmr[..., None]
    kmr = torch.where(kmr != 0, kmr, torch.full_like(kmr, math.nan))
    Kmr = _nanmean(kmr, 2) ** A.to(dtype)
    Nd = (reacts + trnsps) * signs[..., None]
    N = Nd.sum(2)
    Nf = (-Nd).clamp(min=0).sum(2)
    Nb = Nd.clamp(min=0).sum(2)
    Kmn = _nanmean(torch.where(reg, torch.full_like(kms, math.nan), kms), 2)
    E = (N.to(dtype) * tab["energies"].to(dtype)).sum(2)
    Ke = torch.exp(-E / abs_temp / GAS_CONSTANT).clamp(EPS, MAX)
    fwd = Ke >= 1
    Kmf = torch.where(fwd, Kmn, Kmn / Ke).clamp(EPS, MAX)
    Kmb = torch.where(fwd, Kmn * Ke, Kmn).clamp(EPS, MAX)
    return Params(Ke=Ke, Kmf=Kmf, Kmb=Kmb, Kmr=Kmr, Vmax=Vmax, N=N, Nf=Nf, Nb=Nb, A=A)


def _log(X):
    return torch.where(X > 0, torch.log(X.clamp(max=MAX)), torch.full_like(X, LOG0))


def _prod(X, N):
    """prod_s X^N per protein, in log space; overflow to MAX."""
    xx = torch.exp((N.to(X.dtype) * _log(X).unsqueeze(-2)).sum(-1))
    return torch.where(torch.isinf(xx), torch.full_like(xx, MAX), xx)


def _velocities(X, Vmax, p: Params):
    kf = _prod(X, p.Nf) / p.Kmf
    kf = torch.where((p.Nf > 0).any(-1), kf, torch.zeros_like(kf))
    kf = torch.where(torch.isinf(kf), torch.full_like(kf, MAX), kf)
    kb = _prod(X, p.Nb) / p.Kmb
    kb = torch.where((p.Nb > 0).any(-1), kb, torch.zeros_like(kb))
    kb = torch.where(torch.isinf(kb), torch.full_like(kb, MAX), kb)
    a_cat = (kf - kb) / (1 + kf + kb)
    t = p.A.to(X.dtype) * _log(X).unsqueeze(-2)
    xa = torch.exp(torch.minimum(t, torch.full_like(t, math.log(MAX))))
    r = xa / (xa + p.Kmr)
    r = torch.where(torch.isnan(r) | (p.A == 0), torch.ones_like(r), r)
    a_reg = torch.exp(_log(r).sum(-1))
    return (a_cat * Vmax * a_reg).clamp(MIN, MAX)


def _quotient(X, p: Params):
    prods = _prod(X, p.Nb)
    prods = torch.where((p.Nb > 0).any(-1), prods, torch.zeros_like(prods))
    subs = _prod(X, p.Nf)
    subs = torch.where((p.Nf > 0).any(-1), subs, torch.zeros_like(subs))
    return torch.nan_to_num((prods / subs).clamp(EPS, MAX), nan=1.0)


def _step(X0, X1, W, V, p: Params):
    """Overshoot correction of one pass over (tiles, TILE, s)."""
    N = p.N.to(X0.dtype)
    impact, fwd = V.abs() > 0.1, V > 0
    F = torch.ones_like(V)
    stopped = torch.zeros((V.shape[0], 1, 1), dtype=torch.bool, device=V.device)
    for inc in INCREMENTS:
        qke = _quotient(X1, p) / p.Ke
        low = torch.where(fwd, qke < LOWER, qke > UPPER) & ~(fwd & (F == 1))
        high = torch.where(fwd, qke > UPPER, qke < LOWER) & ~(~fwd & (F == 0))
        stopped |= (((low | high) & impact).sum((-2, -1)) == 0).view(-1, 1, 1)
        go = ~stopped
        F = torch.where(go & high, F - inc, F)
        F = torch.where(go & low, F + inc, F).clamp(0, 1)
        Xn = (X0 + (N * (W * F).unsqueeze(-1)).sum(-2)).clamp(min=0)
        X1 = torch.where(go, Xn, X1)
    return X1


def integrate(X: torch.Tensor, p: Params) -> torch.Tensor:
    """One integrator step over ``X`` (c, s), c a multiple of ``TILE``."""
    c, s = X.shape
    g = c // TILE
    X = X.reshape(g, TILE, s)
    p = Params(*(t.reshape((g, TILE) + tuple(t.shape[1:])) for t in p))
    N = p.N.to(X.dtype)
    for trim in TRIMS:
        V = _velocities(X, (p.Vmax * trim).clamp(min=0), p)
        NV = N * V.unsqueeze(-1)
        F = X / (-NV).clamp(min=0).sum(-2)
        F = torch.where(F > 1, torch.ones_like(F), F)
        W = V * torch.where(NV < 0, F.unsqueeze(-2), torch.ones_like(NV)).amin(-1)
        X1 = (X + (N * W.unsqueeze(-1)).sum(-2)).clamp(min=0)
        X = _step(X, X1, W, V, p)
    return X.reshape(c, s)
