"""
The reversible Michaelis-Menten signal integrator in plain PyTorch: the
counterpart of :mod:`magicsoup_tpu.ops.integrate`, with the same math,
order and numeric guards (see ``docs/mechanics.md``):

- three passes with Vmax trim factors (0.7, 0.2, 0.1);
- per pass: reversible MM velocity ``(kf - kb) / (1 + kf + kb)`` with
  allosteric modulation, a downward adjustment so no signal goes
  negative, and the Q-vs-Ke overshoot correction with increments
  (0.5, 0.25, 0.125, 0.0625) and its early stop;
- EPS/MAX clamps and NaN/Inf scrubbing exactly as in the JAX package.

Every function here works on a leading GROUP axis: X is ``(G, T, s)`` and
each parameter ``(G, T, p)`` or ``(G, T, p, s)``.  The equilibrium
correction's early-stop vote runs over each group of T cells.  With one
group (``G = 1, T = c``) that is the batch-global stop of the JAX
package's XLA path; with ``T = 8`` it is the per-tile stop of the Pallas
kernel and of the port's CUDA kernel
(:mod:`magicsoup_tpu_torch.ops.cuda_integrate`).

Two numeric modes, as in the JAX package:

- **fast**: signal products in log space, ``prod(X^N)`` as
  ``exp(sum(N * log X))``, and the allosteric factor in the same
  exp-sum-log form (the JAX package's ``mosaic_safe`` form, the one its
  Pallas kernel runs);
- **deterministic**: the fixed-order constructions of
  :mod:`magicsoup_tpu_torch.ops.detmath`, bit-equal to the JAX package's
  ``xla-det`` backend on the CPU.
"""
import contextlib
import os
from typing import NamedTuple

import torch

from magicsoup_tpu_torch.constants import EPS, MAX, MIN
from magicsoup_tpu_torch.ops.detmath import (
    det_div,
    flush_denormal,
    ipow,
    prod_axis,
    sum_axis,
)

TRIM_FACTORS = (0.7, 0.2, 0.1)
INCREMENTS = (0.5, 0.25, 0.125, 0.0625)
UPPER_THRESH = 1.5
LOWER_THRESH = 1 / 1.5

# N, Nf, Nb and A are stored i16: they are 4 of the 5 big (c, p, s)
# tensors, and the integrator is bound by the bytes it reads
INT_PARAM_DTYPE = torch.int16

# stand-in for log(0): large-negative but finite, so 0 * LOG0 == 0 keeps
# N=0 terms neutral, while one N>0 term at X=0 drags the log-space sum far
# below f32 exp underflow
LOG0 = -1e12


def default_deterministic() -> bool:
    """The deterministic-mode default from the environment, read at call
    time (``MAGICSOUP_TPU_DETERMINISTIC=1``)."""
    return os.environ.get("MAGICSOUP_TPU_DETERMINISTIC") == "1"


class CellParams(NamedTuple):
    """The 9 per-cell kinetic parameter tensors (c cells, p proteins,
    s signals = 2 * n_molecules)."""

    Ke: torch.Tensor  # (c,p) f32 equilibrium constants
    Kmf: torch.Tensor  # (c,p) f32 forward Michaelis constants
    Kmb: torch.Tensor  # (c,p) f32 backward Michaelis constants
    Kmr: torch.Tensor  # (c,p,s) f32 regulatory Km^hill per signal
    Vmax: torch.Tensor  # (c,p) f32 maximum velocities
    N: torch.Tensor  # (c,p,s) i16 net stoichiometry
    Nf: torch.Tensor  # (c,p,s) i16 forward (substrate) stoichiometry, >= 0
    Nb: torch.Tensor  # (c,p,s) i16 backward (product) stoichiometry, >= 0
    A: torch.Tensor  # (c,p,s) i16 allosteric hill exponents (+-)


def _where(cond: torch.Tensor, a, b: torch.Tensor) -> torch.Tensor:
    """``jnp.where`` with a Python scalar on either side, in b's dtype."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def _div(a: torch.Tensor, b: torch.Tensor, det: bool) -> torch.Tensor:
    return det_div(a, b) if det else a / b


def _sum_p(x: torch.Tensor, det: bool) -> torch.Tensor:
    """Float sum over the protein axis of a (G,T,p,s) tensor."""
    return sum_axis(x, -2) if det else x.sum(-2)


def _safe_log(X: torch.Tensor) -> torch.Tensor:
    """log(X) with X clamped into (0, MAX]: X=0 (and any NaN) maps to the
    LOG0 sentinel, X=Inf to log(MAX)."""
    return _where(X > 0.0, torch.log(torch.clamp(X, max=MAX)), LOG0)


def _prod_pow(logX: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """``prod_s(X^N)`` per (cell, protein) as ``exp(sum_s N*logX)``;
    overflow saturates to MAX."""
    e = (N.to(torch.float32) * logX.unsqueeze(-2)).sum(-1)
    xx = torch.exp(e)
    return _where(torch.isinf(xx), MAX, xx)


def _multiply_signals(X: torch.Tensor, N: torch.Tensor, det: bool):
    """``prod_s(X^N)`` per (cell, protein) with the reference's
    zero/NaN/Inf handling, plus which proteins are involved at all."""
    prots = (N > 0).any(-1)
    if not det:
        return _prod_pow(_safe_log(X), N), prots
    x = _where(N > 0, X.unsqueeze(-2), 0.0)
    # all callers pass Nf/Nb, which are >= 0 by construction
    xx = prod_axis(ipow(x, N, nonneg=True), -1)
    xx = _where(torch.isnan(xx), 0.0, xx)
    xx = _where(xx < 0.0, 0.0, xx)
    xx = _where(torch.isinf(xx), MAX, xx)
    return xx, prots


def _a_reg_logspace(X: torch.Tensor, A: torch.Tensor, Kmr: torch.Tensor):
    """Allosteric activity ``prod_s(X^A / (X^A + Kmr))`` with the power
    and the product in exp-sum-log form; ``X^A`` saturates at MAX, so a
    zero inhibitor gives ~1 and a zero activator 0."""
    is_reg = A != 0
    t = A.to(torch.float32) * _safe_log(X).unsqueeze(-2)
    log_max = torch.log(torch.tensor(MAX, dtype=torch.float32))
    xa = torch.exp(torch.minimum(t, log_max.to(t.device)))
    r = xa / (xa + Kmr)
    r = _where(torch.isnan(r), 1.0, r)
    r = _where(~is_reg, 1.0, r)
    lr = _where(r > 0.0, torch.log(r), LOG0)
    return torch.exp(lr.sum(-1))


def _velocities(X, Vmax, p: CellParams, det: bool) -> torch.Tensor:
    """Reversible-MM velocity with allosteric modulation."""
    kf, f_prots = _multiply_signals(X, p.Nf, det)
    kf = _div(kf, p.Kmf, det)
    kf = _where(f_prots, kf, 0.0)
    kf = _where(torch.isinf(kf), MAX, kf)

    kb, b_prots = _multiply_signals(X, p.Nb, det)
    kb = _div(kb, p.Kmb, det)
    kb = _where(b_prots, kb, 0.0)
    kb = _where(torch.isinf(kb), MAX, kb)

    a_cat = _div(kf - kb, 1 + kf + kb, det)

    if not det:
        a_reg = _a_reg_logspace(X, p.A, p.Kmr)
    else:
        # A<0 with X=0 gives Inf/Inf=NaN -> inhibitor absent -> active
        is_reg = p.A != 0
        x_reg = _where(is_reg, X.unsqueeze(-2), 0.0)
        a_reg_s = ipow(x_reg, p.A)
        a_reg_s = det_div(a_reg_s, a_reg_s + p.Kmr)
        a_reg_s = _where(torch.isnan(a_reg_s), 1.0, a_reg_s)
        a_reg_s = _where(~is_reg, 1.0, a_reg_s)
        a_reg = prod_axis(a_reg_s, -1)
        a_reg = _where(torch.isinf(a_reg), MAX, a_reg)

    V = a_cat * Vmax * a_reg
    return torch.clamp(V, MIN, MAX)


def _quotient(X: torch.Tensor, p: CellParams, det: bool) -> torch.Tensor:
    """Reaction quotient Q = prod(X^Nb) / prod(X^Nf)."""
    xx_prod, prod_prots = _multiply_signals(X, p.Nb, det)
    xx_prod = _where(prod_prots, xx_prod, 0.0)
    xx_prod = _where(torch.isinf(xx_prod), MAX, xx_prod)

    xx_subs, subs_prots = _multiply_signals(X, p.Nf, det)
    xx_subs = _where(subs_prots, xx_subs, 0.0)
    xx_subs = _where(torch.isinf(xx_subs), MAX, xx_subs)

    q = _div(xx_prod, xx_subs, det)
    return torch.nan_to_num(torch.clamp(q, EPS, MAX), nan=1.0)


def _negative_factors(X, N, V, det: bool) -> torch.Tensor:
    """Per-protein slow-down factors F_min (G,T,p) so no signal is
    removed below zero."""
    NV = N.to(torch.float32) * V.unsqueeze(-1)  # (G,T,p,s)
    removed = _sum_p(torch.clamp(-NV, min=0.0), det)  # (G,T,s)
    F = _div(X, removed, det)  # NaN/Inf where nothing is removed
    F = _where(F > 1.0, 1.0, F)
    F_prots = _where(NV < 0.0, F.unsqueeze(-2), 1.0)
    return F_prots.amin(-1)  # propagates NaN, like jnp.min


def _weighted_dx(X0, N, W, det: bool) -> torch.Tensor:
    """``X0 + sum_p N*W``."""
    return X0 + _sum_p(N.to(torch.float32) * W.unsqueeze(-1), det)


def _equilibrium_adjusted_x(X0, X1, N, W, V, p: CellParams, det: bool):
    """Adjust velocities down (or back up) so the reaction quotient does
    not overshoot Ke.  The correction stops for a whole group once no
    impactful protein of the group needs adjustment."""
    has_impact = V.abs() > 0.1
    is_fwd = V > 0.0
    F = torch.ones_like(V)  # (G,T,p)
    stopped = torch.zeros(
        (V.shape[0], 1, 1), dtype=torch.bool, device=V.device
    )

    for increment in INCREMENTS:
        Q1 = _quotient(X1, p, det)
        QKe = _div(Q1, p.Ke, det)

        # fwd: Q approaches Ke from below, QKe > 1 is overshoot; bwd mirrored
        v_too_low = torch.where(is_fwd, QKe < LOWER_THRESH, QKe > UPPER_THRESH)
        v_too_low = v_too_low & ~(is_fwd & (F == 1.0))
        v_too_high = torch.where(is_fwd, QKe > UPPER_THRESH, QKe < LOWER_THRESH)
        v_too_high = v_too_high & ~(~is_fwd & (F == 0.0))

        needs_adj = (v_too_low | v_too_high) & has_impact
        stopped = stopped | (needs_adj.sum((-2, -1)) == 0).view(-1, 1, 1)
        apply = ~stopped

        F = torch.where(apply & v_too_high, F - increment, F)
        F = torch.where(apply & v_too_low, F + increment, F)
        F = torch.clamp(F, 0.0, 1.0)

        X_new = _weighted_dx(X0, N, W * F, det)
        X_new = _where(X_new < 0.0, 0.0, X_new)
        X1 = torch.where(apply, X_new, X1)

    return X1


def _integrate_part(X0, adj_vmax, p: CellParams, det: bool) -> torch.Tensor:
    """One trim pass."""
    V = _velocities(X0, adj_vmax, p, det)
    W = V * _negative_factors(X0, p.N, V, det)
    X1 = _weighted_dx(X0, p.N, W, det)
    X1 = _where(X1 < 0.0, 0.0, X1)  # small fp errors can give -1e-7
    return _equilibrium_adjusted_x(X0, X1, p.N, W, V, p, det)


def integrate_grouped(
    X: torch.Tensor, params: CellParams, det: bool
) -> torch.Tensor:
    """One integrator step over grouped signals ``X`` (G, T, s) and
    parameters with the same two leading axes."""
    with flush_denormal(X.device) if det else contextlib.nullcontext():
        for trim in TRIM_FACTORS:
            X = _integrate_part(
                X, torch.clamp(params.Vmax * trim, min=0.0), params, det
            )
    return X


def group_rows(t: torch.Tensor, tile_c: int) -> torch.Tensor:
    """``(c, ...)`` -> ``(c // tile_c, tile_c, ...)`` (a view)."""
    return t.reshape((t.shape[0] // tile_c, tile_c) + tuple(t.shape[1:]))


def integrate_signals(
    X: torch.Tensor, params: CellParams, det: bool | None = None
) -> torch.Tensor:
    """
    Simulate protein work for one time step over signals ``X`` (c, s);
    returns the updated signals.  ``det`` selects the deterministic mode
    (default from ``MAGICSOUP_TPU_DETERMINISTIC``).  The early stop is
    batch-global, as in the JAX package's XLA path.
    """
    if det is None:
        det = default_deterministic()
    c = X.shape[0]
    if c == 0:
        return X.clone()
    out = integrate_grouped(
        group_rows(X, c), CellParams(*(group_rows(t, c) for t in params)), det
    )
    return out.reshape(X.shape)
