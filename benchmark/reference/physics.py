"""
Map physics: per-species decay, a 3x3 diffusion stencil on the torus and
membrane permeation between a cell and its pixel (upstream magic-soup
1.0.5 ``world.py``: ``degrade_molecules`` and ``diffuse_molecules``).
"""
import math

import torch


def factors(chem: dict, device, dtype):
    """Per molecule: the diffusion stencil's off-centre and centre
    weights, the permeation ratio and the decay factor."""
    off, centre, perm, decay = [], [], [], []
    for m in chem["molecules"]:
        d = min(abs(m["diffusivity"]), 1.0)
        a = 0.0 if d == 0 else 1.0 / (1.0 / d + 8.0)
        off.append(a)
        centre.append(1.0 - 8.0 * a)
        p = min(abs(m["permeability"]), 1.0)
        perm.append(0.0 if p == 0 else 1.0 / (1.0 / p + 1.0))
        decay.append(math.exp(-math.log(2.0) / m["half_life"]))

    def t(v):
        # the program keeps each factor as float32
        return torch.tensor(v, dtype=torch.float32, device=device).to(dtype)

    return t(off), t(centre), t(perm), t(decay)


def diffuse_at(mm: torch.Tensor, xs, ys, off, centre) -> torch.Tensor:
    """The stencil's output at pixels ``(xs, ys)`` of the torus map ``mm``
    (mols, m, m), clamped at zero: the centre times the pixel plus the
    off-centre weight times each of its 8 neighbours.  The program spreads
    the stencil's rounding loss over the map; that term is below float32
    rounding and left out here."""
    m = mm.shape[-1]
    acc = centre[:, None] * mm[:, xs, ys]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx or dy:
                acc = acc + off[:, None] * mm[:, (xs + dx) % m, (ys + dy) % m]
    return acc.clamp(min=0)


def permeate(cm: torch.Tensor, ext: torch.Tensor, perm) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange between cells ``cm`` (c, mols) and their pixels ``ext``."""
    d_int, d_ext = cm * perm, ext * perm
    return cm + d_ext - d_int, ext + d_int - d_ext
