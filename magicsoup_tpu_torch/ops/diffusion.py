"""
Molecule-map physics in plain PyTorch: diffusion (a 3x3 torus stencil per
molecule channel), membrane permeation and degradation.

Counterpart of :mod:`magicsoup_tpu.ops.diffusion`, with the same math:
diffusion kernel ``a = 1/(1/d + 8)`` off-center / ``b = 1 - 8a`` center
with wrap-around, the total-mass correction spread over all pixels,
clamping at zero, permeation factor ``1/(1/p + 1)`` exchanging between a
cell and its pixel, and per-species exponential decay.

The stencil is 9 ``torch.roll`` multiply-adds in the JAX package's fixed
tap order, not a convolution: a convolution would take cuDNN's tap order
(and TF32 by default on the card).  In deterministic mode it accumulates
in float64; the map totals of the mass correction use the fixed float64
tree in both modes.
"""
from contextlib import nullcontext

import numpy as np
import torch

from magicsoup_tpu_torch.ops.detmath import det_div, flush_denormal, sum_hw


def diffusion_kernels(diffusivities: list[float]) -> np.ndarray:
    """(n_mols, 3, 3) depthwise kernels from per-molecule diffusivities"""
    kernels = np.zeros((len(diffusivities), 3, 3), dtype=np.float32)
    for i, rate in enumerate(diffusivities):
        rate = min(abs(rate), 1.0)
        if rate == 0.0:
            a, b = 0.0, 1.0
        else:
            a = 1.0 / (1.0 / rate + 8.0)
            b = 1.0 - 8.0 * a
        kernels[i] = a
        kernels[i, 1, 1] = b
    return kernels


def permeation_factors(permeabilities: list[float]) -> np.ndarray:
    """(n_mols,) per-step exchange ratios from permeabilities"""
    out = np.zeros(len(permeabilities), dtype=np.float32)
    for i, rate in enumerate(permeabilities):
        rate = min(abs(rate), 1.0)
        out[i] = 0.0 if rate == 0.0 else 1.0 / (1.0 / rate + 1.0)
    return out


def degradation_factors(half_lives: list[float]) -> np.ndarray:
    """(n_mols,) per-step decay factors exp(-ln2 / half_life), computed on
    the host in float64 and stored float32"""
    return np.exp(
        # graftlint: disable=GL003 host decay-factor precompute, stored float32
        -np.log(2.0) / np.array(half_lives, dtype=np.float64)
    ).astype(np.float32)


def stencil_3x3(map_: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """The 9-tap torus stencil in the one fixed tap order.  Correlation
    semantics: out[x,y] += k[i,j] * map[x+i-1, y+j-1]."""
    out = torch.zeros_like(map_)
    for i in range(3):
        for j in range(3):
            out = out + kernels[:, i, j][:, None, None] * torch.roll(
                map_, shifts=(1 - i, 1 - j), dims=(1, 2)
            )
    return out


def diffuse(
    molecule_map: torch.Tensor, kernels: torch.Tensor, det: bool = False, mesh=None
) -> torch.Tensor:
    """
    One diffusion step: the stencil for every molecule channel at once,
    then the mass-conservation fixup (rounding errors spread over all
    pixels) and a clamp at zero.  Under a ``mesh`` ``molecule_map`` is
    this rank's row block and the step is
    :func:`magicsoup_tpu_torch.parallel.tiled.halo_diffuse`.
    """
    if mesh is not None:
        from magicsoup_tpu_torch.parallel.tiled import halo_diffuse

        return halo_diffuse(molecule_map, kernels, mesh, det=det)
    m = molecule_map.shape[1]
    with flush_denormal(molecule_map.device) if det else nullcontext():
        # f64 totals in BOTH modes: the fixup is a small difference of
        # large sums
        total_before = sum_hw(molecule_map)  # (mols,)
        if det:
            out = stencil_3x3(
                # graftlint: disable=GL003 sanctioned det-mode f64, as the JAX package's det path
                molecule_map.to(torch.float64), kernels.to(torch.float64)
            ).to(torch.float32)
            total_after = sum_hw(out)
            fix = det_div(
                total_before - total_after,
                torch.tensor(float(m * m), device=out.device),
            )
        else:
            out = stencil_3x3(molecule_map, kernels)
            total_after = sum_hw(out)
            fix = (total_before - total_after) / (m * m)
        out = out + fix[:, None, None]
        return torch.clamp(out, min=0.0)


def permeate(
    cell_molecules: torch.Tensor,  # (c, n_mols) intracellular
    ext_molecules: torch.Tensor,  # (c, n_mols) the cells' map pixels
    factors: torch.Tensor,  # (n_mols,)
    det: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange molecules between each cell and its pixel by the
    per-species permeation ratio; float64 in deterministic mode."""
    if det:
        with flush_denormal(cell_molecules.device):
            # graftlint: disable=GL003 sanctioned det-mode f64, as the JAX package's det path
            cm = cell_molecules.to(torch.float64)
            # graftlint: disable=GL003 sanctioned det-mode f64
            ext = ext_molecules.to(torch.float64)
            fac = factors.to(torch.float64)  # graftlint: disable=GL003 sanctioned det-mode f64
            d_int = cm * fac
            d_ext = ext * fac
            return (
                (cm + d_ext - d_int).to(torch.float32),
                (ext + d_int - d_ext).to(torch.float32),
            )
    d_int = cell_molecules * factors
    d_ext = ext_molecules * factors
    return cell_molecules + d_ext - d_int, ext_molecules + d_int - d_ext


def degrade(
    molecule_map: torch.Tensor, cell_molecules: torch.Tensor, factors: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decay all molecules by one step"""
    return molecule_map * factors[:, None, None], cell_molecules * factors
