"""GL003 fixture: float64 outside ops/detmath.py."""
import torch


def widen(x):
    return x.to(torch.float64)  # GL003: f64 outside detmath
