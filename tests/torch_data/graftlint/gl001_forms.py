"""GL001 fixture, every torch form: each marked line is one finding in a
hot function; the host-metadata reads and the isinstance-guarded scalar
branch stay silent."""
import numpy as np
import torch


# graftlint: hot
def hot_forms(x: torch.Tensor, live):
    y = x * 2
    a = y.cpu()  # GL001: .cpu()
    b = y.numpy()  # GL001: .numpy()
    c = y.tolist()  # GL001: .tolist()
    d = float(y.sum())  # GL001: float()
    if y.max() > 0:  # GL001: if on a tensor
        y = y - 1
    rows = torch.nonzero(y)  # GL001: torch.nonzero
    picked = y[y > 0]  # GL001: boolean-mask indexing
    keep = y < 3
    kept = y[keep]  # GL001: mask through a name
    e = np.asarray(y)  # GL001: np.asarray
    assert (y >= 0).all()  # GL001: assert on a tensor
    n = y.shape[0] + y.numel() + y.dim() + y.stride(0)
    f = y.data_ptr() if y.is_contiguous() else 0
    if not isinstance(live, torch.Tensor):
        live = np.asarray(live, dtype=bool)
    return a, b, c, d, rows, picked, kept, e, n, f, live
