"""Clean fixture: idiomatic torch device code that must produce no findings."""
import torch


def doubled(x: torch.Tensor) -> torch.Tensor:
    return x + x


# graftlint: hot
def hot_shapes(x: torch.Tensor, params):
    # host metadata of a tensor is not a sync
    if x.dim() != 2 or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"bad input {tuple(x.shape)} on {x.device}")
    n = x.numel() + x.stride(0) + x.shape[0] + len(x)
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return torch.where(mask, x, x * 2), n


def summarize(arr):
    from magicsoup_tpu_torch.util import fetch_host

    host = fetch_host(arr)  # the sanctioned boundary
    return float(host.sum()), torch.zeros(1, device=arr.device)
