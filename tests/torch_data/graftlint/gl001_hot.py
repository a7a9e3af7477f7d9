"""GL001 fixture: a blocking host sync inside a hot-marked function."""
import torch


# graftlint: hot
def hot_loop(state: torch.Tensor):
    total = torch.sum(state)
    return total.item()  # GL001: .item() blocks the step loop
