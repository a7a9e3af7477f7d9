"""GL005 fixture: a D2H transfer outside the sanctioned boundary."""
import torch


def pull(n):
    x = torch.ones(n, device="cuda")
    return x.cpu()  # GL005: bypasses util.fetch_host
