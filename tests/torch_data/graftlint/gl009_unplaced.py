"""GL009 fixture: a tensor factory without ``device=`` in a hot function
of a device-placed module (top-level ``import torch``): the tensor lands
on the CPU, and the next op on a card fails or copies it over."""
import torch  # noqa: F401  (marks the module device-placed)


# graftlint: hot
def hot_attach(rows: torch.Tensor):
    staged = torch.zeros(rows.shape, dtype=torch.int32, device=rows.device)  # placed: clean
    mask = torch.zeros(rows.shape, dtype=torch.int32)  # GL009: lands on the CPU
    pinned = torch.empty(rows.shape, dtype=torch.int32, pin_memory=True)  # host on purpose
    return staged, mask, pinned


# cold functions are out of scope: setup-time placement is a one-off
def cold_setup(rows):
    return torch.as_tensor(rows)
