"""GL019 fixture: an implicit host sync the SHALLOW pass cannot see —
the device value arrives through a helper's return, so only the
interprocedural taint fixpoint knows the `if` blocks the step loop.
The host-counter branch and the explicitly fetched branch below it
stay silent."""
import torch

from magicsoup_tpu_torch.util import fetch_host


def _energy(state):
    return torch.sum(state)  # device producer: the taint source


def _n_pending(rows) -> int:
    return len(rows)  # plain python containers: host


# graftlint: hot
def hot_loop(state, rows):
    e = _energy(state)
    if e:  # GL019: `if` on a device value that flowed in through a call
        state = state + 1.0
    if _n_pending(rows):  # host int: no sync
        state = state * 2.0
    if fetch_host(_energy(state)):  # fetched once, explicitly: sanctioned
        state = state - 1.0
    return state
