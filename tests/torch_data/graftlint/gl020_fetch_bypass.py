"""GL020 fixture: a device->host conversion OUTSIDE util.fetch_host —
the value is only known to be device-resident interprocedurally (it
comes back from a helper), and `.cpu()` pulls it to host without
touching the metered fetch counters.  The fetch_host form and the
host-array conversion below it stay silent."""
import numpy as np
import torch

from magicsoup_tpu_torch.util import fetch_host


def _integrate(x):
    return torch.cumsum(x, 0)  # device producer


def snapshot(x) -> dict:
    dev = _integrate(x)
    return {"trace": dev.cpu()}  # GL020: unmetered D2H crossing


def snapshot_metered(x) -> dict:
    dev = _integrate(x)
    return {"trace": fetch_host(dev)}  # the sanctioned, billed boundary


def repack(rows: list) -> np.ndarray:
    return np.asarray(rows)  # host list in, host array out: no crossing
