"""
Integrator backend plane: the one selection path for the MM integrator.

Counterpart of :mod:`magicsoup_tpu.ops.backends`, with the port's three
backends:

- ``torch-fast`` — the log-space integrator in plain PyTorch with one
  batch-global early stop (the counterpart of ``xla-fast``); it is
  :func:`~magicsoup_tpu_torch.ops.cuda_integrate.integrate_signals_tiled`
  with one tile, so it cannot drift from the kernel's plain version.
- ``torch-det`` — the deterministic integrator (``det=True``), bit-equal
  to ``xla-det`` on the CPU.
- ``cuda`` — the hand-written CUDA kernel
  (:mod:`magicsoup_tpu_torch.ops.cuda_integrate`), the counterpart of
  ``pallas``: fast mode only, early stop per tile of 8 cells.  On CPU
  tensors it runs its plain version at the same tile.

:func:`resolve` keeps the JAX package's precedence: an explicit
``integrator`` argument, then the ``MAGICSOUP_TPU_TORCH_INTEGRATOR`` env
var, then the numeric mode and the device (``torch-det`` when
deterministic; else ``cuda`` on a CUDA device, ``torch-fast`` on the CPU).
"""

import functools
import os
from typing import NamedTuple

from magicsoup_tpu_torch.ops.cuda_integrate import (
    integrate_signals_cuda,
    integrate_signals_tiled,
)
from magicsoup_tpu_torch.ops.integrate import integrate_signals

#: env var naming a backend explicitly (below the ``integrator`` argument)
ENV_VAR = "MAGICSOUP_TPU_TORCH_INTEGRATOR"


class IntegratorBackend(NamedTuple):
    """One registered integrator backend and its capability flag.

    ``det_able``: bit-reproducible (may serve a world in deterministic
    mode)."""

    name: str
    det_able: bool


REGISTRY: dict[str, IntegratorBackend] = {
    b.name: b
    for b in (
        IntegratorBackend("torch-fast", det_able=False),
        IntegratorBackend("torch-det", det_able=True),
        IntegratorBackend("cuda", det_able=False),
    )
}


def get_backend(name: str) -> IntegratorBackend:
    """Look up a backend by name; unknown names are a ``ValueError``."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator backend {name!r} "
            f"(want one of {sorted(REGISTRY)})"
        ) from None


def default_backend(deterministic: bool, device_type: str) -> str:
    """The backend a world uses when nothing is pinned."""
    if deterministic:
        return "torch-det"
    return "cuda" if device_type == "cuda" else "torch-fast"


def resolve(
    integrator: str | None = None,
    *,
    deterministic: bool = False,
    device_type: str = "cuda",
) -> tuple[str, bool]:
    """Resolve the selection sources onto one backend name; returns
    ``(name, pinned)``, ``pinned`` False when the name follows from the
    numeric mode and device only.  A choice that is not bit-reproducible
    under deterministic mode raises ``ValueError``."""
    choice = integrator
    if choice is None:
        choice = os.environ.get(ENV_VAR, "") or None
    if choice is None:
        return default_backend(deterministic, device_type), False
    backend = get_backend(choice)
    if deterministic and not backend.det_able:
        raise ValueError(
            f"integrator backend {backend.name!r} is not bit-reproducible:"
            " deterministic mode needs 'torch-det'; unset"
            " MAGICSOUP_TPU_DETERMINISTIC or pick it"
        )
    return backend.name, True


@functools.lru_cache(maxsize=None)
def integrator_fn(name: str):
    """The backend's integrator as a plain ``(X, params) -> X1`` callable."""
    backend = get_backend(name)
    if backend.name == "cuda":
        return integrate_signals_cuda
    if backend.name == "torch-det":
        return functools.partial(integrate_signals, det=True)

    def torch_fast(X, params):
        return integrate_signals_tiled(X, params, tile_c=max(X.shape[0], 1))

    return torch_fast


def integrate(name: str, X, params):
    """Dispatch one integrator step through backend ``name``."""
    return integrator_fn(name)(X, params)
