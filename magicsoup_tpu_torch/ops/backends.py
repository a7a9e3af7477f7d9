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
  ``pallas``: fast mode only, early stop per tile of 8 cells, one launch
  for one world or for a batch of worlds.  On CPU tensors it runs its
  plain version at the same tile.  :func:`integrate_grouped` runs several
  groups of worlds (a fused fleet step's rungs) in one grouped launch.

:func:`resolve` keeps the JAX package's precedence: an explicit
``integrator`` argument, then the ``MAGICSOUP_TPU_TORCH_INTEGRATOR`` env
var, then the legacy ``use_pallas`` flag (``True`` is ``cuda``, the
counterpart of ``pallas``; ``False`` the torch body of the numeric mode),
then the numeric mode and the device (``torch-det`` when deterministic;
else ``cuda`` on a CUDA device, ``torch-fast`` on the CPU).

Every backend serves a mesh-placed world: each rank integrates its own
slot block, the ``cuda`` kernel with its per-tile early stop (a tile of 8
cells never straddles two ranks where a rank's block is a multiple of 8)
and the torch bodies with their batch-global stop summed over the ranks
(``integrate(..., mesh=)``).  The JAX package refuses ``pallas`` on a mesh
because a ``pallas_call`` has no SPMD partitioning rule; a rank's own
launch has no such limit, so the port keeps ``cuda`` as a card's default
on a mesh too.
"""

import os
from typing import NamedTuple

from magicsoup_tpu_torch.ops.cuda_integrate import (
    integrate_signals_cuda,
    integrate_signals_cuda_grouped,
)
from magicsoup_tpu_torch.ops.integrate import CellParams
from magicsoup_tpu_torch.ops.integrate import integrate_grouped as _integrate_body

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
    use_pallas: bool | None = None,
    deterministic: bool = False,
    device_type: str = "cuda",
) -> tuple[str, bool]:
    """Resolve the selection sources onto one backend name; returns
    ``(name, pinned)``, ``pinned`` False when the name follows from the
    numeric mode and device only.  ``integrator`` with a ``use_pallas``
    that disagrees with it (``True`` for any backend but ``cuda``, or
    ``False`` for ``cuda``) raises ``ValueError``, as does a choice that is
    not bit-reproducible under deterministic mode."""
    if integrator is not None and use_pallas is not None:
        if bool(use_pallas) != (get_backend(integrator).name == "cuda"):
            raise ValueError(
                f"integrator={integrator!r} conflicts with"
                f" use_pallas={use_pallas!r}; pass only integrator="
            )
    choice = integrator
    if choice is None:
        choice = os.environ.get(ENV_VAR, "") or None
    if choice is None and use_pallas is not None:
        choice = "cuda" if use_pallas else default_backend(deterministic, "cpu")
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


def integrate(name: str, X, params, mesh=None):
    """Dispatch one integrator step through backend ``name``.  ``X`` is
    ``(B, c, s)`` for B worlds, every parameter carrying the same leading
    world axis: ``cuda`` runs one kernel launch for all B worlds,
    ``torch-fast`` and ``torch-det`` their body per world (the early stop
    never spans two worlds).  ``X`` ``(c, s)`` is one world, run as
    ``B = 1``.  Under a ``mesh`` the rows are this rank's slot block: the
    torch bodies sum their stop count over the ranks."""
    if X.ndim == 2:
        Xb, pb = X[None], CellParams(*(t[None] for t in params))
        return (integrate(name, Xb, pb) if mesh is None else integrate(name, Xb, pb, mesh))[0]
    backend = get_backend(name)
    if backend.name == "cuda":
        return integrate_signals_cuda(X, params)
    if X.shape[1] == 0 and mesh is None:
        return X.clone()
    return _integrate_body(
        X,
        params,
        det=backend.name == "torch-det",
        stop_reduce=None if mesh is None or mesh.size == 1 else mesh.all_reduce,
    )


def integrate_grouped(names, Xs, params_list) -> list:
    """One integrator step for several groups of worlds (a fused fleet
    step's rungs), group g through backend ``names[g]`` on ``Xs[g]``
    (B_g, c_g, s_g) and ``params_list[g]``.  The ``cuda`` groups share
    one grouped kernel launch
    (:func:`~magicsoup_tpu_torch.ops.cuda_integrate.integrate_signals_cuda_grouped`);
    the ``torch-fast`` and ``torch-det`` groups run their own bodies one
    group after another, so each group's bits are those of
    :func:`integrate` on it alone.  Returns the outputs in group order."""
    outs: list = [None] * len(Xs)
    fused = [g for g, name in enumerate(names) if get_backend(name).name == "cuda"]
    for g, name in enumerate(names):
        if g not in fused:
            outs[g] = integrate(name, Xs[g], params_list[g])
    if fused:
        got = integrate_signals_cuda_grouped(
            [Xs[g] for g in fused], [params_list[g] for g in fused]
        )
        for g, out in zip(fused, got):
            outs[g] = out
    return outs
