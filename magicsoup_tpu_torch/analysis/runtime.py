"""
The dispatch census: process-wide counters of device dispatches and of the
integrator launches they carried.  Counterpart of the dispatch counters of
:mod:`magicsoup_tpu.analysis.runtime` (``note_dispatch``,
``note_integrator_dispatch``, ``snapshot``); the JAX package's compile
counters have no role in eager PyTorch.

- ``dispatches`` counts fleet group dispatches, ``fused_groups`` the rung
  groups they carried (one each, without cross-rung fusion);
- ``integrator_dispatches_<backend>`` counts dispatches that ran the
  integrator through that backend: one per solo stepper dispatch and one
  per fleet group dispatch, whatever the megastep or the group size.
"""
import threading

_lock = threading.Lock()
_dispatches = 0
_fused_groups = 0
_integrator_dispatches: dict[str, int] = {}


def note_integrator_dispatch(backend: str, n: int = 1) -> None:
    """Count ``n`` dispatches that ran the integrator through ``backend``."""
    with _lock:
        _integrator_dispatches[backend] = _integrator_dispatches.get(backend, 0) + n


def note_dispatch(dispatches: int = 0, fused_groups: int = 0) -> None:
    """Count fleet dispatches and the rung groups they carried."""
    global _dispatches, _fused_groups
    with _lock:
        _dispatches += dispatches
        _fused_groups += fused_groups


def snapshot() -> dict[str, int]:
    """Every counter as one flat dict, read under one lock."""
    with _lock:
        out = {"dispatches": _dispatches, "fused_groups": _fused_groups}
        for name in sorted(_integrator_dispatches):
            out[f"integrator_dispatches_{name}"] = _integrator_dispatches[name]
    return out


def reset_counters() -> None:
    """Zero every counter (tests assert absolute values after it)."""
    global _dispatches, _fused_groups
    with _lock:
        _dispatches = 0
        _fused_groups = 0
        _integrator_dispatches.clear()
