"""
The dispatch census: process-wide counters of device dispatches and of the
integrator launches they carried.  Counterpart of the dispatch counters of
:mod:`magicsoup_tpu.analysis.runtime` (``note_dispatch``,
``note_integrator_dispatch``, ``snapshot``); the JAX package's compile
counters have no role in eager PyTorch.  As in the JAX package,
:func:`snapshot` also carries the chaos plane's counters (``chaos_fired``,
``degraded`` and every ``guard.chaos.note_counter`` key) and the
device-time census (``device_time_us``, ``device_dispatches``), so the
counters rows of a telemetry stream hold every counted failure.

- ``dispatches`` counts fleet group dispatches, ``fused_groups`` the rung
  groups they carried (one each, without cross-rung fusion);
- ``integrator_dispatches_<backend>`` counts dispatches that ran the
  integrator through that backend: one per solo stepper dispatch and one
  per fleet group dispatch, whatever the megastep or the group size;
- in :func:`genome_stats`, ``genome_decode_calls`` / ``genome_decode_rows``
  count token -> string decodes of a token genome store and the rows
  they decoded (the JAX package's ``note_genome_decode``; a warm steady
  state decodes nothing), and ``genome_fetches`` /
  ``genome_fetch_bytes`` count whole-store host snapshots
  (``GenomeStore.host_arrays``, one synchronizing device->host copy
  each) and the bytes they moved, ``genome_length_fetches`` /
  ``genome_length_fetch_bytes`` the fetches of a store's length vector
  alone (``GenomeStore.host_lengths``, the token step row's);
- in :func:`phenotype_cache_stats`, ``pickle_drops`` counts the entries
  that phenotype caches dropped when they were pickled (a world saved
  and restored starts with an empty cache, so its first step translates
  every genome again: a cost, not a change of bits).
"""
import threading

_lock = threading.Lock()
_dispatches = 0
_fused_groups = 0
_integrator_dispatches: dict[str, int] = {}
_genome_decode_calls = 0
_genome_decode_rows = 0
_genome_fetches = 0
_genome_fetch_bytes = 0
_genome_length_fetches = 0
_genome_length_fetch_bytes = 0
_pheno_pickle_drops = 0


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


def note_genome_decode(rows: int = 0) -> None:
    """Count one token -> string decode of ``rows`` genome rows."""
    global _genome_decode_calls, _genome_decode_rows
    with _lock:
        _genome_decode_calls += 1
        _genome_decode_rows += rows


def note_genome_fetch(nbytes: int) -> None:
    """Count one host snapshot of a token genome store of ``nbytes``."""
    global _genome_fetches, _genome_fetch_bytes, _pheno_pickle_drops
    with _lock:
        _genome_fetches += 1
        _genome_fetch_bytes += nbytes


def note_genome_length_fetch(nbytes: int) -> None:
    """Count one host fetch of a token genome store's length vector."""
    global _genome_length_fetches, _genome_length_fetch_bytes
    with _lock:
        _genome_length_fetches += 1
        _genome_length_fetch_bytes += nbytes


def note_phenotype_pickle_drops(n: int) -> None:
    """Count ``n`` phenotype-cache entries dropped by a pickle."""
    global _pheno_pickle_drops
    with _lock:
        _pheno_pickle_drops += n


def phenotype_cache_stats() -> dict[str, int]:
    """The phenotype caches' process-wide counters, read under one lock."""
    with _lock:
        return {"pickle_drops": _pheno_pickle_drops}


def snapshot() -> dict[str, int]:
    """Every counter as one flat dict: the dispatch census read under one
    lock, then the chaos counters and the device-time census."""
    # runtime -> chaos and runtime -> metrics only: neither imports this
    # module, so the merge cannot cycle
    from magicsoup_tpu_torch.guard import chaos as _chaos
    from magicsoup_tpu_torch.telemetry import metrics as _metrics

    with _lock:
        out = {"dispatches": _dispatches, "fused_groups": _fused_groups}
        for name in sorted(_integrator_dispatches):
            out[f"integrator_dispatches_{name}"] = _integrator_dispatches[name]
    out.update(_chaos.runtime_counters())
    out.update(_metrics.device_time_stats())
    return out


def genome_stats() -> dict[str, int]:
    """The token genome store's counters, read under one lock."""
    with _lock:
        return {
            "genome_decode_calls": _genome_decode_calls,
            "genome_decode_rows": _genome_decode_rows,
            "genome_fetches": _genome_fetches,
            "genome_fetch_bytes": _genome_fetch_bytes,
            "genome_length_fetches": _genome_length_fetches,
            "genome_length_fetch_bytes": _genome_length_fetch_bytes,
        }


def reset_counters() -> None:
    """Zero every counter, the chaos counters and the device-time census
    included (tests assert absolute values after it)."""
    global _dispatches, _fused_groups, _genome_decode_calls, _genome_decode_rows
    global _genome_fetches, _genome_fetch_bytes, _pheno_pickle_drops
    global _genome_length_fetches, _genome_length_fetch_bytes
    from magicsoup_tpu_torch.guard import chaos as _chaos
    from magicsoup_tpu_torch.telemetry import metrics as _metrics

    _chaos.reset_counters()
    _metrics.reset_device_time()
    with _lock:
        _dispatches = 0
        _fused_groups = 0
        _genome_decode_calls = _genome_decode_rows = 0
        _genome_fetches = _genome_fetch_bytes = 0
        _genome_length_fetches = _genome_length_fetch_bytes = 0
        _pheno_pickle_drops = 0
        _integrator_dispatches.clear()
