"""
The dispatch census: process-wide counters of device dispatches and of the
integrator launches they carried, of compiles, restacks and re-attaches.
Counterpart of :mod:`magicsoup_tpu.analysis.runtime`, with its counter
names wherever the port has a counterpart.  As in the JAX package,
:func:`snapshot` also carries the chaos plane's counters (``chaos_fired``,
``degraded`` and every ``guard.chaos.note_counter`` key) and the
device-time census (``device_time_us``, ``device_dispatches``), so the
counters rows of a telemetry stream hold every counted failure.

- ``compiles`` (:func:`compile_count`) counts what a cold shape costs in
  eager PyTorch, where nothing is traced: each native library build that
  ran a compiler (``_build.build_shared``: nvcc or g++), and each program
  shape this process runs for the first time where the JAX package's jit
  would trace — a world's activity at a new ``(q, has_col, max_proteins,
  max_doms)`` (the JAX ``_activity_variant_key``, plus the device, the
  integrator and the signal count), a stepper dispatch at a new ``(q,
  megastep, compact)`` (plus the capacity and the token capacities), a
  fleet dispatch at a new rung key and group block or fused set — where
  the caching allocator grows to a new working set and a kernel sets its
  shared-memory size.  A warm shape charges 0, a cold one at least 1;
  ``World.prewarm_activity`` warms a shape without a step.  ``persistent_cache_hits`` / ``persistent_cache_misses``
  count the build cache's outcomes: a library found already built on disk
  is a hit, a compiler run a miss;
- ``restack_full`` / ``restack_inserts`` / ``restack_skipped`` count the
  fleet's group stack rebuilds, single-slot moves and residents left in
  place; ``attach_full`` / ``attach_skipped`` count a stepper's full
  re-attaches after a flush and the fast ones that found the world
  untouched and kept the host replay;
- ``phenotype_hits`` / ``phenotype_misses`` / ``phenotype_evictions`` /
  ``phenotype_pickle_drops`` count the phenotype caches' outcomes;
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
- in :func:`collective_stats`, ``collectives`` / ``collective_bytes`` /
  ``collective_us`` count the process-group collectives of a mesh
  (``parallel.tiled.Mesh``): calls, the bytes each call delivered to this
  rank, and the host microseconds spent inside them (staging through host memory included on the gloo
  route) — the port's counterpart of the collective census the JAX
  package reads off its compiled step programs;
- in :func:`phenotype_cache_stats`, ``pickle_drops`` counts the entries
  that phenotype caches dropped when they were pickled (a world saved
  and restored starts with an empty cache, so its first step translates
  every genome again: a cost, not a change of bits).

The guard half (:func:`hot_path_guard`, :class:`GuardStats`,
:class:`CompileBudgetExceeded`, :func:`sanctioned_transfer`) turns the
census into test-time assertions, with the JAX package's names, defaults
and messages.  Its transfer half is ``torch.cuda.set_sync_debug_mode``,
which is process-wide where ``jax.transfer_guard`` is per thread:
``util.fetch_host`` lifts the mode for its own copy (as
``jax.device_get`` passes a transfer guard), so while a sanctioned fetch
is in flight on any thread, a sync elsewhere passes unseen.  Without a
CUDA device the transfer half is inert (torch's sync debug mode only sees
CUDA syncs); the compile half works everywhere.  This module imports
neither torch nor jax: the guard reaches torch through ``util``.
"""
import contextlib
import threading

_lock = threading.Lock()
_compiles = 0
_cache_hits = 0
_cache_misses = 0
# program shapes dispatched so far; like a jit cache it survives
# reset_counters, so a warm shape stays warm
_shapes_seen: set = set()
_restack_full = 0
_restack_inserts = 0
_restack_skipped = 0
_attach_full = 0
_attach_skipped = 0
_pheno_hits = 0
_pheno_misses = 0
_pheno_evictions = 0
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
_collectives = 0
_collective_bytes = 0
_collective_us = 0


def compile_count() -> int:
    """Cold-shape costs so far in this process (see the module notes)."""
    with _lock:
        return _compiles


def note_build(compiled: bool) -> None:
    """Count one native library lookup: ``compiled`` when a compiler ran
    (a compile and a build-cache miss), else a build-cache hit."""
    global _compiles, _cache_hits, _cache_misses
    with _lock:
        if compiled:
            _compiles += 1
            _cache_misses += 1
        else:
            _cache_hits += 1


def note_program_shape(key) -> None:
    """Count a dispatch at program shape ``key`` as a compile the first
    time this process sees it."""
    global _compiles
    with _lock:
        if key not in _shapes_seen:
            _shapes_seen.add(key)
            _compiles += 1


class GuardStats:
    """Filled in when the guard window closes."""

    def __init__(self) -> None:
        self.compiles: int | None = None


class CompileBudgetExceeded(AssertionError):
    pass


#: hot_path_guard's ``transfers`` -> torch's sync debug mode (None keeps
#: the mode the window found)
_TRANSFER_MODES = {"disallow": "error", "log": "warn", "allow": None}


@contextlib.contextmanager
def hot_path_guard(compile_budget: int = 0, transfers: str = "disallow"):
    """Guard a hot-path window: no implicit transfers, at most
    ``compile_budget`` new program compilations.

    Budget choice: warm the functions under test FIRST (run one step of
    every variant the window will use), then wrap the steady-state loop
    with ``compile_budget=0`` — the steady state of a well-formed step
    loop compiles nothing.  A window that legitimately compiles (e.g. a
    capacity regrow) gets exactly that many, pinned, so growth is a
    reviewed decision rather than silent churn.

    ``transfers`` maps onto ``torch.cuda.set_sync_debug_mode``:
    ``"disallow"`` makes a synchronizing CUDA call (``.item()``,
    ``.cpu()``, ``torch.nonzero``, a pageable host->device copy...)
    raise, ``"log"`` warns, ``"allow"`` keeps the mode found.  The mode
    found is restored on exit, also on an exception.
    """
    if transfers not in _TRANSFER_MODES:
        raise ValueError(
            f"transfers={transfers!r}: expected one of {sorted(_TRANSFER_MODES)}"
        )
    from magicsoup_tpu_torch import util as _util

    stats = GuardStats()
    start = compile_count()
    live = _util.push_sync_mode(_TRANSFER_MODES[transfers])
    try:
        yield stats
    finally:
        held = _util.pop_sync_mode() if live else True
    if not held:
        raise AssertionError(
            "the CUDA sync debug mode changed inside the hot-path window, "
            "so part of it ran unguarded"
        )
    stats.compiles = compile_count() - start
    if stats.compiles > compile_budget:
        raise CompileBudgetExceeded(
            f"hot-path window compiled {stats.compiles} program(s), "
            f"budget is {compile_budget} — something in the loop is "
            "retracing (new shapes/dtypes/static args?) or was not warmed"
        )


def sanctioned_transfer(arr):
    """Explicit device->host fetch; allowed under transfer guards."""
    from magicsoup_tpu_torch import util as _util

    return _util.fetch_host(arr)


def note_restack(full: int = 0, inserts: int = 0, skipped: int = 0) -> None:
    """Count group stack rebuilds, single-slot moves and untouched
    residents (called by the fleet scheduler)."""
    global _restack_full, _restack_inserts, _restack_skipped
    with _lock:
        _restack_full += full
        _restack_inserts += inserts
        _restack_skipped += skipped


def note_attach(full: int = 0, skipped: int = 0) -> None:
    """Count re-attaches after a flush: ``full`` host-replay rebuilds and
    ``skipped`` fast ones that kept the host replay."""
    global _attach_full, _attach_skipped
    with _lock:
        _attach_full += full
        _attach_skipped += skipped


def note_phenotype_cache(hits: int = 0, misses: int = 0, evictions: int = 0) -> None:
    """Count phenotype-cache outcomes (called by the caches)."""
    global _pheno_hits, _pheno_misses, _pheno_evictions
    with _lock:
        _pheno_hits += hits
        _pheno_misses += misses
        _pheno_evictions += evictions


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


def note_collective(nbytes: int, seconds: float) -> None:
    """Count one collective of a mesh that delivered ``nbytes`` to this
    rank in ``seconds`` of host time."""
    global _collectives, _collective_bytes, _collective_us
    with _lock:
        _collectives += 1
        _collective_bytes += int(nbytes)
        _collective_us += int(seconds * 1e6)


def collective_stats() -> dict[str, int]:
    """The mesh collective counters, read under one lock."""
    with _lock:
        return {
            "collectives": _collectives,
            "collective_bytes": _collective_bytes,
            "collective_us": _collective_us,
        }


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
        return {
            "hits": _pheno_hits,
            "misses": _pheno_misses,
            "evictions": _pheno_evictions,
            "pickle_drops": _pheno_pickle_drops,
        }


def snapshot() -> dict[str, int]:
    """Every counter as one flat dict: the dispatch census read under one
    lock, then the chaos counters and the device-time census."""
    # runtime -> chaos and runtime -> metrics only: neither imports this
    # module, so the merge cannot cycle
    from magicsoup_tpu_torch.guard import chaos as _chaos
    from magicsoup_tpu_torch.telemetry import metrics as _metrics

    with _lock:
        out = {
            "compiles": _compiles,
            "persistent_cache_hits": _cache_hits,
            "persistent_cache_misses": _cache_misses,
            "phenotype_hits": _pheno_hits,
            "phenotype_misses": _pheno_misses,
            "phenotype_evictions": _pheno_evictions,
            "phenotype_pickle_drops": _pheno_pickle_drops,
            "restack_full": _restack_full,
            "restack_inserts": _restack_inserts,
            "restack_skipped": _restack_skipped,
            "attach_full": _attach_full,
            "attach_skipped": _attach_skipped,
            "dispatches": _dispatches,
            "fused_groups": _fused_groups,
            "genome_decode_calls": _genome_decode_calls,
            "genome_decode_rows": _genome_decode_rows,
        }
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
    included (tests assert absolute values after it).  The set of program
    shapes already dispatched is kept: a warm shape stays warm."""
    global _compiles, _cache_hits, _cache_misses
    global _restack_full, _restack_inserts, _restack_skipped
    global _attach_full, _attach_skipped, _pheno_hits, _pheno_misses, _pheno_evictions
    global _dispatches, _fused_groups, _genome_decode_calls, _genome_decode_rows
    global _genome_fetches, _genome_fetch_bytes, _pheno_pickle_drops
    global _genome_length_fetches, _genome_length_fetch_bytes
    global _collectives, _collective_bytes, _collective_us
    from magicsoup_tpu_torch.guard import chaos as _chaos
    from magicsoup_tpu_torch.telemetry import metrics as _metrics

    _chaos.reset_counters()
    _metrics.reset_device_time()
    with _lock:
        _compiles = _cache_hits = _cache_misses = 0
        _restack_full = _restack_inserts = _restack_skipped = 0
        _attach_full = _attach_skipped = 0
        _pheno_hits = _pheno_misses = _pheno_evictions = 0
        _dispatches = 0
        _fused_groups = 0
        _genome_decode_calls = _genome_decode_rows = 0
        _genome_fetches = _genome_fetch_bytes = 0
        _genome_length_fetches = _genome_length_fetch_bytes = 0
        _pheno_pickle_drops = 0
        _collectives = _collective_bytes = _collective_us = 0
        _integrator_dispatches.clear()
