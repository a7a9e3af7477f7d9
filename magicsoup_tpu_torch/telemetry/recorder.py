"""
The zero-sync telemetry recorder.  Counterpart of
:mod:`magicsoup_tpu.telemetry.recorder`.

- **No extra device->host transfer.**  The per-step simulation metrics
  (alive count, occupancy, kill/divide/spawn counts, molecule-mass
  totals) are packed into the step record on the device by
  ``stepper._step_body`` and ride the one fetch the pipeline already
  makes.  The recorder only ever sees host Python scalars.
- **No synchronization.**  All timing is host-side ``time.perf_counter``
  spans around dispatch phases; nothing here touches a device tensor, so
  the stepper's enqueue stays sync-free with a recorder attached.
- **Bit-identity.**  The metric lanes are computed whether a recorder is
  attached or not, so deterministic trajectories cannot differ with
  telemetry on or off.
- **Bounded memory.**  Per-phase timing keeps exact count/total/max
  plus a bounded ring of recent samples for percentiles; the JSONL
  buffer flushes every ``flush_every`` rows.

Usage::

    world = World(..., telemetry="run.jsonl")     # or:
    world.telemetry.attach("run.jsonl")
    ... step ...
    stepper.flush()                               # drains + flushes rows
    print(world.telemetry.snapshot().to_dict())

then ``python -m magicsoup_tpu_torch.telemetry summarize run.jsonl``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
import warnings
import weakref

from magicsoup_tpu_torch.analysis import ownership
from magicsoup_tpu_torch.guard import chaos as _chaos
from magicsoup_tpu_torch.telemetry.summary import percentile

# per-phase sample rings are trimmed at this size (same bound as the
# stepper's trace ring): percentiles come from recent samples, totals
# and maxima stay exact over the full run
_RING = 4096
_TRIM = _RING // 2

# process-wide device->host fetch accounting, fed by util.fetch_host and
# the stepper's record fetcher
_fetch_lock = threading.Lock()
_fetch_count = 0
_fetch_bytes = 0


def note_fetch(nbytes: int) -> None:
    """Count one device->host fetch of ``nbytes``."""
    global _fetch_count, _fetch_bytes
    with _fetch_lock:
        _fetch_count += 1
        _fetch_bytes += int(nbytes)


def fetch_stats() -> dict[str, int]:
    """Process-total device->host fetches and bytes moved."""
    with _fetch_lock:
        return {"fetches": _fetch_count, "fetch_bytes": _fetch_bytes}


def runtime_counters() -> dict[str, int]:
    """One flat dict of every process-global counter: the dispatch,
    genome, chaos and device-time counters of
    ``analysis.runtime.snapshot`` plus the fetch accounting above."""
    from magicsoup_tpu_torch.analysis import runtime as _rt

    out = dict(_rt.snapshot())
    out.update(fetch_stats())
    return out


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """Point-in-time union of runtime counters and phase timings."""

    counters: dict
    phases: dict
    rows_emitted: int
    path: str | None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _close_handle(fh, buffered: list[str], lock) -> None:
    # weakref.finalize target: flush whatever the recorder still holds
    # buffered if it is garbage-collected while attached.  The finalizer
    # can fire at interpreter exit while a live emit() holds the buffer,
    # so it must take the same lock the recorder's writers hold.
    try:
        with lock:
            if buffered:
                fh.write("\n".join(buffered) + "\n")
            fh.close()
    # graftlint: disable=GL013 gc-time finalizer; nothing above it can react
    except Exception:  # noqa: BLE001 - gc-time finalizer; nothing above it can react
        pass


class TelemetryRecorder:
    """Host-side span timing + buffered JSONL emission.

    Always constructible and always cheap: an unattached recorder still
    accumulates phase timings (``span``/``note``/``phase_stats``) so the
    performance harnesses can share this implementation, but ``emit`` is
    a no-op until :meth:`attach` opens a JSONL sink.
    """

    def __init__(self, path=None, *, flush_every: int = 256) -> None:
        self._lock = threading.Lock()
        # phase -> [count, total_s, max_s, ring-of-recent-samples]
        self._phases: dict[str, list] = {}
        # phase -> seconds since last take_dispatch() (per-dispatch rows)
        self._window: dict[str, float] = {}
        self._buffer: list[str] = []
        self._fh = None
        self._finalizer = None
        self.path: str | None = None
        self.flush_every = max(1, int(flush_every))
        self.rows_emitted = 0
        # graceful degradation: an I/O failure on the sink disarms the
        # stream into this COUNTED state instead of raising through (or
        # silently losing) a simulation step
        self.degraded = False
        self.degraded_reason: str | None = None
        self.rows_dropped = 0
        # chaos/degraded transitions are PULLED from guard.chaos's event
        # ring at counter-emit boundaries (push would deadlock: the
        # telemetry.emit fault fires inside our own flush).  Start the
        # cursor at "now" so this stream only carries transitions from
        # its own lifetime.
        self._chaos_cursor = _chaos.events_since(0)[0]
        if path is not None:
            self.attach(path)

    # ------------------------------------------------------- lifecycle
    @classmethod
    def coerce(cls, value) -> "TelemetryRecorder":
        """Normalize ``World(telemetry=...)``: None -> fresh detached
        recorder, str/PathLike -> recorder attached to that path, an
        existing recorder passes through (shared across worlds)."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        return cls(path=value)

    @property
    def attached(self) -> bool:
        return self._fh is not None

    def attach(self, path) -> "TelemetryRecorder":
        """Open ``path`` for append and start emitting JSONL rows."""
        # the attaching thread owns the sink lifecycle (flush/detach);
        # concurrent emit() is fine — it only touches the locked buffer
        ownership.bind(self, "telemetry-writer")
        with self._lock:
            if self._fh is not None:
                raise ValueError(
                    f"already attached to {self.path}; detach() first"
                )
            self.path = str(path)
            self._fh = open(self.path, "a", encoding="utf-8")
            if self.degraded:
                # an explicit re-attach is the recovery path out of the
                # degraded state (rows_dropped stays — it is history)
                self.degraded = False
                self.degraded_reason = None
                _chaos.clear_degraded("telemetry.emit")
            self._finalizer = weakref.finalize(
                self, _close_handle, self._fh, self._buffer, self._lock
            )
        self.emit(
            {
                "type": "meta",
                "version": 1,
                # wall-clock on purpose: correlates the run with external
                # logs; never used for measurement (spans use perf_counter)
                # graftlint: disable=GL004 telemetry timestamp, not simulation state
                "wall": time.time(),
            }
        )
        self.emit_counters()
        self.flush()
        return self

    def detach(self) -> None:
        """Emit a final counters row, flush, and close the sink."""
        if self._fh is None:
            return
        ownership.assert_owner(
            self, "telemetry-writer", attribute="TelemetryRecorder._fh"
        )
        self.emit_counters()
        with self._lock:
            fh = self._fh
            if fh is None:
                return
            self._flush_locked()
            self._fh = None
            if self._finalizer is not None:
                self._finalizer.detach()
                self._finalizer = None
        fh.close()

    def __getstate__(self):
        # recorders ride on pickled Worlds; the file handle and lock do
        # not survive — the unpickled twin starts detached
        return {"flush_every": self.flush_every}

    def __setstate__(self, state):
        self.__init__(flush_every=state.get("flush_every", 256))

    # ---------------------------------------------------- span timing
    @contextlib.contextmanager
    def span(self, phase: str):
        """Time a host-side dispatch phase with ``perf_counter``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note(phase, time.perf_counter() - t0)

    def note(self, phase: str, seconds: float) -> None:
        """Record an externally measured duration under ``phase``."""
        with self._lock:
            rec = self._phases.get(phase)
            if rec is None:
                rec = self._phases[phase] = [0, 0.0, 0.0, []]
            rec[0] += 1
            rec[1] += seconds
            if seconds > rec[2]:
                rec[2] = seconds
            ring = rec[3]
            ring.append(seconds)
            if len(ring) > _RING:
                del ring[:_TRIM]
            self._window[phase] = self._window.get(phase, 0.0) + seconds

    def take_dispatch(self) -> dict[str, float]:
        """Milliseconds per phase since the previous call (and reset).

        The stepper calls this once per dispatch to build the
        ``dispatch`` JSONL row, so phase costs attribute to the dispatch
        that paid them."""
        with self._lock:
            out = {k: round(v * 1e3, 6) for k, v in self._window.items()}
            self._window.clear()
        return out

    def phase_stats(self) -> dict[str, dict]:
        """Aggregate per-phase stats (count/mean/p50/p95/max/total ms).

        count/total/max are exact over the recorder's lifetime; the
        percentiles come from the bounded recent-sample ring."""
        with self._lock:
            items = {
                name: (rec[0], rec[1], rec[2], list(rec[3]))
                for name, rec in self._phases.items()
            }
        out: dict[str, dict] = {}
        for name in sorted(items):
            n, total, mx, ring = items[name]
            out[name] = {
                "n": n,
                "mean_ms": round(total / n * 1e3, 4) if n else 0.0,
                "p50_ms": round(percentile(ring, 50) * 1e3, 4),
                "p95_ms": round(percentile(ring, 95) * 1e3, 4),
                "max_ms": round(mx * 1e3, 4),
                "total_ms": round(total * 1e3, 4),
            }
        return out

    # ------------------------------------------------------- emission
    def emit(self, row: dict) -> None:
        """Buffer one JSONL row (no-op when detached); auto-flushes
        every ``flush_every`` rows."""
        if self._fh is None:
            if self.degraded:
                with self._lock:
                    self.rows_dropped += 1
            return
        line = json.dumps(row, separators=(",", ":"))
        with self._lock:
            if self._fh is None:
                if self.degraded:
                    self.rows_dropped += 1
                return
            self._buffer.append(line)
            self.rows_emitted += 1
            if len(self._buffer) >= self.flush_every:
                self._flush_locked()

    def emit_counters(self) -> None:
        """Emit a ``counters`` row (attach/flush boundaries call this,
        giving the summarizer first/last values for delta reporting),
        preceded by any ``chaos``/``degraded`` transition rows recorded
        since the last drain."""
        if self._fh is None:
            return
        cursor, events = _chaos.events_since(self._chaos_cursor)
        self._chaos_cursor = cursor
        for row in events:
            self.emit(row)
        self.emit({"type": "counters", "counters": runtime_counters()})

    def flush(self, sync: bool = False) -> None:
        """Write buffered rows through to disk.  Idempotent and safe
        whether attached or not — shutdown paths (graceful-preemption
        handlers, the weakref finalizer) call it unconditionally.

        ``sync=True`` additionally fsyncs the file so the rows survive
        a power cut / SIGKILL that lands right after — the graceful
        SIGTERM drain uses this for its final telemetry flush.
        """
        if self._fh is not None:
            ownership.assert_owner(
                self, "telemetry-writer", attribute="TelemetryRecorder._fh"
            )
        with self._lock:
            self._flush_locked()
            if sync and self._fh is not None:
                import os

                try:
                    os.fsync(self._fh.fileno())
                except ValueError:
                    # not a real file (tests pass StringIO) or already
                    # closed — durability is best-effort on teardown.
                    # io.UnsupportedOperation subclasses ValueError, so
                    # this arm keeps absorbing the StringIO case while a
                    # REAL fsync failure falls through to degrade below
                    pass
                except OSError as exc:
                    self._degrade_locked(exc)

    def _flush_locked(self) -> None:
        if self._fh is None or not self._buffer:
            return
        try:
            fault = _chaos.site("telemetry.emit")
            if fault is not None:
                raise fault.as_oserror()
            self._fh.write("\n".join(self._buffer) + "\n")
            self._buffer.clear()
            self._fh.flush()
        except OSError as exc:
            self._degrade_locked(exc)

    def _degrade_locked(self, exc: OSError) -> None:
        # the telemetry degradation contract: a failed sink NEVER raises
        # into the stepper's dispatch loop and NEVER silently vanishes —
        # the stream disarms, the loss is counted (here + the process-
        # wide chaos registry), and exactly one warning names the cause
        dropped = len(self._buffer)
        self._buffer.clear()
        fh, self._fh = self._fh, None
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        self.degraded = True
        self.degraded_reason = f"{type(exc).__name__}: {exc}"
        self.rows_dropped += dropped
        if dropped:
            _chaos.note_counter("telemetry_rows_dropped", dropped)
        _chaos.note_degraded("telemetry.emit", self.degraded_reason)
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass  # the sink is already dead; a close failure adds nothing
        warnings.warn(
            f"telemetry stream to {self.path} degraded after an I/O "
            f"failure ({self.degraded_reason}); {dropped} buffered rows "
            "dropped, further rows are counted and discarded until "
            "re-attach"
        )

    # ------------------------------------------------------- snapshot
    def snapshot(self) -> TelemetrySnapshot:
        """Unified point-in-time view: process counters + phase stats."""
        return TelemetrySnapshot(
            counters=runtime_counters(),
            phases=self.phase_stats(),
            rows_emitted=self.rows_emitted,
            path=self.path,
        )


@contextlib.contextmanager
def trace_window(trace_dir: str):
    """Capture a ``torch.profiler`` trace (CPU and, where a card is
    present, CUDA activity) of the wrapped window and write it as a
    Chrome trace, ``trace.<pid>.<n>.json``, into ``trace_dir``.

    Wrap N steady-state steps (after warm-up, after ``drain()``) so the
    trace shows the repeating dispatch pattern; the stepper's ``ms:*``
    ``record_function`` ranges (``ms:activity``, ``ms:physics``,
    ``ms:divide``, ...) attribute the kernels to simulation phases::

        with telemetry.trace_window("/tmp/msoup-trace") as prof:
            for _ in range(20):
                stepper.step()
            stepper.drain()

    Yields the profiler, so a caller can read ``prof.key_averages()``;
    the written file's path is ``prof.trace_path`` after the block.
    """
    import itertools
    import os
    from pathlib import Path

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    for n in itertools.count():
        path = out / f"trace.{os.getpid()}.{n}.json"
        if not path.exists():
            break
    prof.export_chrome_trace(str(path))
    prof.trace_path = str(path)
