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
- **One span mechanism.**  :meth:`TelemetryRecorder.span` and the
  module-level :func:`span` (for code that holds no recorder; it goes to
  the recorder whose span is open on the thread) time a phase on the
  host, note its self time (its duration less that of the spans nested
  in it on its thread), and, only while a ``torch.profiler`` records,
  open a ``record_function`` range of the same name, on the clock of
  the device trace.  :func:`count` adds to a counter at the same
  boundaries; :func:`span_totals` and :func:`counter_totals` are the
  process-wide totals, and those of the latest profiled window.

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

import torch

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


# ------------------------------------------------------------------ spans
# the open spans of each thread, innermost last
_tls = threading.local()
_totals_lock = threading.Lock()
# span name -> [n, total_s, self_s]; counter name -> sum.  "all" holds
# every span and count of the process, "profiled" those of the latest
# window in which a torch profiler recorded
_span_totals: dict[str, dict[str, list]] = {"all": {}, "profiled": {}}
_counter_totals: dict[str, dict[str, int]] = {"all": {}, "profiled": {}}
_profiling = torch._C._autograd._profiler_enabled
_profiled_window = False  # whether the last span or count saw a profiler


def _profiled() -> bool:
    """Whether a profiler records now; the first span or count of a
    profiled window clears the profiled totals of the last one."""
    global _profiled_window
    on = _profiling()
    if on != _profiled_window:
        with _totals_lock:
            if on and not _profiled_window:
                _span_totals["profiled"].clear()
                _counter_totals["profiled"].clear()
            _profiled_window = on
    return on


def _open_spans() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _add_span(table: dict, name: str, seconds: float, self_s: float) -> None:
    rec = table.get(name)
    if rec is None:
        rec = table[name] = [0, 0.0, 0.0]
    rec[0] += 1
    rec[1] += seconds
    rec[2] += self_s


class _Span:
    """One span: entered by ``with``, see :func:`span`."""

    __slots__ = ("name", "recorder", "child_s", "_t0", "_range")

    def __init__(self, name: str, recorder: "TelemetryRecorder | None"):
        self.name = name
        self.recorder = recorder

    def __enter__(self) -> "_Span":
        stack = _open_spans()
        if self.recorder is None and stack:
            self.recorder = stack[-1].recorder
        self._range = None
        if _profiled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.child_s = 0.0
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            # spans above it were left open by an exception
            del stack[stack.index(self):]
        else:
            stack = ()  # an abandoned sequence's span, already off the stack
        if stack:
            stack[-1].child_s += seconds
        profiled = self._range is not None
        if profiled:
            self._range.__exit__(*exc)
        self_s = seconds - self.child_s
        with _totals_lock:
            _add_span(_span_totals["all"], self.name, seconds, self_s)
            if profiled:
                _add_span(_span_totals["profiled"], self.name, seconds, self_s)
        if self.recorder is not None:
            self.recorder._note_span(self.name, seconds, self_s)


def span(name: str) -> _Span:
    """A span for code that holds no recorder: ``with span("ms:lengths"):``.
    It goes to the recorder whose span is open on the current thread (to
    none where no span is open), and to the process-wide
    :func:`span_totals`; while a profiler records it is also a
    ``record_function`` range."""
    return _Span(name, None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``: process-wide, in the profiled
    window's totals while a profiler records, and on the recorder whose
    span is open on the current thread."""
    profiled = _profiled()
    with _totals_lock:
        for key in ("all", "profiled") if profiled else ("all",):
            table = _counter_totals[key]
            table[name] = table.get(name, 0) + n
    stack = _open_spans()
    if stack and stack[-1].recorder is not None:
        stack[-1].recorder._count(name, n)


def span_totals(profiled: bool = False) -> dict[str, tuple[int, float, float]]:
    """Process-wide ``{name: (n, total_s, self_s)}`` of every span since
    the process started, whichever recorder it went to (take differences
    over a window); with ``profiled``, of the spans entered while a
    ``torch.profiler`` recorded, in the latest profiled window: the host
    side of a device trace."""
    with _totals_lock:
        table = _span_totals["profiled" if profiled else "all"]
        return {k: (v[0], v[1], v[2]) for k, v in table.items()}


def counter_totals(profiled: bool = False) -> dict[str, int]:
    """Process-wide ``{name: sum}`` of every :func:`count`; with
    ``profiled``, of those made in the latest profiled window."""
    with _totals_lock:
        return dict(_counter_totals["profiled" if profiled else "all"])


class phases:
    """Consecutive spans over the phases of one function body:
    ``phase(name)`` closes the open span and opens the next,
    ``phase(None)`` closes the last.  A sequence that an exception left
    open on the thread is closed by the next one made there."""

    __slots__ = ("_open",)

    def __init__(self):
        left = getattr(_tls, "sequence", None)
        if left is not None and left._open is not None:
            # take only its span off the stack: spans opened since stay open
            _open_spans().remove(left._open)
            left(None)
        self._open = None

    def __call__(self, name: str | None) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
            _tls.sequence = None
        if name is not None:
            self._open = _Span(name, None).__enter__()
            _tls.sequence = self


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
        # span -> [n, total_s, self_s]; counter -> sum (see count())
        self._spans: dict[str, list] = {}
        self._counts: dict[str, int] = {}
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
    def span(self, phase: str) -> _Span:
        """Time a host-side phase with ``perf_counter``: noted under
        ``phase`` as :meth:`note` does, its self time in
        :meth:`self_times`, and a ``record_function`` range while a
        profiler records (the module-level :func:`span`, bound to this
        recorder)."""
        return _Span(phase, self)

    def note(self, phase: str, seconds: float) -> None:
        """Record an externally measured duration under ``phase``."""
        with self._lock:
            self._note_locked(phase, seconds)

    def _note_span(self, phase: str, seconds: float, self_s: float) -> None:
        with self._lock:
            self._note_locked(phase, seconds)
            _add_span(self._spans, phase, seconds, self_s)

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def _note_locked(self, phase: str, seconds: float) -> None:
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

    def self_times(self) -> dict[str, tuple[int, float, float]]:
        """Per span name, ``(n, total_s, self_s)`` over the recorder's
        lifetime: self seconds leave out the time of the spans nested in
        it on its thread, so the self times of nested spans add up to
        the outermost's total.  Durations given to :meth:`note` are not
        spans and are not here."""
        with self._lock:
            return {k: (v[0], v[1], v[2]) for k, v in self._spans.items()}

    def counts(self) -> dict[str, int]:
        """Counters (:func:`count`) made while this recorder's span was
        the innermost open one on the thread."""
        with self._lock:
            return dict(self._counts)

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
