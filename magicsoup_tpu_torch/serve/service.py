"""
The service core: one scheduler loop, many tenants, HTTP edges.
Counterpart of :mod:`magicsoup_tpu.serve.service`, over the port's fleet,
warden, guard and telemetry; the service runs on the card unless the
caller asks for the CPU (``device="cpu"``).

:class:`FleetService` is the long-lived owner of a
:class:`~magicsoup_tpu_torch.fleet.FleetScheduler` /
:class:`~magicsoup_tpu_torch.fleet.FleetWarden` pair:

- **Single writer.**  All fleet and device state is touched by exactly
  one thread, the scheduler loop (:meth:`FleetService.run`).  HTTP
  handler threads enqueue commands on a BOUNDED queue and block on a
  per-command completion event (with a timeout, so a wedged loop
  surfaces as a 504).  ``GET /healthz`` and ``GET /metrics`` read the
  loop's last published snapshot, because liveness probes must not queue
  behind work.
- **Budgeted stepping.**  ``POST /tenants/<id>/step`` only ADDS to the
  tenant's megastep budget; the loop serves one group megastep per tick
  to every runnable tenant, so tenants advance in lockstep.
- **A budget pause is invisible to the trajectory.**  A tenant whose
  budget reaches zero is suspended (:meth:`FleetWarden.suspend`, a
  scheduler ``retire`` that keeps the lane object); the next budget
  resumes the SAME lane.  A world stepped ``2N`` times in one request is
  bit-identical to one stepped ``N`` twice.

Crash safety: every tenant has its own rolling checkpoint stream
(``worlds/world-<label>-*.msck``), written every ``checkpoint_cadence``
TENANT megasteps, so the cadence is part of the deterministic schedule.
The static registry (``tenants.json``, atomic rewrite, format
:data:`REGISTRY_FORMAT`) maps tenant ids to labels and specs; all dynamic
state (budget, served counters, accounting) rides in checkpoint meta.  On
SIGTERM the loop drains, checkpoints every tenant and exits 0; after
SIGKILL a restarted service on the same directory re-adopts every tenant
from its stream, det-mode digests bit-identical to a run that was never
killed.  A directory written by the JAX package's service carries that
package's registry format and is refused (HTTP 500), not misread.
"""
from __future__ import annotations

import json
import queue
import threading
import time
import warnings
from dataclasses import dataclass, field
from http.server import ThreadingHTTPServer
from pathlib import Path

from magicsoup_tpu_torch.analysis import ownership
from magicsoup_tpu_torch.analysis import runtime as _runtime
from magicsoup_tpu_torch.analysis.ownership import owned_by
from magicsoup_tpu_torch.guard import chaos as _chaos
from magicsoup_tpu_torch.guard.backoff import BackoffPolicy
from magicsoup_tpu_torch.guard.io import atomic_write_text
from magicsoup_tpu_torch.serve import api
from magicsoup_tpu_torch.serve.accounting import AccountingLedger
from magicsoup_tpu_torch.serve.admission import AdmissionController

__all__ = ["FleetService", "tenant_digest"]

REGISTRY_FORMAT = "magicsoup_tpu_torch.serve.registry/1"


def tenant_digest(lane) -> str:
    """sha256 over a lane's full resume-relevant state (flushes first).

    Field-per-field hashing in sorted key order: pickling the fields
    together would let pickle's memo turn cross-field aliasing (live run)
    versus equal-but-distinct copies (restored run) into different bytes
    for identical values.  A digest request is a flush, which is part of
    the deterministic schedule: compare runs that digest at the same
    tenant steps.  The fields are the JAX package's, but the stepper key
    is the port's ``(B, 2)`` int64 threefry words, so a digest compares
    port runs with each other; hold a world against the JAX package with
    :func:`magicsoup_tpu_torch.check.differential.state_digest`.
    """
    import hashlib
    import pickle

    import numpy as np

    from magicsoup_tpu_torch import guard
    from magicsoup_tpu_torch.util import fetch_host

    world = lane.world
    snap = guard.snapshot_run(world, lane)
    aux = snap["stepper"]
    state = dict(
        n_cells=world.n_cells,
        genomes=list(world.cell_genomes),
        labels=list(world.cell_labels),
        mm=fetch_host(world.molecule_map),
        cm=np.asarray(world.cell_molecules),
        positions=np.asarray(world.cell_positions),
        lifetimes=np.asarray(world.cell_lifetimes),
        divisions=np.asarray(world.cell_divisions),
        world_rng=snap["world_rng_state"],
        world_nprng=snap["world_nprng_state"],
        key=np.asarray(aux["key"]),
        stepper_rng=aux["rng_state"],
        spawn_queue=aux["spawn_queue"],
        growth_hist=aux["growth_hist"],
        change_seq=aux["change_seq"],
        dispatched_seq=aux["dispatched_seq"],
    )
    digest = hashlib.sha256()
    for name in sorted(state):
        digest.update(name.encode())
        digest.update(hashlib.sha256(pickle.dumps(state[name])).digest())
    return digest.hexdigest()


@dataclass
class _Command:
    """One queued request: the loop fills result/error and sets done.

    ``t_enqueue`` (monotonic) is stamped at submit: the loop folds the
    enqueue-to-done span into the per-command latency histogram, and
    the handler-side ``/healthz``/``/metrics`` edges report the oldest
    pending command's age from it — a wedged loop is visible the
    moment its queue stops draining, not only after the 504."""

    name: str
    payload: dict
    done: threading.Event = field(default_factory=threading.Event)
    result: dict | None = None
    error: Exception | None = None
    t_enqueue: float = 0.0


@dataclass
class _Tenant:
    """Service-side record of one admitted world."""

    tenant: str
    label: int
    spec: dict
    sig: str = ""  # spec_signature, cached (admission bookkeeping)
    lane: object | None = None
    budget: int = 0  # megasteps requested but not yet served
    megasteps: int = 0  # tenant megasteps served (the cadence clock)
    cadence: int = 0  # checkpoint every N tenant megasteps (0 = manual)


#: latency histogram bounds (seconds) shared by the tick-duration and
#: per-command latency families — fixed buckets, so scrape output is
#: structurally stable across runs
_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

#: per-tenant ledger counters exposed as /metrics families, with the
#: ledger field each one is pinned to (device time renders as ms)
_TENANT_FAMILIES = (
    ("magicsoup_tenant_steps_total", "steps", "World steps served"),
    ("magicsoup_tenant_megasteps_total", "megasteps", "Tenant megasteps served"),
    ("magicsoup_tenant_dispatches_total", "dispatches", "Device dispatches the tenant rode"),
    ("magicsoup_tenant_fetch_bytes_total", "fetch_bytes", "Tenant share of physical D2H fetch bytes"),
    ("magicsoup_tenant_device_ms_total", "device_us", "Tenant share of measured device time (milliseconds)"),
)

#: runtime-counter keys that are NOT monotone (current state, not a
#: running total) — exposed as gauges instead of counters
_RUNTIME_GAUGE_KEYS = ("degraded",)


def _build_metrics(reg):
    """Declare every /metrics family up front (metrics registry):
    fixed families mean the exposition's HELP/TYPE structure is stable
    across restarts, which the format-pinning tests rely on."""
    reg.counter(
        "magicsoup_device_ms_total",
        "Total measured device time, commit to fetch-ready (milliseconds)",
    )
    reg.counter(
        "magicsoup_device_dispatches_total",
        "Physical device dispatches timed by the device census",
    )
    reg.counter(
        "magicsoup_megasteps_total", "Tenant megasteps served by the loop"
    )
    reg.counter(
        "magicsoup_scrapes_total", "GET /metrics scrapes served"
    )
    reg.counter(
        "magicsoup_runtime_total",
        "Process runtime counters (compiles, caches, restack/attach, "
        "fetch census) keyed by counter name",
        ("counter",),
    )
    reg.counter(
        "magicsoup_integrator_dispatches_total",
        "Physical integrator program launches per backend "
        "(ops.backends registry name)",
        ("backend",),
    )
    for name, _, help_text in _TENANT_FAMILIES:
        reg.counter(name, help_text, ("tenant",))
    reg.gauge("magicsoup_tenants", "Admitted tenants")
    reg.gauge("magicsoup_queued_tenants", "Creates parked in the admission queue")
    reg.gauge("magicsoup_lost_tenants", "Registered but unrecoverable tenants")
    reg.gauge(
        "magicsoup_backlog_megasteps", "Requested megasteps not yet served"
    )
    reg.gauge(
        "magicsoup_worlds",
        "Worlds per warden state (active/suspended/quarantined/...)",
        ("state",),
    )
    reg.gauge(
        "magicsoup_degraded",
        "Counted degradation events per subsystem (0 = recovered)",
        ("subsystem",),
    )
    reg.gauge(
        "magicsoup_runtime_gauge",
        "Non-monotone runtime counters (current state) by name",
        ("counter",),
    )
    reg.gauge(
        "magicsoup_command_queue_depth",
        "Commands waiting in the single-writer loop's queue (read-time)",
    )
    reg.gauge(
        "magicsoup_oldest_command_age_seconds",
        "Age of the oldest pending command (read-time; 0 when idle)",
    )
    reg.histogram(
        "magicsoup_tick_seconds",
        "Scheduler-loop tick duration",
        _LATENCY_BUCKETS,
    )
    reg.histogram(
        "magicsoup_command_latency_seconds",
        "Command enqueue-to-done latency",
        _LATENCY_BUCKETS,
        ("command",),
    )
    return reg


class FleetService:
    """Multi-tenant serving front-end over one fleet.

    Parameters:
        device: Where every tenant's world is built, stepped and
            restored; ``None`` means the card and raises without one
            (pass ``"cpu"`` to run on the CPU).
        directory: Service home — per-world checkpoint streams live in
            ``<directory>/worlds``, the tenant registry at
            ``<directory>/tenants.json``.  A directory with a registry
            is RECOVERED: every registered tenant is re-adopted from
            its stream before the service accepts requests.
        host/port: HTTP bind address (``port=0`` picks a free port;
            read it back from ``.port`` after :meth:`serve_http`).
        block: Fleet group slot count (see
            :class:`~magicsoup_tpu_torch.fleet.FleetScheduler`).
        fusion: Cross-rung dispatch fusion mode passed through to the
            scheduler (``"rung"`` | ``"fleet"`` | ``"auto"``): under
            ``"fleet"``/``"auto"`` heterogeneous tenants share ONE
            dispatch (one grouped integrator launch per simulated step)
            and ONE physical fetch per megastep, and the
            accounting ledger splits the fused fetch bytes exactly.
        policy: Warden policy for tenant health trips.
        keep: Rolling retention per tenant checkpoint stream.
        compile_budget: Initial admission compile allowance
            (``None`` = unlimited; reconfigurable via
            ``POST /admission``).
        queue_limit: Max parked creates (``"queue": true`` specs).
        command_timeout: Seconds a handler thread waits for the loop
            to execute its command before giving up with a 504.
    """

    def __init__(
        self,
        directory,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        block: int = 4,
        fusion: str = "rung",
        policy: str = "warn",
        keep: int = 3,
        compile_budget: int | None = None,
        queue_limit: int = 16,
        command_timeout: float = 600.0,
        idle_wait: float = 0.05,
        device=None,
    ):
        from magicsoup_tpu_torch.fleet import FleetScheduler, FleetWarden
        from magicsoup_tpu_torch.guard.errors import GuardConfigError
        from magicsoup_tpu_torch.util import resolve_device

        if policy not in ("warn", "quarantine"):
            # 'heal' rolls back on the warden's SCHEDULER-step cadence,
            # which the serve layer never runs (tenant streams are
            # written on the per-tenant checkpoint_cadence instead) —
            # passing it through would just crash in FleetWarden with a
            # cadence error that names no serve-level remedy
            raise GuardConfigError(
                "serve supports warden policy 'warn' or 'quarantine'; "
                "for rollback, checkpoint tenants on a cadence "
                "(spec checkpoint_cadence) and roll back explicitly "
                "via POST /tenants/<id>/restore",
                variable="policy",
                value=str(policy),
            )
        self.device = resolve_device(device, "FleetService")
        self.dir = Path(directory)
        (self.dir / "worlds").mkdir(parents=True, exist_ok=True)
        self.scheduler = FleetScheduler(block=block, grow="pad", fusion=fusion)
        self.warden = FleetWarden(
            self.scheduler,
            policy=policy,
            checkpoint_dir=self.dir / "worlds",
            keep=keep,
        )
        self.admission = AdmissionController(compile_budget=compile_budget)
        self.ledger = AccountingLedger()
        self.keep = int(keep)
        self.queue_limit = int(queue_limit)
        self.command_timeout = float(command_timeout)
        self.idle_wait = float(idle_wait)
        self.host = host
        self.port = int(port)

        self._tenants: dict[str, _Tenant] = {}
        self._pending: dict[str, dict] = {}  # queued creates, in order
        self._lost: dict[str, dict] = {}  # registered but unrecoverable
        self._seq = 0
        #: spec signature -> rung key, and the rung keys that have
        #: completed a step in this process (= compiled programs exist)
        self._spec_rungs: dict[str, tuple] = {}
        self._warm_rungs: set[tuple] = set()
        self._last_stepped: list[str] = []
        from magicsoup_tpu_torch.telemetry import fetch_stats
        from magicsoup_tpu_torch.telemetry import metrics as _pulse

        self._fetch_seen = int(fetch_stats()["fetch_bytes"])
        self._fetch_carry = 0
        # device-time attribution: the same delta-rebase
        # discipline as fetch_bytes — the census is process-global, so
        # only deltas observed during THIS service's windows are billed
        self._device_seen = int(
            _pulse.device_time_stats()["device_time_us"]
        )
        self._device_carry = 0
        self._metrics = _build_metrics(_pulse.MetricsRegistry())
        self._degraded_seen: set[str] = set()
        self._world_states_seen: set[str] = set()
        # pending commands by identity -> enqueue time (monotonic);
        # handler threads insert before put, the loop removes at done —
        # the read-time source of oldest-pending-command age
        self._inflight: dict[int, float] = {}

        self._commands: queue.Queue[_Command] = queue.Queue(maxsize=64)
        # queue backpressure: consecutive rejections widen the
        # Retry-After hint along the shared deterministic ladder
        self._edge_lock = threading.Lock()
        self._queue_full_streak = 0
        self._retry_backoff = BackoffPolicy(base=1.0, factor=2.0, max_delay=8.0)
        self._registry_degraded = False
        self._save_degraded: set[str] = set()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._stopped = threading.Event()
        self._health_lock = threading.Lock()
        self._health: dict = {"status": "starting"}
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._loop_thread: threading.Thread | None = None

        self._recover()
        self._publish_health()

    # ------------------------------------------------------------ #
    # lifecycle                                                    #
    # ------------------------------------------------------------ #

    def serve_http(self) -> int:
        """Bind the HTTP front-end (idempotent); returns the port."""
        if self._httpd is None:
            self._httpd = ThreadingHTTPServer(
                (self.host, self.port), api.make_handler(self)
            )
            self._httpd.daemon_threads = True
            self.port = self._httpd.server_address[1]
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="serve-http",
                daemon=True,
            )
            self._http_thread.start()
        return self.port

    def run(self) -> None:
        """The scheduler loop (blocking).  On the main thread, SIGTERM/
        SIGINT latch a graceful stop: drain, checkpoint every tenant,
        write the registry, exit cleanly."""
        from magicsoup_tpu_torch.guard.signals import GracefulShutdown

        # sanctioned handoff: construction published the first health
        # snapshot from the caller's thread; from here on the loop
        # thread owns every fleet mutation
        ownership.bind(self, "scheduler-loop")
        self.serve_http()
        try:
            with GracefulShutdown() as stop:
                while not (stop or self._stop.is_set()):
                    self._tick()
        finally:
            self._shutdown()

    def start(self) -> "FleetService":
        """Run the loop on a background thread (in-process tests); the
        HTTP port is bound synchronously before this returns."""
        self.serve_http()
        self._loop_thread = threading.Thread(
            target=self.run, name="serve-loop", daemon=True
        )
        self._loop_thread.start()
        return self

    def stop(self, timeout: float = 120.0) -> None:
        """Request a graceful stop and wait for the loop epilogue
        (drain + final checkpoints + registry) to finish."""
        self._stop.set()
        self._wake.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=timeout)
        else:
            self._stopped.wait(timeout=timeout)

    @owned_by("scheduler-loop")
    def _shutdown(self) -> None:
        self.scheduler.drain()
        for t in sorted(self._tenants.values(), key=lambda t: t.label):
            if t.lane is not None:
                try:
                    self._checkpoint_tenant(t)
                except OSError as exc:
                    # one tenant's dead disk must not block the other
                    # tenants' final checkpoints or the registry write
                    self._cadence_save_failed(t, exc)
        self._settle_fetch()
        self._settle_device()
        self._write_registry()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._fail_queued_commands()
        with self._health_lock:
            self._health = dict(self._health, status="stopped")
        self._stopped.set()

    def _fail_queued_commands(self) -> None:
        while True:
            try:
                cmd = self._commands.get_nowait()
            except queue.Empty:
                break
            cmd.error = api.ServeError(503, "service stopped")
            with self._edge_lock:
                self._inflight.pop(id(cmd), None)
            cmd.done.set()

    # ------------------------------------------------------------ #
    # request edge (handler threads)                               #
    # ------------------------------------------------------------ #

    def submit(self, name: str, payload: dict) -> dict:
        """Enqueue one command for the loop and wait for its result —
        the ONLY path by which handler threads reach fleet state."""
        if self._stop.is_set() or self._stopped.is_set():
            raise api.ServeError(503, "service is stopping")
        cmd = _Command(name, dict(payload or {}))
        cmd.t_enqueue = time.monotonic()
        try:
            fault = _chaos.site("serve.queue")
            if fault is not None:
                if fault.kind == "slow":
                    # a slow consumer: hold the handler thread, then
                    # enqueue normally — clients see latency, not errors
                    time.sleep(float(fault.arg or 0.0))
                else:  # "full"
                    raise queue.Full
            with self._edge_lock:
                self._inflight[id(cmd)] = cmd.t_enqueue
            self._commands.put_nowait(cmd)
        except queue.Full:
            # graceful backpressure: fail FAST with a typed 503 and a
            # Retry-After hint (previously this blocked 2s and then
            # 503'd with no hint — under sustained pressure handler
            # threads piled up toward the 504 timeout instead)
            with self._edge_lock:
                self._inflight.pop(id(cmd), None)
                self._queue_full_streak += 1
                hint = self._retry_backoff.delay(
                    min(self._queue_full_streak, 8)
                )
            _chaos.note_counter("serve_queue_full")
            _chaos.note_degraded(
                "serve.queue", f"command queue full rejecting {name!r}"
            )
            raise api.ServeError(
                503,
                f"command queue is full; retry {name!r} after "
                f"{hint:g}s",
                retry_after=hint,
            )
        with self._edge_lock:
            if self._queue_full_streak:
                self._queue_full_streak = 0
                _chaos.clear_degraded("serve.queue")
        self._wake.set()
        if not cmd.done.wait(timeout=self.command_timeout):
            raise api.ServeError(
                504,
                f"scheduler loop did not finish {name!r} within "
                f"{self.command_timeout:.0f}s",
            )
        if cmd.error is not None:
            raise cmd.error
        return cmd.result

    def _edge_stats(self) -> tuple[int, float]:
        """Read-time command-queue depth and oldest-pending-command age
        (seconds; 0 when nothing is pending).  Computed from the edge's
        own bookkeeping, NOT the published snapshot — a wedged loop
        stops publishing, so these must stay live for /healthz and
        /metrics to show the wedge before the 504 does."""
        now = time.monotonic()
        with self._edge_lock:
            oldest = min(self._inflight.values(), default=None)
        age = 0.0 if oldest is None else max(0.0, now - oldest)
        return self._commands.qsize(), age

    def health(self) -> dict:
        """The loop's last published snapshot (never blocks on work),
        plus the live command-queue depth and oldest-pending age."""
        with self._health_lock:
            snap = dict(self._health)
        depth, age = self._edge_stats()
        snap["queue_depth"] = depth
        snap["oldest_command_age_s"] = round(age, 3)
        return snap

    def metrics_text(self) -> str:
        """Render the Prometheus exposition (GET /metrics).  Handler-
        thread safe by the /healthz rule: everything here reads the loop's
        published registry state, process-global counters, or the edge's
        own locks, never the command queue.  Serve with
        :data:`telemetry.metrics.CONTENT_TYPE`.  The integrator family's
        ``backend`` labels are the port's backend names
        (:mod:`magicsoup_tpu_torch.ops.backends`)."""
        from magicsoup_tpu_torch.telemetry import runtime_counters

        reg = self._metrics
        counters = runtime_counters()
        reg.set(
            "magicsoup_device_ms_total",
            counters.get("device_time_us", 0) / 1000.0,
        )
        reg.set(
            "magicsoup_device_dispatches_total",
            counters.get("device_dispatches", 0),
        )
        for key in sorted(counters):
            if key in ("device_time_us", "device_dispatches"):
                continue
            if key.startswith("integrator_dispatches_"):
                # per-backend integrator census rides its own labeled
                # family instead of the generic counter-name bag
                reg.set(
                    "magicsoup_integrator_dispatches_total",
                    counters[key],
                    backend=key[len("integrator_dispatches_"):],
                )
                continue
            if key in _RUNTIME_GAUGE_KEYS:
                reg.set("magicsoup_runtime_gauge", counters[key], counter=key)
            else:
                reg.set("magicsoup_runtime_total", counters[key], counter=key)
        # degraded subsystems: every subsystem ever seen keeps a series
        # (0 after recovery), so scrapes see the recovery edge instead
        # of a vanishing series
        degraded = _chaos.degraded_states()
        self._degraded_seen.update(degraded)
        for subsystem in sorted(self._degraded_seen):
            state = degraded.get(subsystem)
            reg.set(
                "magicsoup_degraded",
                0 if state is None else int(state["count"]),
                subsystem=subsystem,
            )
        depth, age = self._edge_stats()
        reg.set("magicsoup_command_queue_depth", depth)
        reg.set("magicsoup_oldest_command_age_seconds", round(age, 3))
        reg.inc("magicsoup_scrapes_total")
        return reg.render()

    # ------------------------------------------------------------ #
    # the scheduler loop (single writer)                           #
    # ------------------------------------------------------------ #

    @owned_by("scheduler-loop")
    def _tick(self) -> None:
        # tick duration routes through the metrics registry (the
        # scheduler-loop instrumentation /metrics serves); idle ticks
        # count too — a tick that only waited is still loop liveness
        t0 = time.monotonic()
        try:
            self._tick_body()
        finally:
            self._metrics.observe(
                "magicsoup_tick_seconds", time.monotonic() - t0
            )

    def _tick_body(self) -> None:
        self._drain_commands()
        self._admit_pending()
        self._reconcile()
        runnable = self._runnable()
        if not runnable:
            if self.warden.pending_policy():
                # the policy normally runs inside scheduler.step(), but
                # nothing is stepping — a sole tripped tenant must still
                # be evicted to its terminal 'parked' state instead of
                # idling as 'tripped' forever
                self.warden.before_step()
            self._publish_health()
            self._wake.wait(timeout=self.idle_wait)
            self._wake.clear()
            return
        c0 = _runtime.compile_count()
        self.scheduler.step()
        self.admission.charge(_runtime.compile_count() - c0)
        self._warm_rungs.update(self.scheduler._groups)
        stepped = []
        for t in runnable:
            # map the spec signature to the rung the lane actually
            # occupies NOW (a lane's first dispatch can still grow its
            # capacity, so the admit-time key is not the steady one)
            if t.lane._fleet_slot is not None:
                self._spec_rungs[t.sig] = t.lane._fleet_slot[0].key
            t.budget -= 1
            t.megasteps += 1
            self.ledger.charge_megastep(t.tenant, t.lane.megastep)
            self.ledger.sync_trips(
                t.tenant,
                t.lane.stats["sentinel_trips"],
                t.lane.stats["invariant_trips"],
            )
            stepped.append(t.tenant)
        self._last_stepped = stepped
        self._settle_fetch()
        self._settle_device()
        for t in runnable:
            if t.cadence and t.megasteps % t.cadence == 0:
                try:
                    self._checkpoint_tenant(t)
                except OSError as exc:
                    self._cadence_save_failed(t, exc)
                else:
                    self._cadence_save_recovered(t)
        self._publish_health()

    def _cadence_save_failed(self, t: _Tenant, exc: OSError) -> None:
        """A cadence checkpoint failed: the serving loop must keep
        serving.  The skip is counted (chaos registry + stream
        counters, both visible via /healthz and the tenant's stream
        ``failure_counters()``) and retried at the next cadence; an
        explicit ``POST /tenants/<id>/checkpoint`` still raises to its
        client."""
        subsystem = f"serve.checkpoint.{t.tenant}"
        _chaos.note_counter("serve_save_skips")
        _chaos.note_degraded(subsystem, f"{type(exc).__name__}: {exc}")
        if t.tenant not in self._save_degraded:
            self._save_degraded.add(t.tenant)
            warnings.warn(
                f"cadence checkpoint for tenant {t.tenant!r} failed "
                f"({exc}); skipped and counted — retrying next cadence"
            )

    def _cadence_save_recovered(self, t: _Tenant) -> None:
        if t.tenant in self._save_degraded:
            self._save_degraded.discard(t.tenant)
            _chaos.clear_degraded(f"serve.checkpoint.{t.tenant}")

    def _runnable(self) -> list[_Tenant]:
        """Tenants that will advance this tick: budget left and active
        in the warden (suspended/quarantined worlds do not step)."""
        out = []
        for t in self._tenants.values():
            if t.lane is None or t.budget <= 0:
                continue
            if self.warden.status_of(t.label).status == "active":
                out.append(t)
        return out

    def _reconcile(self) -> None:
        """Suspend exhausted tenants, resume re-budgeted ones — the
        retire/readmit round trip keeps the SAME lane object, so budget
        pauses never perturb the trajectory."""
        for t in self._tenants.values():
            if t.lane is None:
                continue
            status = self.warden.status_of(t.label).status
            if t.budget <= 0 and status == "active":
                self.warden.suspend(t.lane)
            elif t.budget > 0 and status == "suspended":
                self.warden.resume(t.lane)

    def _drain_commands(self) -> None:
        while True:
            try:
                cmd = self._commands.get_nowait()
            except queue.Empty:
                break
            try:
                cmd.result = self._execute(cmd.name, cmd.payload)
            # graftlint: disable=GL013 delivered to the requesting client; the loop must survive
            except Exception as exc:  # delivered to the requesting client; the loop must survive
                cmd.error = exc
            with self._edge_lock:
                self._inflight.pop(id(cmd), None)
            if cmd.t_enqueue:
                self._metrics.observe(
                    "magicsoup_command_latency_seconds",
                    max(0.0, time.monotonic() - cmd.t_enqueue),
                    command=cmd.name,
                )
            cmd.done.set()

    def _admit_pending(self) -> None:
        """Re-assess parked creates: a queued spec admits the moment
        its rung warms (or budget is reconfigured)."""
        for tid in list(self._pending):
            spec = self._pending[tid]
            key = self._spec_rungs.get(api.spec_signature(spec))
            warm = key is not None and key in self._warm_rungs
            if self.admission.assess(warm=warm):
                del self._pending[tid]
                self._admit(tid, spec)

    def _settle_fetch(self) -> None:
        """Distribute newly observed fetch bytes over the tenants that
        stepped most recently (carried until someone has stepped)."""
        from magicsoup_tpu_torch.telemetry import fetch_stats

        total = int(fetch_stats()["fetch_bytes"])
        self._fetch_carry += max(0, total - self._fetch_seen)
        self._fetch_seen = total
        if self._fetch_carry and self._last_stepped:
            self.ledger.charge_fetch(self._last_stepped, self._fetch_carry)
            self._fetch_carry = 0

    def _settle_device(self) -> None:
        """Distribute newly measured device time (µs) over the tenants
        that stepped most recently — the fetch_bytes delta-rebase
        discipline, so per-tenant ``device_us`` sums exactly to the
        process census delta observed across this service's windows."""
        from magicsoup_tpu_torch.telemetry import metrics as _pulse

        total = int(_pulse.device_time_stats()["device_time_us"])
        self._device_carry += max(0, total - self._device_seen)
        self._device_seen = total
        if self._device_carry and self._last_stepped:
            self.ledger.charge_device_time(
                self._last_stepped, self._device_carry
            )
            self._device_carry = 0

    @owned_by("scheduler-loop")
    def _publish_health(self) -> None:
        statuses = {}
        for t in self._tenants.values():
            if t.lane is not None:
                statuses[t.tenant] = self.warden.status_of(t.label).status
        snap = {
            "status": "stopping" if self._stop.is_set() else "serving",
            "tenants": len(self._tenants),
            "queued": len(self._pending),
            "lost": sorted(self._lost),
            "megasteps": sum(t.megasteps for t in self._tenants.values()),
            "backlog": sum(t.budget for t in self._tenants.values()),
            "worlds": statuses,
            # per-subsystem graceful-degradation states (telemetry
            # sinks, checkpoint streams, the registry, the command
            # queue) — empty when everything is healthy
            "degraded": _chaos.degraded_states(),
        }
        with self._health_lock:
            self._health = snap
        self._publish_metrics(snap)

    @owned_by("scheduler-loop")
    def _publish_metrics(self, snap: dict) -> None:
        """Feed the loop-owned /metrics families (ledger counters,
        warden-state world counts, service gauges) from the state the
        loop just published.  Handler threads only ever ADD read-time
        series on top (queue depth, runtime counters) — the single
        writer of fleet-derived series is the loop, and the registry's
        lock makes the concurrent render safe."""
        reg = self._metrics
        reg.set("magicsoup_tenants", snap["tenants"])
        reg.set("magicsoup_queued_tenants", snap["queued"])
        reg.set("magicsoup_lost_tenants", len(snap["lost"]))
        reg.set("magicsoup_backlog_megasteps", snap["backlog"])
        reg.set("magicsoup_megasteps_total", snap["megasteps"])
        states: dict[str, int] = {}
        for status in snap["worlds"].values():
            states[status] = states.get(status, 0) + 1
        self._world_states_seen.update(states)
        for state in sorted(self._world_states_seen):
            reg.set("magicsoup_worlds", states.get(state, 0), state=state)
        for row in self.ledger.rows():
            for name, field_, _ in _TENANT_FAMILIES:
                value = row[field_]
                if field_ == "device_us":
                    value = value / 1000.0
                reg.set(name, value, tenant=row["tenant"])

    # ------------------------------------------------------------ #
    # commands                                                     #
    # ------------------------------------------------------------ #

    @owned_by("scheduler-loop")
    def _execute(self, name: str, payload: dict) -> dict:
        handler = getattr(self, f"_cmd_{name}", None)
        if handler is None:
            raise api.ServeError(404, f"unknown command {name!r}")
        return handler(payload)

    def _get_tenant(self, payload: dict) -> _Tenant:
        tid = payload.get("tenant")
        t = self._tenants.get(tid)
        if t is None:
            raise api.ServeError(404, f"no tenant {tid!r}")
        return t

    def _new_tid(self) -> str:
        while True:
            self._seq += 1
            tid = f"tenant-{self._seq:03d}"
            if (
                tid not in self._tenants
                and tid not in self._pending
                and tid not in self._lost
            ):
                return tid

    def _cmd_create(self, payload: dict) -> dict:
        spec = api.validate_spec(payload)
        tid = spec.get("tenant") or self._new_tid()
        spec["tenant"] = tid
        if tid in self._tenants or tid in self._pending:
            raise api.ServeError(409, f"tenant {tid!r} already exists")
        if tid in self._lost:
            raise api.ServeError(
                409,
                f"tenant {tid!r} is lost (registered but unrecoverable: "
                f"{self._lost[tid].get('error')}) — its id and stream "
                "stay reserved; restart the service once the stream is "
                "readable again",
            )
        key = self._spec_rungs.get(api.spec_signature(spec))
        warm = key is not None and key in self._warm_rungs
        if not self.admission.assess(warm=warm):
            if spec["queue"]:
                if len(self._pending) >= self.queue_limit:
                    self.admission.rejected += 1
                    raise api.ServeError(429, "admission queue is full")
                self._pending[tid] = spec
                return {"tenant": tid, "status": "queued"}
            self.admission.rejected += 1
            raise api.ServeError(
                429,
                "admission rejected: compile budget exhausted and the "
                "spec's capacity rung is cold (retry with queue=true, "
                "or raise the budget via POST /admission)",
            )
        t = self._admit(tid, spec)
        return self._observe(t)

    def _admit(self, tid: str, spec: dict, *, label: int | None = None) -> _Tenant:
        c0 = _runtime.compile_count()
        world = api.build_world(spec, self.device)
        kwargs = api.stepper_kwargs(spec)
        if label is None:
            lane = self.scheduler.admit(world, **kwargs)
            label = self.warden.label_of(lane)
        else:
            lane = self.warden.adopt(world, label=label, **kwargs)
        self.admission.charge(_runtime.compile_count() - c0)
        t = _Tenant(
            tenant=tid,
            label=label,
            spec=spec,
            sig=api.spec_signature(spec),
            lane=lane,
            cadence=spec["checkpoint_cadence"],
        )
        self._tenants[tid] = t
        self.ledger.open(tid, label)
        self.ledger.rebase_trips(
            tid,
            lane.stats["sentinel_trips"],
            lane.stats["invariant_trips"],
        )
        self._write_registry()
        return t

    def _cmd_list(self, payload: dict) -> dict:
        rows = [self._observe(t) for t in self._tenants.values()]
        rows += [
            {"tenant": tid, "status": "queued"} for tid in self._pending
        ]
        rows += [{"tenant": tid, "status": "lost"} for tid in self._lost]
        return {"tenants": rows}

    def _cmd_observe(self, payload: dict) -> dict:
        return self._observe(self._get_tenant(payload))

    def _observe(self, t: _Tenant) -> dict:
        """Telemetry/health summary from host-side state only — the
        zero-sync lanes the replay already decoded (no extra D2H)."""
        acct = self.ledger.get(t.tenant)
        out = {
            "tenant": t.tenant,
            "world": t.label,
            "budget": t.budget,
            "megasteps": t.megasteps,
            "steps": acct.steps,
            "accounting": acct.row(),
        }
        if t.lane is not None:
            ws = self.warden.status_of(t.label)
            stats = t.lane.stats
            out["status"] = ws.status
            out["warden"] = {
                "status": ws.status,
                "trips": ws.trips,
                "restarts": ws.restarts,
                "last_flags": ws.last_flags,
                "reason": ws.reason,
            }
            out["n_cells"] = t.lane.world.n_cells
            out["stats"] = {
                k: stats[k]
                for k in (
                    "steps",
                    "replayed",
                    "kills",
                    "divisions",
                    "spawned",
                    "sentinel_trips",
                    "invariant_trips",
                )
            }
        else:
            out["status"] = "detached"
        return out

    def _cmd_step(self, payload: dict) -> dict:
        t = self._get_tenant(payload)
        if t.lane is None:
            raise api.ServeError(409, f"tenant {t.tenant!r} is detached")
        ws = self.warden.status_of(t.label)
        if ws.status == "parked":
            # terminal: budget would accrue forever with no progress
            raise api.ServeError(
                409,
                f"tenant {t.tenant!r} is parked"
                + (f" ({ws.reason})" if ws.reason else "")
                + " — roll it back via POST /tenants/<id>/restore",
            )
        megasteps = int(payload.get("megasteps", 1))
        if megasteps < 1:
            raise api.ServeError(400, "megasteps must be >= 1")
        t.budget += megasteps
        return {
            "tenant": t.tenant,
            "budget": t.budget,
            "megasteps": t.megasteps,
        }

    def _cmd_checkpoint(self, payload: dict) -> dict:
        t = self._get_tenant(payload)
        if t.lane is None:
            raise api.ServeError(409, f"tenant {t.tenant!r} is detached")
        path = self._checkpoint_tenant(t)
        return {
            "tenant": t.tenant,
            "megasteps": t.megasteps,
            "path": str(path),
        }

    def _checkpoint_tenant(self, t: _Tenant):
        """One rolling save to the tenant's stream.  ``step`` is the
        TENANT megastep count, so the stream ordering (and the flush
        the save implies) is keyed to the tenant's own schedule — a
        restart resumes at the same point regardless of co-tenants."""
        from magicsoup_tpu_torch.guard.resume import save_run

        return save_run(
            self.warden.stream_of(t.label),
            t.lane.world,
            t.lane,
            step=t.megasteps,
            meta={
                "tenant": t.tenant,
                "world": t.label,
                "megasteps": t.megasteps,
                "budget": t.budget,
                "accounting": self.ledger.snapshot_one(t.tenant),
            },
        )

    def _cmd_restore(self, payload: dict) -> dict:
        """Roll a tenant back to its newest stream checkpoint (same
        restore path a crashed service takes on restart)."""
        from magicsoup_tpu_torch.guard.resume import restore_run, restore_stepper

        t = self._get_tenant(payload)
        stream = self.warden.stream_of(t.label)
        if stream is None or not stream.checkpoints():
            raise api.ServeError(
                409, f"tenant {t.tenant!r} has no checkpoints"
            )
        if (
            t.lane is not None
            and self.warden.status_of(t.label).status == "active"
        ):
            self.warden.suspend(t.lane)
        c0 = _runtime.compile_count()
        world, aux, meta = restore_run(stream, device=self.device)
        lane = self.warden.adopt(
            world, label=t.label, **api.stepper_kwargs(t.spec)
        )
        restore_stepper(lane, aux)
        self.admission.charge(_runtime.compile_count() - c0)
        t.lane = lane
        t.budget = int(meta.get("budget", 0))
        t.megasteps = int(meta.get("megasteps", 0))
        self.ledger.restore_one(t.tenant, t.label, meta.get("accounting", {}))
        self.ledger.rebase_trips(
            t.tenant,
            lane.stats["sentinel_trips"],
            lane.stats["invariant_trips"],
        )
        return self._observe(t)

    def _cmd_digest(self, payload: dict) -> dict:
        t = self._get_tenant(payload)
        if t.lane is None:
            raise api.ServeError(409, f"tenant {t.tenant!r} is detached")
        return {
            "tenant": t.tenant,
            "megasteps": t.megasteps,
            "digest": tenant_digest(t.lane),
        }

    def _cmd_detach(self, payload: dict) -> dict:
        """Final checkpoint, then release the tenant (its stream files
        stay on disk — re-creatable by a fresh service, not by this
        one; detach is the tenant's exit)."""
        t = self._get_tenant(payload)
        out = {"tenant": t.tenant, "status": "detached"}
        if t.lane is not None:
            if self.warden.status_of(t.label).status == "active":
                self.warden.suspend(t.lane)
            path = self._checkpoint_tenant(t)
            out["checkpoint"] = str(path)
        out["accounting"] = self.ledger.get(t.tenant).row()
        t.lane = None
        del self._tenants[t.tenant]
        self._write_registry()
        return out

    def _cmd_accounting(self, payload: dict) -> dict:
        """The full ledger.  Drains first so every dispatched megastep
        has replayed and its fetch traffic is attributable — the rows
        are exact at this boundary (steps sum to steps served, fetch
        bytes sum to the process's physical fetch total)."""
        self.scheduler.drain()
        self._settle_fetch()
        # drain implies every fetch-ready callback has fired (they run
        # before any result() returns), so the device census is settled
        # and the rows' device_us sums exactly to total_device_us
        self._settle_device()
        return {
            "rows": self.ledger.rows(),
            "total_steps": self.ledger.total_steps(),
            "total_fetch_bytes": self.ledger.total_fetch_bytes(),
            "total_device_us": self.ledger.total_device_us(),
        }

    def _cmd_counters(self, payload: dict) -> dict:
        from magicsoup_tpu_torch.telemetry import runtime_counters

        return {
            "counters": runtime_counters(),
            "admission": self.admission.snapshot(),
        }

    def _cmd_admission(self, payload: dict) -> dict:
        if "compile_budget" in payload:
            budget = payload["compile_budget"]
            self.admission.configure(
                None if budget is None else int(budget)
            )
        return self.admission.snapshot()

    def _cmd_shutdown(self, payload: dict) -> dict:
        self._stop.set()
        self._wake.set()
        return {"status": "stopping"}

    # ------------------------------------------------------------ #
    # registry + recovery                                          #
    # ------------------------------------------------------------ #

    @property
    def _registry_path(self) -> Path:
        return self.dir / "tenants.json"

    def _write_registry(self) -> None:
        """Atomic rewrite of the static tenant registry.  Only facts
        needed to FIND a tenant's stream go here (label, spec); all
        dynamic state rides in checkpoint meta, so a torn write window
        cannot lose progress — only a just-created tenant.  Lost
        tenants (registered but unrecoverable at the last restart) are
        persisted too: their ids and stream labels stay reserved, and a
        later restart retries them — a transient read failure must not
        orphan a tenant's surviving checkpoints."""
        doc = {
            "format": REGISTRY_FORMAT,
            "tenants": {
                t.tenant: {"label": t.label, "spec": t.spec}
                for t in self._tenants.values()
            },
            "lost": dict(self._lost),
        }
        try:
            atomic_write_text(
                self._registry_path,
                json.dumps(doc, indent=1),
                chaos_site="registry.write",
            )
        except OSError as exc:
            # degrade, don't die: the registry only matters at the NEXT
            # restart, and every later registry-changing command (and
            # the shutdown epilogue) rewrites the whole document — the
            # failure is counted and visible in /healthz until a write
            # lands
            _chaos.note_counter("registry_write_failures")
            _chaos.note_degraded(
                "serve.registry", f"{type(exc).__name__}: {exc}"
            )
            if not self._registry_degraded:
                self._registry_degraded = True
                warnings.warn(
                    f"tenant registry write to {self._registry_path} "
                    f"failed ({exc}); counted and retried at the next "
                    "registry update"
                )
            return
        if self._registry_degraded:
            self._registry_degraded = False
            _chaos.clear_degraded("serve.registry")

    def _recover(self) -> None:
        """Re-adopt every registered tenant from its rolling stream
        (label order, so stream prefixes and the label allocator line
        up with the previous life).  A registered tenant with no
        loadable checkpoint is reported as ``lost``, not guessed at —
        but its label is still RESERVED in the warden's allocator (a
        fresh admission reusing the prefix would rotate the lost
        tenant's surviving checkpoints out of the rolling stream), and
        tenants the previous life already held as lost are retried:
        the read failure may have been transient."""
        from magicsoup_tpu_torch.guard.checkpoint import CheckpointManager
        from magicsoup_tpu_torch.guard.errors import CheckpointError
        from magicsoup_tpu_torch.guard.resume import restore_run, restore_stepper

        if not self._registry_path.exists():
            return
        doc = json.loads(self._registry_path.read_text())
        if doc.get("format") != REGISTRY_FORMAT:
            raise api.ServeError(
                500, f"unknown registry format {doc.get('format')!r}"
            )
        candidates = dict(doc.get("tenants", {}))
        for tid, info in doc.get("lost", {}).items():
            candidates.setdefault(tid, info)
        entries = sorted(
            candidates.items(), key=lambda kv: kv[1]["label"]
        )
        for tid, info in entries:
            label = int(info["label"])
            spec = info["spec"]
            # reserve FIRST, unconditionally: whatever the restore
            # outcome, this label's stream prefix is taken
            self.warden.reserve_label(label)
            stream = CheckpointManager(
                self.dir / "worlds",
                keep=self.keep,
                prefix=f"world-{label:03d}",
            )
            try:
                if not stream.checkpoints():
                    raise CheckpointError(
                        "no checkpoints in stream", check="missing"
                    )
                c0 = _runtime.compile_count()
                world, aux, meta = restore_run(stream, device=self.device)
                lane = self.warden.adopt(
                    world, label=label, **api.stepper_kwargs(spec)
                )
                restore_stepper(lane, aux)
                self.admission.charge(_runtime.compile_count() - c0)
            except CheckpointError as exc:
                self._lost[tid] = {
                    "label": label,
                    "spec": spec,
                    "error": str(exc),
                }
                continue
            t = _Tenant(
                tenant=tid,
                label=label,
                spec=spec,
                sig=api.spec_signature(spec),
                lane=lane,
                cadence=int(spec.get("checkpoint_cadence", 0)),
                budget=int(meta.get("budget", 0)),
                megasteps=int(meta.get("megasteps", 0)),
            )
            self._tenants[tid] = t
            self.ledger.restore_one(tid, label, meta.get("accounting", {}))
            self.ledger.rebase_trips(
                tid,
                lane.stats["sentinel_trips"],
                lane.stats["invariant_trips"],
            )
        if entries:
            # normalize on disk: entries may have moved between the
            # 'tenants' and 'lost' sections during this recovery
            self._write_registry()
