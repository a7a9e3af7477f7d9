"""
The port's serving plane (``magicsoup_tpu_torch.serve``) against the JAX
package's (``magicsoup_tpu.serve``) on the same schedules, as
``tests/fast/test_serve.py``, the serve-level tests of
``tests/fast/test_metrics.py`` and ``tests/fast/test_chaos.py`` hold the
JAX one.  Both services run in deterministic mode on 16x16 maps with 8
cells, driven by manual ``_tick()`` calls (single-threaded), the port's
with ``device="cpu"``:

- the wire format: spec normalization, the status and message of every
  bad spec, ``spec_signature`` strings and ``_route`` results equal JAX's;
- the lifecycle: each tenant world's ``state_digest`` equals JAX's at
  every tenant megastep boundary, the observed statuses and stats and the
  accounting rows' steps, megasteps and dispatches equal JAX's, fetch
  bytes and device time are conserved exactly, ``tenant_digest`` round
  trips through checkpoint and restore;
- a budget pause is invisible to the trajectory and equal to JAX's; the
  admission decisions equal JAX's, with no compile charged for a warm
  admission and its step (the fused fleet's tests are in
  ``test_torch_serve_fused.py``: the JAX side's fused compiles take a
  minute, so they run on a worker of their own);
- HTTP round trip and in-process crash recovery, the heal refusal, a
  quarantined sole tenant parks while idle, a lost tenant reserves its
  label; the metric families (names, HELP, TYPE) equal JAX's, the
  integrator family carries the port's backend names (``torch-det``, not
  ``pallas``/``xla-*``), scrapes are monotone, chaos degraded states show,
  a failed cadence save is skipped and counted, ``/healthz``
  reports the queue; a full queue is a typed 503 with ``Retry-After``;
- without a card ``FleetService()`` and the CLI raise naming the CPU;
  ``import magicsoup_tpu_torch.serve`` loads neither JAX nor the JAX
  package; the CLI as a subprocess (``--device cpu``): the ready line,
  SIGTERM drains to exit 0 with registry and checkpoints, SIGKILL then a
  restart gives bit-identical digests.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu.check.differential import state_digest as jdigest  # noqa: E402
from magicsoup_tpu.serve import FleetService as JService  # noqa: E402
from magicsoup_tpu.serve import ServeError as JServeError  # noqa: E402
from magicsoup_tpu.serve import api as japi  # noqa: E402
from magicsoup_tpu_torch.analysis import runtime  # noqa: E402
from magicsoup_tpu_torch.check.differential import state_digest as tdigest  # noqa: E402
from magicsoup_tpu_torch.guard import chaos  # noqa: E402
from magicsoup_tpu_torch.serve import FleetService, ServeError  # noqa: E402
from magicsoup_tpu_torch.serve import api  # noqa: E402
from magicsoup_tpu_torch.telemetry import metrics as pulse  # noqa: E402
from magicsoup_tpu_torch.telemetry import validate_rows  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# the observed fields that follow from the schedule (fetch bytes and
# device time are each package's own)
OBS_KEYS = ("tenant", "world", "budget", "megasteps", "steps", "status", "n_cells", "stats")
ROW_KEYS = ("tenant", "world", "steps", "megasteps", "dispatches", "sentinel_trips", "invariant_trips")


@pytest.fixture(autouse=True)
def _det(monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    chaos.disarm()
    yield
    chaos.disarm()


def _spec(tenant=None, *, seed=7, **over):
    spec = {
        "seed": seed,
        "map_size": 16,
        "n_cells": 8,
        "genome_size": 200,
        "chemistry": {
            "molecules": [
                {"name": "sv-a", "energy": 10000.0},
                {"name": "sv-atp", "energy": 8000.0, "half_life": 100000},
            ],
            "reactions": [[["sv-a"], ["sv-atp"]]],
        },
        "stepper": {"mol_name": "sv-atp", "megastep": 2},
    }
    if tenant is not None:
        spec["tenant"] = tenant
    spec.update(over)
    return spec


def _service(path, **kw):
    kw.setdefault("block", 2)
    kw.setdefault("idle_wait", 0.001)
    kw.setdefault("device", "cpu")
    return FleetService(path, **kw)


def _drain(svc, max_ticks=200):
    """Tick until every budget is served, plus one reconcile tick."""
    for _ in range(max_ticks):
        if not any(t.budget > 0 for t in svc._tenants.values()):
            svc._tick()
            return
        svc._tick()
    raise AssertionError("budgets did not drain")


class Pair:
    """A JAX and a port service driven through the same commands."""

    def __init__(self, tmp_path, **kw):
        jkw = dict(kw)
        jkw.setdefault("block", 2)
        jkw.setdefault("idle_wait", 0.001)
        self.j = JService(tmp_path / "jax", **jkw)
        self.t = _service(tmp_path / "port", **kw)

    def run(self, name, payload):
        """Execute on both; equal errors (status and message) are
        re-raised as the port's, results returned as a pair."""
        jerr = terr = None
        try:
            jres = self.j._execute(name, dict(payload))
        except JServeError as exc:
            jerr = exc
        try:
            tres = self.t._execute(name, dict(payload))
        except ServeError as exc:
            terr = exc
        if jerr is not None or terr is not None:
            assert jerr is not None and terr is not None, (jerr, terr)
            assert (terr.status, str(terr)) == (jerr.status, str(jerr))
            raise terr
        return jres, tres

    def observe(self, tid):
        jres, tres = self.run("observe", {"tenant": tid})
        assert {k: tres.get(k) for k in OBS_KEYS} == {k: jres.get(k) for k in OBS_KEYS}
        if "warden" in jres:
            assert tres["warden"] == jres["warden"]
        return tres

    def digests(self, tid):
        """Flush the tenant in both services (a digest request), then hold
        its world's state digest equal across the packages."""
        self.run("digest", {"tenant": tid})
        jw, tw = self.j._tenants[tid].lane.world, self.t._tenants[tid].lane.world
        assert tdigest(tw) == jdigest(jw), tid
        return tdigest(tw)

    def tick(self):
        """One tick of both; every tenant that stepped is flushed and held
        to JAX's state at this megastep boundary."""
        self.j._tick()
        self.t._tick()
        assert self.t._last_stepped == self.j._last_stepped
        for tid in self.t._last_stepped:
            self.digests(tid)

    def drain(self, max_ticks=200):
        for _ in range(max_ticks):
            busy = any(t.budget > 0 for t in self.t._tenants.values())
            self.tick()
            if not busy:
                return
        raise AssertionError("budgets did not drain")

    def accounting(self):
        jres, tres = self.run("accounting", {})
        assert validate_rows(tres["rows"]) == []
        assert [{k: r[k] for k in ROW_KEYS} for r in tres["rows"]] == [
            {k: r[k] for k in ROW_KEYS} for r in jres["rows"]
        ]
        assert tres["total_steps"] == jres["total_steps"] == sum(r["steps"] for r in tres["rows"])
        assert tres["total_fetch_bytes"] == sum(r["fetch_bytes"] for r in tres["rows"])
        assert tres["total_device_us"] == sum(r["device_us"] for r in tres["rows"])
        return tres


# --------------------------------------------------- pure wire format
def test_validate_spec_defaults_match_jax():
    spec = api.validate_spec(_spec("acme"))
    assert spec == japi.validate_spec(_spec("acme"))
    assert (spec["seed"], spec["deterministic"], spec["checkpoint_cadence"], spec["queue"]) == (
        7, True, 0, False)
    assert api.stepper_kwargs(spec) == japi.stepper_kwargs(spec)


BAD_SPECS = [
    [],
    _spec(tenant=""),
    {**_spec(), "chemistry": {"molecules": []}},
    {**_spec(), "genome_size": 10},
    {**_spec(), "map_size": 1},
    {**_spec(), "checkpoint_cadence": -1},
    {**_spec(), "chemistry": {"molecules": [{"name": "sv-a", "energy": 1.0}],
                              "reactions": [[["sv-a"], ["ghost"]]]}},
    {**_spec(), "chemistry": {"molecules": [{"name": "sv-a"}]}},
    {**_spec(), "stepper": {"mol_name": "sv-atp", "warp": 9}},
    {**_spec(), "stepper": {"mol_name": "ghost"}},
    {**_spec(), "stepper": {}},
]


@pytest.mark.parametrize("i", range(len(BAD_SPECS)))
def test_bad_specs_fail_as_in_jax(i):
    with pytest.raises(JServeError) as jerr:
        japi.validate_spec(BAD_SPECS[i])
    with pytest.raises(ServeError) as terr:
        api.validate_spec(BAD_SPECS[i])
    assert (terr.value.status, str(terr.value)) == (jerr.value.status, str(jerr.value))
    assert terr.value.status == 400


def test_spec_signature_and_routes_match_jax():
    a = api.validate_spec(_spec("alpha", seed=7, checkpoint_cadence=2))
    b = api.validate_spec(_spec("beta", seed=11, queue=True))
    c = api.validate_spec(_spec("gamma", n_cells=16))
    for s in (a, b, c):
        assert api.spec_signature(s) == japi.spec_signature(s)
    assert api.spec_signature(a) == api.spec_signature(b) != api.spec_signature(c)
    for method, path, body in [
        ("GET", "/healthz", {}), ("GET", "/metrics", {}), ("GET", "/counters", {}),
        ("GET", "/accounting", {}), ("POST", "/admission", {"compile_budget": 0}),
        ("POST", "/shutdown", {}), ("GET", "/tenants", {}), ("POST", "/tenants", {"seed": 1}),
        ("GET", "/tenants/acme", {}), ("DELETE", "/tenants/acme", {}),
        ("POST", "/tenants/acme/step", {"megasteps": 3}), ("POST", "/tenants/acme/checkpoint", {}),
        ("POST", "/tenants/acme/restore", {}), ("GET", "/tenants/acme/digest?x=1", {}),
    ]:
        assert api._route(method, path, body) == japi._route(method, path, body)
    for method, path, body in [
        ("GET", "/nope", {}), ("PUT", "/tenants", {}), ("PUT", "/tenants/acme", {}),
        ("POST", "/tenants/acme/warp", {}), ("POST", "/metrics", {}), ("GET", "/tenants", [1]),
    ]:
        with pytest.raises(JServeError) as jerr:
            japi._route(method, path, body)
        with pytest.raises(ServeError) as terr:
            api._route(method, path, body)
        assert (terr.value.status, str(terr.value)) == (jerr.value.status, str(jerr.value))


def test_conflicting_molecule_is_a_400():
    spec = _spec("acme")
    spec["chemistry"] = {"molecules": [{"name": "sv-a", "energy": 1.0}], "reactions": []}
    spec["stepper"] = {"mol_name": "sv-a"}
    api.build_chemistry(_spec()["chemistry"])
    with pytest.raises(ServeError) as err:
        api.build_chemistry(spec["chemistry"])
    assert err.value.status == 400 and "molecule conflict" in str(err.value)


# ------------------------------------------------- service lifecycle
def test_lifecycle_matches_jax(tmp_path):
    p = Pair(tmp_path)
    alpha, _ = p.run("create", _spec("alpha", seed=7))
    p.observe("alpha")
    beta, _ = p.run("create", _spec("beta", seed=11))
    assert beta["world"] != alpha["world"]
    with pytest.raises(ServeError) as err:
        p.run("create", _spec("alpha"))
    assert err.value.status == 409

    p.run("step", {"tenant": "alpha", "megasteps": 2})
    p.run("step", {"tenant": "beta", "megasteps": 1})
    p.drain()
    obs = p.observe("alpha")
    assert (obs["megasteps"], obs["steps"], obs["status"]) == (2, 4, "suspended")
    p.observe("beta")

    rows = p.accounting()["rows"]
    assert [r["tenant"] for r in rows] == ["alpha", "beta"]
    assert [r["dispatches"] for r in rows] == [2, 1]

    # checkpoint -> digest -> diverge -> restore is a rollback
    ck, tck = p.run("checkpoint", {"tenant": "alpha"})
    assert f"world-{alpha['world']:03d}" in tck["path"]
    d1 = p.t._execute("digest", {"tenant": "alpha"})["digest"]
    s1 = p.digests("alpha")
    p.run("step", {"tenant": "alpha", "megasteps": 1})
    p.drain()
    assert p.t._execute("digest", {"tenant": "alpha"})["digest"] != d1
    jres, tres = p.run("restore", {"tenant": "alpha"})
    assert tres["megasteps"] == jres["megasteps"] == 2
    assert p.t._execute("digest", {"tenant": "alpha"})["digest"] == d1
    assert p.digests("alpha") == s1
    p.run("step", {"tenant": "alpha", "megasteps": 1})
    p.drain()

    jres, tres = p.run("detach", {"tenant": "beta"})
    assert tres["accounting"]["steps"] == jres["accounting"]["steps"] == 2
    with pytest.raises(ServeError) as err:
        p.run("observe", {"tenant": "beta"})
    assert err.value.status == 404
    jres, tres = p.run("list", {})
    assert [r["tenant"] for r in tres["tenants"]] == [r["tenant"] for r in jres["tenants"]] == ["alpha"]
    p.accounting()


def test_budget_pause_is_invisible_and_matches_jax(tmp_path):
    one = _service(tmp_path / "one")
    one._execute("create", _spec("alpha", seed=13))
    one._execute("step", {"tenant": "alpha", "megasteps": 3})
    _drain(one)

    runtime.reset_counters()
    split = Pair(tmp_path / "split")
    split.run("create", _spec("alpha", seed=13))
    for _ in range(3):
        split.run("step", {"tenant": "alpha", "megasteps": 1})
        split.drain()  # budget reaches zero: suspend between grants
        assert split.observe("alpha")["status"] == "suspended"
    # each resume after a digest's flush re-attached without a rebuild
    assert runtime.snapshot()["attach_skipped"] >= 2
    assert (
        one._execute("digest", {"tenant": "alpha"})["digest"]
        == split.t._execute("digest", {"tenant": "alpha"})["digest"]
    )
    assert tdigest(one._tenants["alpha"].lane.world) == split.digests("alpha")


def test_admission_decisions_match_jax(tmp_path):
    p = Pair(tmp_path, compile_budget=0)
    with pytest.raises(ServeError) as err:
        p.run("create", _spec("alpha"))
    assert err.value.status == 429
    jres, tres = p.run("counters", {})
    assert tres["admission"]["rejected"] == jres["admission"]["rejected"] == 1

    jres, tres = p.run("create", _spec("alpha", queue=True))
    assert tres == jres == {"tenant": "alpha", "status": "queued"}
    p.tick()
    assert "alpha" not in p.t._tenants and "alpha" not in p.j._tenants
    p.run("admission", {"compile_budget": None})
    p.tick()
    assert p.observe("alpha")["status"] in ("active", "suspended")

    # warm the rung
    p.run("step", {"tenant": "alpha", "megasteps": 1})
    p.drain()

    # a warm admission admits and serves under a zero budget, charging
    # no compile
    p.run("admission", {"compile_budget": 0})
    c0 = runtime.compile_count()
    jres, tres = p.run("create", _spec("beta", seed=11))
    assert tres["status"] == jres["status"] == "active"
    p.run("step", {"tenant": "beta", "megasteps": 1})
    p.drain()
    assert runtime.compile_count() - c0 == 0
    assert p.observe("beta")["megasteps"] == 1

    # a spec of another shape is still cold: refused before building
    with pytest.raises(ServeError) as err:
        p.run("create", _spec("gamma", n_cells=16))
    assert err.value.status == 429
    jres, tres = p.run("counters", {})
    assert tres["admission"]["rejected"] == jres["admission"]["rejected"] == 2
    # the JAX package's counter names where the port has a counterpart
    for key in ("compiles", "persistent_cache_hits", "persistent_cache_misses", "phenotype_hits",
                "phenotype_misses", "restack_full", "restack_inserts", "restack_skipped",
                "attach_full", "attach_skipped", "dispatches", "fused_groups", "fetches",
                "fetch_bytes", "device_time_us", "device_dispatches"):
        assert key in tres["counters"] and key in jres["counters"], key


# ------------------------------------------------ HTTP + recovery
def _req(port, method, path, body=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _wait_megasteps(port, tid, target, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, obs = _req(port, "GET", f"/tenants/{tid}")
        assert status == 200
        if obs["megasteps"] >= target:
            return obs
        time.sleep(0.02)
    raise AssertionError(f"{tid} never reached {target} megasteps")


def test_http_roundtrip_and_crash_recovery(tmp_path):
    home = tmp_path / "srv"
    svc = _service(home, idle_wait=0.01).start()
    try:
        port = svc.port
        status, health = _req(port, "GET", "/healthz")
        assert status == 200 and health["status"] == "serving"
        status, out = _req(port, "POST", "/tenants", _spec("alpha"))
        assert status == 200 and out["status"] == "active"
        assert _req(port, "POST", "/tenants/alpha/step", {"megasteps": 2})[0] == 200
        _wait_megasteps(port, "alpha", 2)
        status, dig = _req(port, "GET", "/tenants/alpha/digest")
        assert status == 200
        status, counters = _req(port, "GET", "/counters")
        assert status == 200
        assert "compiles" in counters["counters"]
        assert "compile_budget" in counters["admission"]
        # typed errors cross the wire as JSON
        status, err = _req(port, "POST", "/tenants/ghost/step", {})
        assert status == 404 and "ghost" in err["error"]
        status, err = _req(port, "POST", "/tenants", [1, 2])
        assert status == 400
        status, out = _req(port, "POST", "/shutdown")
        assert status == 200 and out["status"] == "stopping"
    finally:
        svc.stop()
    assert (home / "tenants.json").exists()
    assert json.loads((home / "tenants.json").read_text())["format"] == (
        "magicsoup_tpu_torch.serve.registry/1")
    assert list((home / "worlds").glob("world-000-*.msck"))

    # a new service on the same directory re-adopts the tenant
    svc2 = _service(home)
    assert svc2._tenants["alpha"].megasteps == 2
    assert svc2._execute("accounting", {})["rows"][0]["steps"] == 4
    assert svc2._execute("digest", {"tenant": "alpha"})["digest"] == dig["digest"]
    svc2._execute("step", {"tenant": "alpha", "megasteps": 1})
    _drain(svc2)
    assert svc2._execute("observe", {"tenant": "alpha"})["megasteps"] == 3

    # the JAX service's directory format is refused, not misread
    doc = json.loads((home / "tenants.json").read_text())
    doc["format"] = "magicsoup_tpu.serve.registry/1"
    (home / "tenants.json").write_text(json.dumps(doc))
    with pytest.raises(ServeError) as err:
        _service(home)
    assert err.value.status == 500 and "unknown registry format" in str(err.value)


def test_heal_policy_is_rejected_up_front(tmp_path):
    from magicsoup_tpu.guard.errors import GuardConfigError as JGuardConfigError
    from magicsoup_tpu_torch.guard.errors import GuardConfigError

    with pytest.raises(JGuardConfigError) as jerr:
        JService(tmp_path / "jax", policy="heal")
    with pytest.raises(GuardConfigError) as err:
        _service(tmp_path / "srv", policy="heal")
    assert "restore" in str(err.value)
    assert str(err.value) == str(jerr.value)


def test_quarantine_sole_tenant_parks_while_idle(tmp_path):
    p = Pair(tmp_path, policy="quarantine")
    out, _ = p.run("create", _spec("alpha", checkpoint_cadence=1))
    p.run("step", {"tenant": "alpha", "megasteps": 2})
    p.tick()  # serves megastep 1; cadence 1 wrote a rollback point
    for svc in (p.j, p.t):
        rec = next(r for r in svc.warden._records if r.label == out["world"])
        rec.status = "tripped"
        rec.last_kind = "sentinel"
    p.tick()  # no runnable tenant: the idle path must still evict
    obs = p.observe("alpha")
    assert obs["status"] == "parked" and "sentinel" in obs["warden"]["reason"]
    with pytest.raises(ServeError) as err:
        p.run("step", {"tenant": "alpha", "megasteps": 1})
    assert err.value.status == 409 and "parked" in str(err.value)
    jres, tres = p.run("restore", {"tenant": "alpha"})
    assert tres["status"] == jres["status"] == "active"
    p.drain()  # the budget restored from checkpoint meta drains
    assert p.observe("alpha")["megasteps"] == 2


def test_lost_tenant_reserves_label_and_is_retried(tmp_path):
    home = tmp_path / "srv"
    svc = _service(home)
    svc._execute("create", _spec("alpha"))
    beta = svc._execute("create", _spec("beta", seed=11))
    svc._execute("step", {"tenant": "alpha", "megasteps": 1})
    svc._execute("step", {"tenant": "beta", "megasteps": 2})
    _drain(svc)
    dig = svc._execute("digest", {"tenant": "beta"})["digest"]
    svc._shutdown()

    hidden = []
    for path in sorted((home / "worlds").glob("world-001-*.msck")):
        hidden.append((path, path.with_suffix(".hidden")))
        path.rename(path.with_suffix(".hidden"))
    assert hidden

    svc2 = _service(home)
    assert "alpha" in svc2._tenants and "beta" not in svc2._tenants
    assert svc2._lost["beta"]["label"] == beta["world"] == 1
    assert {"tenant": "beta", "status": "lost"} in svc2._execute("list", {})["tenants"]
    with pytest.raises(ServeError) as err:
        svc2._execute("create", _spec("beta", seed=11))
    assert err.value.status == 409 and "lost" in str(err.value)
    assert svc2._execute("create", _spec("gamma", seed=13))["world"] == 2
    assert not list((home / "worlds").glob("world-001-*.msck"))
    svc2._shutdown()
    doc = json.loads((home / "tenants.json").read_text())
    assert doc["lost"]["beta"]["label"] == 1 and "spec" in doc["lost"]["beta"]

    for path, hid in hidden:
        hid.rename(path)
    svc3 = _service(home)
    assert not svc3._lost
    assert (svc3._tenants["beta"].label, svc3._tenants["beta"].megasteps) == (1, 2)
    assert svc3._execute("digest", {"tenant": "beta"})["digest"] == dig
    doc = json.loads((home / "tenants.json").read_text())
    assert doc["lost"] == {} and "beta" in doc["tenants"]


# ---------------------------------------------------------- metrics
def _help_and_types(text: str) -> tuple[set, dict]:
    helps = {line for line in text.splitlines() if line.startswith("# HELP ")}
    return helps, pulse.parse_exposition(text)["types"]


def test_metric_families_match_jax_and_are_stable_across_restarts(tmp_path):
    svc1 = _service(tmp_path / "a")
    helps1, types1 = _help_and_types(svc1.metrics_text())
    svc1._shutdown()
    svc2 = _service(tmp_path / "b")
    helps2, types2 = _help_and_types(svc2.metrics_text())
    svc2._shutdown()
    assert (helps1, types1) == (helps2, types2)
    jsvc = JService(tmp_path / "jax", block=2)
    jhelps, jtypes = _help_and_types(jsvc.metrics_text())
    jsvc._shutdown()
    assert helps1 == jhelps and types1 == jtypes
    for name in ("magicsoup_device_ms_total", "magicsoup_command_queue_depth",
                 "magicsoup_oldest_command_age_seconds"):
        assert name in types1
    assert types1["magicsoup_integrator_dispatches_total"] == "counter"


def test_integrator_dispatches_labelled_with_the_ports_backends(tmp_path):
    # the labels are the port's backend names (ops.backends), not the JAX
    # package's pallas/xla-*; on the CPU in det mode that is torch-det
    svc = _service(tmp_path)
    try:
        svc._execute("create", _spec("acme"))
        svc._execute("step", {"tenant": "acme", "megasteps": 1})
        _drain(svc)
        backends = {
            k[len("integrator_dispatches_"):]: v
            for k, v in runtime.snapshot().items()
            if k.startswith("integrator_dispatches_")
        }
        assert "torch-det" in backends
        parsed = pulse.parse_exposition(svc.metrics_text())
        for name, count in backends.items():
            assert pulse.sample_value(
                parsed, "magicsoup_integrator_dispatches_total", backend=name) >= count
        for s in parsed["samples"]:
            if s["name"] == "magicsoup_runtime_total":
                assert not s["labels"]["counter"].startswith("integrator_dispatches_")
    finally:
        svc._shutdown()


def test_metrics_scrape_is_monotone_and_counts_itself(tmp_path):
    svc = _service(tmp_path)
    try:
        svc._execute("create", _spec("acme"))
        svc._execute("step", {"tenant": "acme", "megasteps": 1})
        _drain(svc)
        p1 = pulse.parse_exposition(svc.metrics_text())
        svc._execute("step", {"tenant": "acme", "megasteps": 1})
        _drain(svc)
        p2 = pulse.parse_exposition(svc.metrics_text())
        for name, kind in p1["types"].items():
            if kind != "counter":
                continue
            for s in p1["samples"]:
                if s["name"] == name:
                    later = pulse.sample_value(p2, name, **s["labels"])
                    assert later is not None and later >= s["value"], name
        assert pulse.sample_value(p2, "magicsoup_scrapes_total") == (
            pulse.sample_value(p1, "magicsoup_scrapes_total") + 1)
        assert pulse.sample_value(p2, "magicsoup_megasteps_total") == 2
    finally:
        svc._shutdown()


def test_metrics_report_chaos_degraded_states(tmp_path):
    svc = _service(tmp_path)
    try:
        chaos.note_degraded("checkpoint", "fixture")
        parsed = pulse.parse_exposition(svc.metrics_text())
        assert pulse.sample_value(parsed, "magicsoup_degraded", subsystem="checkpoint") == 1
        chaos.clear_degraded("checkpoint")
        parsed = pulse.parse_exposition(svc.metrics_text())
        assert pulse.sample_value(parsed, "magicsoup_degraded", subsystem="checkpoint") == 0
    finally:
        chaos.clear_degraded("checkpoint")
        svc._shutdown()


def test_healthz_reports_queue_depth_and_oldest_age(tmp_path):
    svc = _service(tmp_path)
    try:
        snap = svc.health()
        assert (snap["queue_depth"], snap["oldest_command_age_s"]) == (0, 0.0)
        parsed = pulse.parse_exposition(svc.metrics_text())
        assert pulse.sample_value(parsed, "magicsoup_command_queue_depth") == 0
        assert pulse.sample_value(parsed, "magicsoup_oldest_command_age_seconds") == 0
    finally:
        svc._shutdown()


def test_serve_queue_full_is_typed_backpressure(tmp_path):
    runtime.reset_counters()
    svc = _service(tmp_path).start()
    try:
        chaos.arm("serve.queue:full@1x1")
        with pytest.raises(ServeError) as err:
            svc.submit("list", {})
        assert err.value.status == 503
        assert err.value.retry_after is not None and err.value.retry_after > 0
        assert "serve.queue" in chaos.degraded_states()
        assert isinstance(svc.submit("list", {}), dict)
        assert "serve.queue" not in chaos.degraded_states()
    finally:
        svc.stop()
    assert runtime.snapshot()["serve_queue_full"] == 1


def test_cadence_save_failure_is_skipped_and_counted(tmp_path):
    svc = _service(tmp_path)
    svc._execute("create", _spec("alpha", checkpoint_cadence=1))
    svc._execute("step", {"tenant": "alpha", "megasteps": 2})
    chaos.arm("checkpoint.write:enospc@1x1")
    with pytest.warns(UserWarning, match="skipped and counted"):
        svc._tick()
    assert "serve.checkpoint.alpha" in svc.health()["degraded"]
    svc._tick()  # the next cadence save lands and clears the state
    assert "serve.checkpoint.alpha" not in svc.health()["degraded"]
    assert runtime.snapshot()["serve_save_skips"] >= 1
    assert svc._execute("observe", {"tenant": "alpha"})["megasteps"] == 2


# ------------------------------------------------ device rule + CLI
def test_no_card_raises_naming_the_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("holds the rule on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetService(tmp_path / "srv")
    from magicsoup_tpu_torch.serve.__main__ import main

    with pytest.raises(SystemExit) as exit_:
        main(["--dir", str(tmp_path / "cli")])
    assert exit_.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "cli").exists()


def test_serve_imports_no_jax():
    code = (
        "import sys; import magicsoup_tpu_torch.serve, magicsoup_tpu_torch.serve.__main__; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'magicsoup_tpu' or m.startswith('magicsoup_tpu.')]; print(bad)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cache_dir_rule_and_no_build_on_the_cpu(tmp_path, monkeypatch):
    from magicsoup_tpu_torch import _build, cache

    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.compile_cache_dir() == cache.DEFAULT_CACHE_DIR == _build.build_dir()
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "kcache"))
    assert cache.compile_cache_dir() == _build.build_dir() == tmp_path / "kcache"
    for off in ("", "0", "off", "None", "disabled"):
        monkeypatch.setenv(cache.ENV_VAR, off)
        with pytest.raises(ValueError, match="cannot run unbuilt"):
            cache.compile_cache_dir()
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "kcache"))
    runtime.reset_counters()
    assert cache.ensure_compile_cache("cpu") == tmp_path / "kcache"
    assert not (tmp_path / "kcache").exists()
    snap = runtime.snapshot()
    assert snap["persistent_cache_hits"] == snap["persistent_cache_misses"] == 0


def test_cli_ready_sigterm_and_sigkill_restart(tmp_path):
    env = dict(os.environ, MAGICSOUP_TPU_DETERMINISTIC="1", PYTHONPATH=str(REPO))
    procs = []

    def spawn(home):
        proc = subprocess.Popen(
            [sys.executable, "-m", "magicsoup_tpu_torch.serve", "--dir", str(home),
             "--port", "0", "--block", "2", "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        procs.append(proc)
        ready = json.loads(proc.stdout.readline())
        assert ready["serve"] == "ready"
        return proc, ready

    tenants = (("t1", 7, 16), ("t2", 11, 16), ("t3", 17, 8))

    def first_half(port):
        for tid, seed, msz in tenants:
            status, out = _req(port, "POST", "/tenants", _spec(tid, seed=seed, map_size=msz))
            assert status == 200 and out["status"] == "active"
        for tid, _, _ in tenants:
            _req(port, "POST", f"/tenants/{tid}/step", {"megasteps": 2})
        for tid, _, _ in tenants:
            _wait_megasteps(port, tid, 2)
            assert _req(port, "POST", f"/tenants/{tid}/checkpoint")[0] == 200

    def second_half(port):
        for tid, _, _ in tenants:
            _req(port, "POST", f"/tenants/{tid}/step", {"megasteps": 1})
            _wait_megasteps(port, tid, 3)
        return {tid: _req(port, "GET", f"/tenants/{tid}/digest")[1]["digest"] for tid, _, _ in tenants}

    try:
        base, ready = spawn(tmp_path / "a")
        assert ready["tenants"] == 0
        first_half(ready["port"])
        want = second_half(ready["port"])
        base.send_signal(signal.SIGTERM)
        assert base.wait(timeout=120) == 0
        assert json.loads(base.stdout.readline()) == {"serve": "stopped"}
        assert (tmp_path / "a" / "tenants.json").exists()
        for label in range(3):
            assert list((tmp_path / "a" / "worlds").glob(f"world-{label:03d}-*.msck"))

        victim, ready = spawn(tmp_path / "b")
        first_half(ready["port"])
        victim.send_signal(signal.SIGKILL)
        assert victim.wait(timeout=60) == -signal.SIGKILL
        again, ready = spawn(tmp_path / "b")
        assert ready["tenants"] == 3
        for tid, _, _ in tenants:
            assert _req(ready["port"], "GET", f"/tenants/{tid}")[1]["megasteps"] == 2
        assert second_half(ready["port"]) == want
        again.send_signal(signal.SIGTERM)
        assert again.wait(timeout=120) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
