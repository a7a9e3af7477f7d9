"""
The serving wire format: tenant specs, JSON plumbing, HTTP routing.
Counterpart of :mod:`magicsoup_tpu.serve.api`, with the same spec format,
routes and error statuses.

Everything here is stdlib glue between HTTP request bodies and the
service's command loop.  A *tenant spec* is the JSON body of
``POST /tenants``; it names the chemistry, world shape and stepper knobs
of one simulated world:

.. code-block:: json

    {
      "tenant": "acme",
      "seed": 7,
      "map_size": 16,
      "n_cells": 24,
      "genome_size": 200,
      "deterministic": true,
      "checkpoint_cadence": 4,
      "queue": false,
      "chemistry": {
        "molecules": [
          {"name": "sv-a", "energy": 10000.0},
          {"name": "sv-atp", "energy": 8000.0, "half_life": 100000}
        ],
        "reactions": [[["sv-a"], ["sv-atp"]]]
      },
      "stepper": {"mol_name": "sv-atp", "megastep": 2}
    }

Molecule species are interned process-wide by name (reference
semantics): two tenants may share species, but re-declaring a name with
different attributes is a ``400``, not a new species.  One spec builds
the same world in both packages: the same seeded host draws of
``random_genome``, the same world seed.

:func:`spec_signature` canonicalizes the shape-determining part of a spec
(everything but the identity fields: tenant name, seed, queue flag,
checkpoint cadence), so admission control can recognize "another world
like one we already serve" without building anything: the same signature
means the same capacity rung, and a warm rung admits with no compile.
"""
from __future__ import annotations

import json
import random
from http.server import BaseHTTPRequestHandler

from magicsoup_tpu_torch.guard import chaos as _chaos

__all__ = [
    "ServeError",
    "build_world",
    "make_handler",
    "spec_signature",
    "stepper_kwargs",
    "validate_spec",
]

#: stepper knobs a spec may set, with the serve-side defaults (a
#: chemistry-only world that neither kills nor divides — the capacity
#: rung freezes after the first step, which is what makes warm-rung
#: admission real for the common case)
_STEPPER_DEFAULTS = {
    "kill_below": -1.0,
    "divide_above": 1e30,
    "divide_cost": 0.0,
    "target_cells": None,
    "lag": 1,
    "p_mutation": 0.0,
    "p_recombination": 0.0,
    "megastep": 2,
}
_STEPPER_EXTRA = ("mol_name", "genome_size", "spawn_block", "push_block")

#: spec fields that do NOT feed compiled shapes — excluded from the
#: admission signature so equal worlds with different identities land
#: in the same rung bucket
_IDENTITY_FIELDS = ("tenant", "seed", "queue", "checkpoint_cadence")


class ServeError(Exception):
    """A request failure with an HTTP status (the handler maps it to a
    JSON ``{"error": ...}`` response instead of a stack trace).

    ``retry_after`` (seconds), when set, becomes a ``Retry-After``
    response header — backpressure errors (503 queue-full) tell clients
    WHEN to come back instead of leaving them to guess."""

    def __init__(
        self, status: int, message: str, *, retry_after: float | None = None
    ):
        super().__init__(message)
        self.status = int(status)
        self.retry_after = None if retry_after is None else float(retry_after)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ServeError(400, message)


def validate_spec(spec) -> dict:
    """Normalize a tenant spec; raise :class:`ServeError` (400) on any
    malformed field.  Returns a plain-JSON dict (safe to persist in the
    tenant registry verbatim)."""
    _require(isinstance(spec, dict), "tenant spec must be a JSON object")
    out = dict(spec)
    tenant = out.get("tenant")
    _require(
        tenant is None or (isinstance(tenant, str) and tenant),
        "tenant must be a non-empty string",
    )
    out["seed"] = int(out.get("seed", 0))
    out["map_size"] = int(out.get("map_size", 16))
    _require(out["map_size"] >= 2, "map_size must be >= 2")
    out["n_cells"] = int(out.get("n_cells", 8))
    _require(out["n_cells"] >= 1, "n_cells must be >= 1")
    out["genome_size"] = int(out.get("genome_size", 200))
    _require(out["genome_size"] >= 30, "genome_size must be >= 30")
    out["deterministic"] = bool(out.get("deterministic", True))
    out["checkpoint_cadence"] = int(out.get("checkpoint_cadence", 0))
    _require(
        out["checkpoint_cadence"] >= 0, "checkpoint_cadence must be >= 0"
    )
    out["queue"] = bool(out.get("queue", False))

    chem = out.get("chemistry")
    _require(
        isinstance(chem, dict)
        and isinstance(chem.get("molecules"), list)
        and chem["molecules"],
        "chemistry.molecules must be a non-empty list",
    )
    names = set()
    for mol in chem["molecules"]:
        _require(
            isinstance(mol, dict)
            and isinstance(mol.get("name"), str)
            and "energy" in mol,
            "each molecule needs at least {name, energy}",
        )
        names.add(mol["name"])
    reactions = chem.get("reactions", [])
    _require(isinstance(reactions, list), "chemistry.reactions must be a list")
    for rxn in reactions:
        _require(
            isinstance(rxn, (list, tuple)) and len(rxn) == 2,
            "each reaction is a [substrates, products] pair",
        )
        for side in rxn:
            _require(
                isinstance(side, (list, tuple))
                and all(n in names for n in side),
                "reaction sides must name declared molecules",
            )

    st = out.get("stepper")
    _require(
        isinstance(st, dict) and isinstance(st.get("mol_name"), str),
        "stepper.mol_name must name the survival molecule",
    )
    _require(
        st["mol_name"] in names,
        f"stepper.mol_name {st['mol_name']!r} is not a declared molecule",
    )
    unknown = set(st) - set(_STEPPER_DEFAULTS) - set(_STEPPER_EXTRA)
    _require(not unknown, f"unknown stepper knobs: {sorted(unknown)}")
    return out


def build_chemistry(chem: dict):
    """Instantiate the spec's molecules/reactions (interned by name)."""
    import magicsoup_tpu_torch as mt

    try:
        mols = {
            m["name"]: mt.Molecule(
                m["name"],
                float(m["energy"]),
                **{
                    k: m[k]
                    for k in ("half_life", "diffusivity", "permeability")
                    if k in m
                },
            )
            for m in chem["molecules"]
        }
    except ValueError as exc:  # conflicting re-declaration of a name
        raise ServeError(400, f"molecule conflict: {exc}") from exc
    reactions = [
        ([mols[n] for n in subs], [mols[n] for n in prods])
        for subs, prods in chem.get("reactions", [])
    ]
    return mt.Chemistry(molecules=list(mols.values()), reactions=reactions)


def build_world(spec: dict, device=None):
    """Build and seed the tenant's :class:`~magicsoup_tpu_torch.World` on
    ``device`` from a validated spec; deterministic given the spec (the
    seed drives both the world's generators and the genome draws).
    ``None`` means the card and raises without one."""
    import magicsoup_tpu_torch as mt

    chem = build_chemistry(spec["chemistry"])
    world = mt.World(
        chemistry=chem, map_size=spec["map_size"], seed=spec["seed"], device=device
    )
    world.deterministic = spec["deterministic"]
    rng = random.Random(spec["seed"])
    world.spawn_cells(
        [
            mt.random_genome(s=spec["genome_size"], rng=rng)
            for _ in range(spec["n_cells"])
        ]
    )
    return world


def stepper_kwargs(spec: dict) -> dict:
    """The ``scheduler.admit`` kwargs a spec resolves to (defaults
    applied; ``genome_size`` falls back to the world-level field)."""
    st = spec["stepper"]
    kwargs = dict(_STEPPER_DEFAULTS)
    kwargs.update({k: st[k] for k in st})
    kwargs.setdefault("genome_size", spec["genome_size"])
    return kwargs


def spec_signature(spec: dict) -> str:
    """Canonical string over the shape-determining spec fields — two
    specs with equal signatures admit into the same capacity rung."""
    shaped = {
        k: spec[k] for k in sorted(spec) if k not in _IDENTITY_FIELDS
    }
    return json.dumps(shaped, sort_keys=True)


# ---------------------------------------------------------------- #
# HTTP routing                                                     #
# ---------------------------------------------------------------- #

def _route(method: str, path: str, body) -> tuple[str, dict]:
    """Map (method, path, body) to a service command; 404/405 on miss."""
    if not isinstance(body, dict):
        raise ServeError(400, "request body must be a JSON object")
    parts = [p for p in path.split("?", 1)[0].split("/") if p]
    if parts == ["healthz"] and method == "GET":
        return "health", {}
    if parts == ["metrics"] and method == "GET":
        return "metrics", {}
    if parts == ["counters"] and method == "GET":
        return "counters", {}
    if parts == ["accounting"] and method == "GET":
        return "accounting", {}
    if parts == ["admission"] and method == "POST":
        return "admission", body
    if parts == ["shutdown"] and method == "POST":
        return "shutdown", {}
    if parts == ["tenants"]:
        if method == "GET":
            return "list", {}
        if method == "POST":
            return "create", body
        raise ServeError(405, f"{method} not allowed on /tenants")
    if len(parts) == 2 and parts[0] == "tenants":
        tid = parts[1]
        if method == "GET":
            return "observe", {"tenant": tid}
        if method == "DELETE":
            return "detach", {"tenant": tid}
        raise ServeError(405, f"{method} not allowed on /tenants/<id>")
    if len(parts) == 3 and parts[0] == "tenants":
        tid, verb = parts[1], parts[2]
        actions = {
            ("POST", "step"): "step",
            ("POST", "checkpoint"): "checkpoint",
            ("POST", "restore"): "restore",
            ("GET", "digest"): "digest",
        }
        name = actions.get((method, verb))
        if name is None:
            raise ServeError(404, f"unknown action {verb!r}")
        payload = dict(body or {})
        payload["tenant"] = tid
        return name, payload
    raise ServeError(404, f"no route for {method} {path}")


def make_handler(service):
    """Build the :class:`BaseHTTPRequestHandler` subclass bound to one
    :class:`~magicsoup_tpu_torch.serve.service.FleetService`.  Handler
    threads never touch fleet or device state: every command is enqueued
    to the single-writer scheduler loop and the thread blocks on its
    completion event (with a timeout, so a wedged loop surfaces as a 504
    instead of a hung client)."""

    class Handler(BaseHTTPRequestHandler):
        server_version = "magicsoup-serve/1"
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet: telemetry is the log
            pass

        def _reply(
            self, status: int, obj, *, retry_after: float | None = None
        ) -> None:
            self._send(
                status,
                (json.dumps(obj) + "\n").encode(),
                "application/json",
                retry_after=retry_after,
            )

        def _send(
            self,
            status: int,
            blob: bytes,
            content_type: str,
            *,
            retry_after: float | None = None,
        ) -> None:
            fault = _chaos.site("serve.response")
            if fault is not None and fault.kind == "malformed":
                # truncated non-JSON body with honest framing: the
                # client's json parse fails, not its socket read
                blob = b'{"chaos": malformed' + b"\n"
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(blob)))
            if retry_after is not None:
                self.send_header("Retry-After", f"{retry_after:g}")
            self.end_headers()
            if fault is not None and fault.kind == "drop":
                # connection drop mid-response: the header promised
                # len(blob) bytes, the peer gets half and then EOF
                self.wfile.write(blob[: max(1, len(blob) // 2)])
                self.close_connection = True
                return
            self.wfile.write(blob)

        def _body(self):
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return {}
            try:
                return json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as exc:
                raise ServeError(400, f"request body is not JSON: {exc}")

        def _handle(self, method: str) -> None:
            try:
                name, payload = _route(method, self.path, self._body())
                if name == "health":
                    # served from the loop's published snapshot, not the
                    # command queue: liveness must not queue behind work
                    self._reply(200, service.health())
                    return
                if name == "metrics":
                    # same queue-bypass rule as /healthz: a scrape reads
                    # the published registry and process counters, never
                    # the single-writer loop
                    from magicsoup_tpu_torch.telemetry.metrics import CONTENT_TYPE

                    self._send(
                        200, service.metrics_text().encode(), CONTENT_TYPE
                    )
                    return
                self._reply(200, service.submit(name, payload))
            except ServeError as exc:
                self._reply(
                    exc.status,
                    {"error": str(exc)},
                    retry_after=exc.retry_after,
                )
            # graftlint: disable=GL013 delivered to the client as HTTP 500
            except Exception as exc:  # delivered to the client as HTTP 500
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_DELETE(self):
            self._handle("DELETE")

    return Handler
