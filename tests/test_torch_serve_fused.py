"""
The port's serving plane under cross-rung fusion (``fusion="fleet"``)
against the JAX package's, as ``tests/fast/test_serve.py`` and
``tests/fast/test_metrics.py`` hold the JAX one; the helpers and the
deterministic-mode fixture are ``test_torch_serve.py``'s:

- fused accounting: two tenants of two capacity rungs ride one dispatch;
  each world's ``state_digest`` equals JAX's at every tenant megastep
  boundary, the rows' steps, megasteps and dispatches equal JAX's, and the
  fetch bytes and device time are conserved exactly, also for a megastep
  that only one tenant rode;
- device time is conserved under a fused subset step, and the per-tenant
  metric family carries the same census.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import math  # noqa: E402

from magicsoup_tpu_torch.telemetry import metrics as pulse  # noqa: E402
from test_torch_serve import Pair, _det, _drain, _service, _spec  # noqa: E402, F401


def test_fused_accounting_is_conserved_and_matches_jax(tmp_path):
    p = Pair(tmp_path, fusion="fleet")
    p.run("create", _spec("alpha", seed=7))
    # a double map size is another capacity rung, fused with alpha's
    p.run("create", _spec("beta", seed=11, map_size=32))
    p.run("step", {"tenant": "alpha", "megasteps": 2})
    p.run("step", {"tenant": "beta", "megasteps": 2})
    p.drain()
    # a subset-stepped megastep: only alpha holds budget
    p.run("step", {"tenant": "alpha", "megasteps": 1})
    p.drain()
    acct = p.accounting()
    assert acct["total_steps"] == 10
    assert all(r["fetch_bytes"] > 0 for r in acct["rows"])


def test_device_ms_conserved_under_fleet_fusion_subset_step(tmp_path):
    svc = _service(tmp_path, fusion="fleet")
    try:
        svc._execute("create", _spec("alpha"))
        svc._execute("create", _spec("beta", seed=9))
        svc._execute("create", _spec("gamma", seed=11, map_size=32))
        svc._execute("step", {"tenant": "alpha", "megasteps": 1})
        _drain(svc)
        svc._execute("step", {"tenant": "alpha", "megasteps": 2})
        svc._execute("step", {"tenant": "beta", "megasteps": 2})
        svc._execute("step", {"tenant": "gamma", "megasteps": 1})
        _drain(svc)
        acct = svc._cmd_accounting({})
        total = acct["total_device_us"]
        assert total > 0
        assert sum(r["device_us"] for r in acct["rows"]) == total
        assert {r["tenant"] for r in acct["rows"]} == {"alpha", "beta", "gamma"}
        assert all(r["device_us"] > 0 for r in acct["rows"])
        parsed = pulse.parse_exposition(svc.metrics_text())
        per_tenant = sum(
            pulse.sample_value(parsed, "magicsoup_tenant_device_ms_total", tenant=r["tenant"])
            for r in acct["rows"]
        )
        assert math.isclose(per_tenant, total / 1000.0, abs_tol=1e-6)
        assert pulse.sample_value(parsed, "magicsoup_device_dispatches_total") >= len(acct["rows"])
    finally:
        svc._shutdown()
