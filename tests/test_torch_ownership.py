"""
The port's thread-ownership assertions (``analysis/ownership.py``)
against the JAX package's: the cases of ``tests/fast/test_ownership.py``,
each run on both modules (the port's is a copy of a framework-neutral
module, so both must behave alike), plus a check that the two modules
hold the same source below their docstrings.  Every test pins
``_ENABLED`` with monkeypatch, so the armed and the zero-cost paths both
run whatever the environment says.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import inspect  # noqa: E402
import threading  # noqa: E402

import pytest  # noqa: E402

from magicsoup_tpu.analysis import ownership as jown  # noqa: E402
from magicsoup_tpu_torch.analysis import ownership as town  # noqa: E402

MODULES = {"port": town, "jax": jown}


@pytest.fixture(params=sorted(MODULES))
def own(request):
    return MODULES[request.param]


def make_service(own):
    # defined after _ENABLED is pinned: owned_by reads the flag when it
    # decorates
    class Service:
        @own.owned_by("loop")
        def tick(self):
            return "ticked"

    return Service()


def run_in_thread(fn):
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 - relayed to the test
            box["error"] = exc

    t = threading.Thread(target=target)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    return box


def test_port_module_is_the_reference_below_its_docstring():
    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__ import annotations") :]

    assert body(town) == body(jown)
    assert town.__all__ == jown.__all__


def test_foreign_thread_trips_violation(monkeypatch, own):
    monkeypatch.setattr(own, "_ENABLED", True)
    svc = make_service(own)
    assert svc.tick() == "ticked"  # the main thread claims `loop`
    err = run_in_thread(svc.tick).get("error")
    assert isinstance(err, own.OwnershipViolation)
    assert err.role == "loop"
    assert err.attribute.endswith("tick")
    assert err.owner is threading.main_thread()
    assert isinstance(err, AssertionError)


def test_owner_thread_passes_repeatedly(monkeypatch, own):
    monkeypatch.setattr(own, "_ENABLED", True)
    svc = make_service(own)
    assert svc.tick() == "ticked"
    assert svc.tick() == "ticked"


def test_dead_owner_frees_the_role(monkeypatch, own):
    monkeypatch.setattr(own, "_ENABLED", True)
    svc = make_service(own)
    assert run_in_thread(svc.tick).get("value") == "ticked"
    assert svc.tick() == "ticked"  # the claiming thread died: re-claim


def test_bind_is_a_sanctioned_handoff(monkeypatch, own):
    monkeypatch.setattr(own, "_ENABLED", True)
    svc = make_service(own)
    assert svc.tick() == "ticked"
    box = {}

    def worker():
        own.bind(svc, "loop")
        box["value"] = svc.tick()

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert box.get("value") == "ticked"
    assert svc.tick() == "ticked"


def test_assert_owner_names_the_attribute(monkeypatch, own):
    monkeypatch.setattr(own, "_ENABLED", True)

    class Sink:
        pass

    sink = Sink()
    own.assert_owner(sink, "writer", attribute="Sink._fh")
    err = run_in_thread(
        lambda: own.assert_owner(sink, "writer", attribute="Sink._fh")
    ).get("error")
    assert isinstance(err, own.OwnershipViolation)
    assert err.attribute == "Sink._fh"
    assert "Sink._fh" in str(err) and "writer" in str(err)


def test_slotted_instances_degrade_to_noop(monkeypatch, own):
    monkeypatch.setattr(own, "_ENABLED", True)

    class Slotted:
        __slots__ = ()

        @own.owned_by("loop")
        def tick(self):
            return "ticked"

    svc = Slotted()
    assert svc.tick() == "ticked"
    assert run_in_thread(svc.tick).get("value") == "ticked"


def test_disabled_mode_is_zero_cost(monkeypatch, own):
    monkeypatch.setattr(own, "_ENABLED", False)

    def tick(self):
        return "ticked"

    assert own.owned_by("loop")(tick) is tick

    class Service:
        pass

    svc = Service()
    own.bind(svc, "loop")
    own.assert_owner(svc, "loop")
    assert not hasattr(svc, "_graftrace_owners")


def test_violation_message_names_both_threads(monkeypatch, own):
    monkeypatch.setattr(own, "_ENABLED", True)
    svc = make_service(own)
    svc.tick()
    msg = str(run_in_thread(svc.tick)["error"])
    assert threading.main_thread().name in msg
    assert "entered from" in msg


def test_enabled_reflects_the_environment(own):
    assert own.enabled() is own._ENABLED
    assert town._ENABLED is jown._ENABLED  # both read the same variable


@pytest.mark.parametrize("flag", [True, False])
def test_bind_accepts_explicit_thread(monkeypatch, own, flag):
    monkeypatch.setattr(own, "_ENABLED", flag)

    class Service:
        pass

    svc = Service()
    own.bind(svc, "loop", thread=threading.main_thread())
    if flag:
        assert svc._graftrace_owners["loop"] is threading.main_thread()
    else:
        assert not hasattr(svc, "_graftrace_owners")


def test_recorder_writer_role_is_bound_at_attach(monkeypatch, tmp_path):
    # the port's recorder binds its sink to the attaching thread; a flush
    # from another thread trips the check when it is armed
    from magicsoup_tpu_torch.telemetry import recorder as trec

    monkeypatch.setattr(town, "_ENABLED", True)
    rec = trec.TelemetryRecorder(path=tmp_path / "t.jsonl")
    rec.flush()
    err = run_in_thread(rec.flush).get("error")
    assert isinstance(err, town.OwnershipViolation)
    assert err.attribute == "TelemetryRecorder._fh"
    rec.detach()
