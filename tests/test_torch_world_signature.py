"""
The port's ``World`` constructor against the JAX package's, side by side
on the CPU:

- the parameter names of ``World.__init__``, in order, are the JAX
  package's, so a positional call past ``seed`` binds the same names on
  both sides (and builds the same kind of world);
- ``use_pallas`` resolves as the JAX package resolves it, with ``cuda``
  in the place of ``pallas``: ``True`` pins the kernel's backend and
  ``World.use_pallas`` is true, ``False`` the torch integrator of the
  numeric mode; an explicit ``integrator=`` and the integrator env var
  come before it; an ``integrator=`` that disagrees with it, or the
  kernel in deterministic mode, raises ``ValueError`` on both sides.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import inspect  # noqa: E402

import pytest  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu.ops import backends as jbackends  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.ops import backends as tbackends  # noqa: E402

#: the kernel's backend on each side
KERNEL = {"jax": "pallas", "port": "cuda"}


def _params(cls) -> list[str]:
    return list(inspect.signature(cls.__init__).parameters)[1:]


def _world(side: str, *args, **kw):
    """A world of ``side`` with that side's Wood-Ljungdahl chemistry."""
    if side == "jax":
        return ms.World(JCHEM, *args, **kw)
    return mt.World(TCHEM, *args, **kw)


@pytest.fixture
def fast_mode(monkeypatch):
    for var in ("MAGICSOUP_TPU_DETERMINISTIC", jbackends.ENV_VAR, jbackends.LEGACY_ENV_VAR,
                tbackends.ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_constructor_parameters_are_the_jax_packages_in_order():
    assert _params(mt.World) == _params(ms.World)
    jsig, tsig = inspect.signature(ms.World.__init__), inspect.signature(mt.World.__init__)
    for name in _params(ms.World):
        assert tsig.parameters[name].kind == jsig.parameters[name].kind, name


def test_positional_call_past_seed_binds_the_same_names(fast_mode):
    head = (16, 310.0, "randn", ("ATG",), ("TGA",))
    # batch_size, seed, mesh, integrator, use_pallas, phenotype_cache_size,
    # telemetry, genome_backend
    tail = (None, 3, None, None, True, 0, None, "token")
    jargs, targs = (JCHEM, *head, None, *tail), (TCHEM, *head, "cpu", *tail)
    jbound = inspect.signature(ms.World.__init__).bind(None, *jargs).arguments
    tbound = inspect.signature(mt.World.__init__).bind(None, *targs).arguments
    assert list(jbound) == list(tbound)
    same = lambda bound: {k: v for k, v in bound.items() if k not in ("self", "chemistry", "device")}  # noqa: E731
    assert same(jbound) == same(tbound)
    # and the worlds built from them agree on what each name means
    for w, side in ((ms.World(*jargs), "jax"), (mt.World(*targs), "port")):
        assert (w.map_size, w.abs_temp, w.seed) == (16, 310.0, 3)
        assert tuple(w.genetics.start_codons) == ("ATG",)
        assert w.integrator == KERNEL[side] and w.use_pallas
        assert w.phenotypes.maxsize == 0 and w.genome_backend == "token"


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("use_pallas", [True, False, None])
def test_use_pallas_selects_the_kernel(fast_mode, side, use_pallas):
    device = {} if side == "jax" else {"device": "cpu"}
    w = _world(side, map_size=16, seed=0, use_pallas=use_pallas, **device)
    assert w.use_pallas == (w.integrator == KERNEL[side])
    if use_pallas:
        assert w.integrator == KERNEL[side] and w.use_pallas
    elif use_pallas is False:
        assert not w.use_pallas
        assert w.integrator == {"jax": "xla-fast", "port": "torch-fast"}[side]
    with pytest.raises(AttributeError):
        w.use_pallas = True  # read-only


@pytest.mark.parametrize("side", ["jax", "port"])
def test_integrator_and_env_come_before_use_pallas(fast_mode, side):
    device = {} if side == "jax" else {"device": "cpu"}
    fast = {"jax": "xla-fast", "port": "torch-fast"}[side]
    w = _world(side, map_size=16, seed=0, integrator=KERNEL[side], use_pallas=True, **device)
    assert w.integrator == KERNEL[side] and w.use_pallas
    env = jbackends.ENV_VAR if side == "jax" else tbackends.ENV_VAR
    fast_mode.setenv(env, fast)
    w = _world(side, map_size=16, seed=0, use_pallas=True, **device)
    assert w.integrator == fast and not w.use_pallas


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("pair", ["kernel_without_flag", "other_with_flag"])
def test_conflicting_integrator_and_use_pallas_raise(fast_mode, side, pair):
    device = {} if side == "jax" else {"device": "cpu"}
    fast = {"jax": "xla-fast", "port": "torch-fast"}[side]
    integrator, use_pallas = (KERNEL[side], False) if pair == "kernel_without_flag" else (fast, True)
    with pytest.raises(ValueError, match="conflicts with use_pallas"):
        _world(side, map_size=16, seed=0, integrator=integrator, use_pallas=use_pallas, **device)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_use_pallas_in_deterministic_mode_raises(fast_mode, side):
    fast_mode.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    device = {} if side == "jax" else {"device": "cpu"}
    with pytest.raises(ValueError, match="deterministic mode"):
        _world(side, map_size=16, seed=0, use_pallas=True, **device)
    w = _world(side, map_size=16, seed=0, use_pallas=False, **device)
    assert w.integrator == {"jax": "xla-det", "port": "torch-det"}[side] and not w.use_pallas
