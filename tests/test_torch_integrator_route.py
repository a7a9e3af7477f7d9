"""
The integrator kernel's route, as the port counts it and as it refuses a
shape:

- ``route_bytes`` gives the bytes of the six parameter groups in the
  kernel's layout, and of the groups that the launch plan stages in
  shared memory, as ``smem_bytes`` and ``plan`` lay them out;
- ``max_proteins`` is the largest power-of-two protein count whose
  scratch fits, and ``SharedMemoryLimitError`` names it;
- the CPU path counts no route; on the card a co2_fixing world's step
  counts what ``route_bytes`` gives at its (p, s), its protein slots
  (rows x p) and, on the device, those its tiles walk (marked ``cuda``);
- on the card the kernel walks each cell's own proteins: on the ragged
  states of ``test_torch_kernel_emulation.py`` (solo, B = 3, grouped)
  and on a world's own state it is bit-equal to itself on the same cells
  with the protein axis cut to what they hold, or padded with empty
  slots, and its slot counters are the host's sums (marked ``cuda``).
"""
import importlib
import random

import pytest
import torch

import magicsoup_tpu_torch as mt
from magicsoup_tpu_torch import telemetry
from magicsoup_tpu_torch.containers import Molecule
from magicsoup_tpu_torch.ops import cuda_integrate as ci

ROUTE = ("integrator.param_bytes", "integrator.staged_bytes",
         "integrator.resident_launches", "integrator.partial_launches",
         "integrator.streamed_launches")

#: (p, s): Wood-Ljungdahl's 28 signals and co2_fixing's 82
SHAPES = [(64, 28), (512, 28), (64, 82), (128, 82), (1024, 82)]


@pytest.mark.parametrize("p,s", SHAPES, ids=[f"p{p}-s{s}" for p, s in SHAPES])
def test_route_bytes_follow_the_launch_plan(p, s):
    how = ci.plan(p, s)
    scratch = ci.smem_bytes(p, s, 0)
    rows = 10_240
    param, staged = ci.route_bytes(p, s, rows, how.mask)
    tiles = rows // ci.TILE_C
    assert param == tiles * (ci.smem_bytes(p, s, ci.ALL_RESIDENT) - scratch)
    assert staged == tiles * (how.smem_bytes - scratch)
    # the six groups unpadded: int16 N, Nf, Nb, A and float32 Kmr over
    # (p, s), float32 Ke, Kmf, Kmb, Vmax over p; the layout pads s
    assert param >= rows * p * (4 * 2 * s + 4 * s + 16)
    assert ci.route_bytes(p, s, rows, ci.ALL_RESIDENT) == (param, param)
    assert ci.route_bytes(p, s, rows, 0) == (param, 0)
    assert ci.route_bytes(p, s, 2 * rows, how.mask) == (2 * param, 2 * staged)
    assert 0 < staged <= param if how.route != "streamed" else staged == 0


def test_route_shares_at_the_cells_shapes():
    """The staged share at the shapes the benchmark's two cells reach."""
    def share(p, s):
        param, staged = ci.route_bytes(p, s, ci.TILE_C, ci.plan(p, s).mask)
        return 100 * staged / param

    assert share(64, 28) == 100.0 and ci.plan(64, 28).route == "resident"
    assert share(512, 28) == pytest.approx(4.3, abs=0.05)
    assert share(64, 82) == pytest.approx(34.3, abs=0.05)
    assert share(128, 82) == pytest.approx(17.9, abs=0.05)
    assert share(1024, 82) == 0.0 and ci.plan(1024, 82).route == "streamed"


@pytest.mark.parametrize("s", [28, 82])
def test_max_proteins_is_the_kernels_limit(s):
    p = ci.max_proteins(s)
    assert p == 1024
    assert ci.plan(p, s).smem_bytes <= ci.SMEM_LIMIT
    with pytest.raises(ci.SharedMemoryLimitError,
                       match=f"{2 * p} proteins x {s} signals need") as err:
        ci.plan(2 * p, s)
    assert f"at most {p} proteins a cell fit at {s} signals" in str(err.value)
    assert '"Genome size"' in str(err.value)


def test_max_proteins_follows_the_limit():
    assert ci.max_proteins(82, limit=ci.smem_bytes(512, 82, 0)) == 512
    assert ci.max_proteins(82, limit=ci.smem_bytes(512, 82, 0) - 1) == 256
    assert ci.max_proteins(82, limit=ci.smem_bytes(1, 82, 0) - 1) == 0


def _co2_world(device: str, genome_size: int, n: int, monkeypatch):
    # co2_fixing gives NADP and ADP other energies than Wood-Ljungdahl:
    # build its molecules in a registry of this test's own
    monkeypatch.setattr(Molecule, "_registry", {})
    chem = importlib.import_module("magicsoup_tpu_torch.examples.co2_fixing").CHEMISTRY
    w = mt.World(chemistry=chem, map_size=64, seed=19, device=device)
    rng = random.Random(19)
    w.spawn_cells([mt.random_genome(s=genome_size, rng=rng) for _ in range(n)])
    return w


def test_cpu_step_counts_no_route(monkeypatch):
    w = _co2_world("cpu", 300, 64, monkeypatch)
    before = telemetry.counter_totals()
    w.enzymatic_activity()
    after = telemetry.counter_totals()
    assert after["integrator.calls"] - before.get("integrator.calls", 0) == 1
    for name in ROUTE:
        assert after.get(name, 0) == before.get(name, 0), name


@pytest.mark.cuda
def test_card_step_counts_its_route(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the integrator kernel has no CPU mode")
    monkeypatch.setenv("MAGICSOUP_TPU_TORCH_INTEGRATOR", "cuda")
    # 3-kb genomes: about 48 proteins a cell, p 64, the partial route at s 82
    w = _co2_world("cuda", 3000, 1024, monkeypatch)
    w.enzymatic_activity()  # warm: the kernel's build and first launch
    before = telemetry.counter_totals()
    w.enzymatic_activity()
    torch.cuda.synchronize()
    after = telemetry.counter_totals()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    p, s = w.kinetics.params.Vmax.shape[1], 2 * len(w.chemistry.molecules)
    assert s == 82 and delta["integrator.launches"] == 1
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    how = ci.plan(p, s, limit)
    param, staged = ci.route_bytes(p, s, delta["integrator.rows"], how.mask)
    assert delta["integrator.param_bytes"] == param > 0
    assert delta["integrator.staged_bytes"] == staged
    assert delta[f"integrator.{how.route}_launches"] == 1
    assert sum(delta.get(k, 0) for k in ROUTE[2:]) == 1
    slots = delta["integrator.rows"] * p
    assert delta["integrator.slots"] == slots
    assert 0 < delta["integrator.live_slots"] <= delta["integrator.walked_slots"] <= slots


def _card(X, params):
    return X.cuda(), ci.CellParams(*(t.cuda() for t in params))


def _slot_delta(fn):
    """``fn()`` and what it added to the kernel's slot counters."""
    before = telemetry.counter_totals()
    out = fn()
    after = telemetry.counter_totals()
    return out, [after.get(k, 0) - before.get(k, 0) for k in ci.SLOT_COUNTERS]


@pytest.mark.cuda
def test_card_kernel_walks_each_cells_own_proteins():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the integrator kernel has no CPU mode")
    from test_torch_kernel_emulation import RAGGED, _bits, _cut, _ragged, _ragged_stack, _slots

    for p, s, cut in RAGGED:
        X, params, ext = _ragged(40, p, s, cut, seed=p + s)
        X, params = _card(X, params)
        out, slots = _slot_delta(lambda: ci.integrate_signals_cuda(X, params))
        want = ci.integrate_signals_cuda(X, _cut(params, cut))
        assert torch.equal(_bits(out), _bits(want)), (p, s)
        assert slots == _slots(ext), (p, s)
        assert torch.equal(want[0, 8:16], X[0, 8:16])
        assert torch.isnan(want[0, 18]).any() and not torch.isnan(want[0, :18]).any()
    groups = [_ragged_stack(32, 28, 8, seed=7), _ragged(40, 64, 82, 8, seed=8)]
    groups = [(*_card(X, params), ext) for X, params, ext in groups]
    for X, params, ext in groups:  # B = 3, then a world on the partial route
        out, slots = _slot_delta(lambda: ci.integrate_signals_cuda(X, params))
        assert torch.equal(_bits(out), _bits(ci.integrate_signals_cuda(X, _cut(params, 8))))
        assert slots == _slots(ext)
    outs, slots = _slot_delta(lambda: ci.integrate_signals_cuda_grouped(
        [X for X, _, _ in groups], [params for _, params, _ in groups]))
    assert slots == [sum(v) for v in zip(*(_slots(ext) for _, _, ext in groups))]
    for (X, params, _), out in zip(groups, outs):
        assert torch.equal(_bits(out), _bits(ci.integrate_signals_cuda(X, _cut(params, 8))))


@pytest.mark.cuda
def test_card_kernel_on_a_worlds_state_ignores_empty_slots(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the integrator kernel has no CPU mode")
    w = _co2_world("cuda", 3000, 1024, monkeypatch)
    X, params = w.integrator_inputs()
    X, params = X[None], ci.CellParams(*(t[None] for t in params))
    p = params.Ke.shape[-1]
    held = ((params.N != 0) | (params.Nf != 0) | (params.Nb != 0)).any(-1)
    widest = int(torch.where(held, torch.arange(1, p + 1, device="cuda"), 0).max())
    cut = 1 << (widest - 1).bit_length()
    wide = ci.CellParams(*(torch.cat([t, torch.zeros_like(t)], 2) for t in params))
    out = ci.integrate_signals_cuda(X, params)
    assert cut < 2 * p
    for other in (ci.CellParams(*(t[:, :, :cut].contiguous() for t in params)), wide):
        assert torch.equal(out, ci.integrate_signals_cuda(X, other))
