"""The integrator's byte count counts live cells and the proteins they
hold, not the rows and protein slots the program pads to a capacity."""
import random

from benchmark import roofline, run, trace, worlds
from benchmark.reference.genetics import CodonMaps


def test_byte_count():
    s = 28
    assert roofline.integrator_bytes(1, 0, s) == 8 * s
    assert roofline.integrator_bytes(0, 1, s) == 16 + 12 * s
    assert roofline.integrator_bytes(10, 7, s) == 10 * 8 * s + 7 * (16 + 12 * s)
    assert roofline.share_pct(roofline.HBM_BYTES_PER_S * 1e-3, 2e-3) == 50.0


def test_live_work_counts_live_cells_and_real_proteins():
    config = {"chemistry": "wood_ljungdahl", "map_size": 16, "n_cells": 90,
              "init_genome_size": 500, "abs_temp": 310.0, "mol_map_init": "randn"}
    world = worlds.make_world(config, {"genome_backend": "string"}, 11, "cpu")
    world.kill_cells(list(range(0, 90, 3)))
    cells, proteins = roofline.live_work(worlds.live_genomes(world), 11)
    r = random.Random(11)
    maps = CodonMaps(r.randrange(2**63))
    want = sum(len(maps.translate(g)) for g in world.cell_genomes)
    assert cells == 60 == world.n_cells
    assert proteins == want
    # the reference's count is the program's real proteins (slots with a Vmax)
    assert proteins == int((world.kinetics.params.Vmax[:cells] > 0).sum())
    # the program pads: more rows and protein slots than the work
    assert world.kinetics.params.Vmax.shape[0] > cells
    assert world.kinetics.params.Vmax.numel() > proteins
    live = roofline.integrator_bytes(cells, proteins, 28)
    cap, p = world.kinetics.params.Vmax.shape
    padded = roofline.integrator_bytes(cap, cap * p, 28)
    assert live < padded


def test_roofline_reads_only_the_integrators_kernels():
    reader = run.metric_reader("activity_roofline")
    ranges = {"ms:activity": {"void integrate_kernel<true>(float const*)": 2e-3,
                              "void at::native::cast_kernel(float*)": 6e-3}}
    traced = trace.Trace(window_s=1.0, busy_s=0.1, n_kernels=2, range_kernels=ranges,
                         device_ops=[], idle_gaps=[])
    r = run.Run(stats={}, step_gaps=[], trace=traced, trace_steps=10,
                activity_range="ms:activity", live=[(1000, 7000)], signals=28)
    want = roofline.share_pct(10 * roofline.integrator_bytes(1000, 7000, 28), 2e-3)
    assert reader(r) == want
    # a range with no integrator kernel in it reads nothing
    empty = traced._replace(range_kernels={"ms:activity": {"cast_kernel": 1e-3}})
    assert reader(r._replace(trace=empty)) is None
