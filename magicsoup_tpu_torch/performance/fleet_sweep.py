"""
Fleet B x K sweep: B independent worlds stacked into one fleet
(:class:`magicsoup_tpu_torch.FleetScheduler`) timed across fleet sizes
and megastep settings, one JSON line per (B, K) point.  The port of
``performance/fleet_sweep.py``.

    python -m magicsoup_tpu_torch.performance.fleet_sweep [--bs 1,4,16,64] [--ks 1,4]

The headline number is PER-WORLD steps/s: ``dispatches * K`` simulation
steps advance EVERY world of the fleet per measured window, so the
aggregate is ``per_world * B``.  Worlds are chemistry-only (selection
and evolution off) and identically built, so all B share one capacity
rung: one group, one K2 launch per simulated step on the card.

``--mixed-rungs`` benches cross-rung fusion instead: R capacity rungs
(the map size doubling per rung) x B worlds per rung, each point under
``fusion="rung"`` (R launches per simulated step) and ``fusion="fleet"``
(one grouped launch); the fused row carries ``speedup`` over the
per-rung row.  Each row has the JAX script's keys (``backend`` is the
port's device type) plus ``"device"``.  Runs on the card unless
``--device cpu``.
"""
import argparse
import json
import random
import sys
import time

from magicsoup_tpu_torch.performance import add_device_arg, device_name, driver_device


def _n_groups(fleet) -> int:
    return sum(len(sib) for sib in fleet._groups.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", default="1,4,16,64", help="comma-separated fleet sizes")
    ap.add_argument("--ks", default="1,4", help="comma-separated K values")
    ap.add_argument("--mixed-rungs", action="store_true",
                    help="bench fused vs per-rung dispatch across rung-count x B")
    ap.add_argument("--rungs", default="2,3", help="comma-separated rung counts for --mixed-rungs")
    ap.add_argument("--n-cells", type=int, default=64)
    ap.add_argument("--map-size", type=int, default=32)
    ap.add_argument("--genome-size", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=4, help="warmup dispatches")
    ap.add_argument("--steps", type=int, default=16, help="measured SIM steps per point")
    ap.add_argument("--seed", type=int, default=42)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    bs = sorted({int(b) for b in args.bs.split(",")})
    ks = sorted({int(k) for k in args.ks.split(",")})
    device = driver_device(args.device, "fleet_sweep")

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.cache import ensure_compile_cache

    ensure_compile_cache(device)
    backend = device.type
    name = device_name(device)

    mols = [mt.Molecule("fsw-a", 10e3), mt.Molecule("fsw-atp", 8e3, half_life=100_000)]
    chem = mt.Chemistry(molecules=mols, reactions=[([mols[0]], [mols[1]])])

    def _world(seed, map_size=None):
        w = mt.World(chemistry=chem, map_size=map_size or args.map_size, seed=seed,
                     device=device)
        # identical genome streams -> identical token caps -> one rung per map size
        rng = random.Random(args.seed)
        w.spawn_cells(
            [mt.random_genome(s=args.genome_size, rng=rng) for _ in range(args.n_cells)])
        return w

    admit_kw = dict(
        mol_name="fsw-atp",
        kill_below=-1.0,
        divide_above=1e30,
        divide_cost=0.0,
        target_cells=None,
        genome_size=args.genome_size,
        lag=1,
        p_mutation=0.0,
        p_recombination=0.0,
    )

    def timed(fleet, k: int) -> tuple[float, int]:
        for _ in range(max(args.warmup, 2)):
            fleet.step()
        fleet.drain()
        n_disp = max(1, -(-args.steps // k))
        t0 = time.perf_counter()
        for _ in range(n_disp):
            fleet.step()
        fleet.drain()
        dt = (time.perf_counter() - t0) / (n_disp * k)
        return dt, n_disp

    if args.mixed_rungs:
        rungs = sorted({int(r) for r in args.rungs.split(",")})
        k = ks[0]  # the mixed sweep holds K fixed (the first of --ks)
        for n_rungs in rungs:
            for b in bs:
                per_world = {}
                for mode in ("rung", "fleet"):
                    fleet = mt.FleetScheduler(block=b, fusion=mode)
                    for r in range(n_rungs):
                        msz = args.map_size * (2**r)
                        for i in range(b):
                            fleet.admit(_world(args.seed + 100 * r + i, map_size=msz),
                                        megastep=k, **admit_kw)
                    dt, n_disp = timed(fleet, k)
                    fleet.flush()
                    per_world[mode] = 1.0 / dt
                    fused = mode == "fleet"
                    row = {
                        "metric": (
                            f"fleet {'fused' if fused else 'per-rung'} "
                            f"R={n_rungs} B={b} per-world steps/sec "
                            f"({args.n_cells} cells, base map {args.map_size}, {backend})"
                        ),
                        "value": round(per_world[mode], 4),
                        "unit": "steps/s",
                        "rungs": n_rungs,
                        "fleet_size": b,
                        "worlds": b * n_rungs,
                        "fused": fused,
                        "megastep": k,
                        "dispatches": n_disp,
                        "ms_per_step": round(dt * 1e3, 2),
                        "backend": backend,
                    }
                    if fused:
                        row["speedup"] = round(per_world["fleet"] / per_world["rung"], 4)
                    row["device"] = name
                    print(json.dumps(row), flush=True)
        return 0

    for k in ks:
        for b in bs:
            fleet = mt.FleetScheduler(block=b)
            for i in range(b):
                fleet.admit(_world(args.seed + i), megastep=k, **admit_kw)
            dt, n_disp = timed(fleet, k)
            fleet.flush()
            print(json.dumps({
                "metric": (f"fleet B={b} K={k} per-world steps/sec ({args.n_cells} cells, "
                           f"{args.map_size}x{args.map_size} map, {backend})"),
                "value": round(1.0 / dt, 4),
                "unit": "steps/s",
                "fleet_size": b,
                "megastep": k,
                "dispatches": n_disp,
                "ms_per_step": round(dt * 1e3, 2),
                "aggregate_steps_per_s": round(b / dt, 4),
                "groups": _n_groups(fleet),
                "backend": backend,
                "device": name,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
