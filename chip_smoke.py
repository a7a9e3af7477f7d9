"""
Smoke run of the PyTorch/CUDA port on one CUDA card:

1. environment: torch, CUDA, and the card's name and power limit;
2. build: the integrator kernel (``magicsoup_tpu_torch/csrc/integrate.cu``),
   its ladder (``csrc/bisect.cu``), the threefry kernel
   (``csrc/threefry.cu``) and the assembly kernel (``csrc/assemble.cu``)
   with nvcc and the genome engine with g++, from
   the checkout's sources, all started together;
3. K1, the kernel's solo grid, on seeded inputs: against its plain PyTorch
   version at the workload's shapes (q = 10240 live rows, s = 28 signals,
   the world's real protein count p) on inputs drawn as
   ``performance/pallas_bisect.py`` draws them, plus the edge cases, under
   the fast contract (finite and >= 0; 99th-percentile relative error
   < 1e-4; maximum < 0.15); then the kernel's median time over 25
   launches (CUDA events), the plain version's, the host's time per
   launch through the wrapper, and the bound (:func:`_bound`);
4. K1 on the world's state: the same comparison on the signals and
   parameters that the first workload step hands the integrator, under
   the real-state contract (finite and >= 0; at least 85% of cells within
   1e-4 relative, 98% within 0.01 of their largest value, all within
   0.25, or, for a cell beyond that, within 0.25 of the det integrator
   run on its tile on the CPU): the negative guard drains a signal to 0
   up to rounding, and the equilibrium correction's quotient takes
   another branch at 0 than at 5e-7, so which cells do follows
   summation order (ROADMAP C);
5. classic workload: ``World(chemistry=Wood-Ljungdahl, map_size=128,
   seed=42)`` on the card, 10,000 random 500-bp genomes, 3 warm-up steps,
   one timed block of 40 steps of the canonical workload step
   (``magicsoup_tpu_torch.workload.sim_step``) with no barrier but one at
   its end (steps/s), then 10 steps with each phase synchronized and
   timed (seconds per phase); K1's launch count is set to 0 just before
   and must show one launch per step; the state must stay finite and
   >= 0;
6. the pipelined stepper at full width, K = 1 and K = 4: a fresh world as
   in 5, ``PipelinedStepper(world, mol_name="ATP", kill_below=1.0,
   divide_above=5.0, divide_cost=4.0, target_cells=10000,
   genome_size=500, lag=2, megastep=K)``, 3 warm-up dispatches and
   ``drain()``; one dispatch with the fetcher idle under
   ``torch.cuda.set_sync_debug_mode("error")`` (enqueueing must not
   synchronize the host); then a timed window of 60 simulated steps
   ending in ``drain()`` (steps/s in simulated steps), with the kernel's
   launch count set to 0 just before and one launch per simulated step
   after; a profiled window of 10 steps; ``flush()``, and the world's
   state must be finite and >= 0;
7. the fleet: ``FleetScheduler(block=4)`` with 4 such worlds (seeds
   42-45), the same stepper arguments at K = 1, one warm-up fleet step,
   then 20 timed fleet steps ending in ``drain()``; exactly one launch of
   the kernel's batched grid (K2) per fleet step for the group; a
   profiled window; after ``flush()`` every world's state must be finite
   and >= 0;
   over 6 and 7, the invariant and health flags of every record the host
   replays are decoded and counted per window; any flag other than
   ``dead_param_residue`` (which the reference trips too, ROADMAP C)
   fails the run;
8. K2 on seeded inputs, drawn as in 3: B = 4 worlds, each the prefix of
   a stack of the fleet's capacity (16384 rows, the world stride), at
   q = 10240 and at the fleet's own q = capacity, against its plain
   version under the fast contract; each world's slice of the launch
   must be bit-equal to its own B = 1 launch; median time over 25
   launches, the plain version's, and the byte bound;
9. K2 on real state: copies of the integrator's inputs at the first step
   of the stepper's K = 1 timed window (B = 1, its live-row prefix) and
   of the fleet's (B = 4, q = capacity), against the plain version under
   the real-state contract of 4 on the rows with any protein (the rest
   must equal the plain version exactly); the kernel's and the plain
   version's times on them;
10. digests: the sha256 of K1's output on the seeded inputs of 3 at
    q = 10240 (p 32, s 28) and of K2's at 4 x 16384 rows, each equal to
    its committed value (``DIGESTS``), so a change of the kernel's source
    keeps its bits; then the shape sweep: the kernel against its plain
    version on seeded inputs at every (p, s) of ``SWEEP_SHAPES`` (10240
    cells; the fast contract, dead rows unchanged), with the route that
    the launch plan took, its time and its byte bound, and a B = 3 stack
    with a world stride above its rows, each world bit-equal to its own
    launch;
11. K3, the integrator's lowering ladder
    (``magicsoup_tpu_torch.performance.kernel_bisect``): every rung (1-11
    the kernels of ``csrc/bisect.cu``, 12-13 the production entry) against
    its plain version under its contract, at the JAX ladder's defaults
    (256 x 8 x 12) and at the workload's shape (10240 x 32 x 28); rung 11
    bit-equal to K1, each world of rung 12 bit-equal to its own launch;
    per rung its time, the plain version's, its bytes, its byte bound and
    the time of the one PyTorch call that computes it, where there is one
    (rungs 1, 7 and 8), and per kernel rung its shared memory, CTAs per SM
    and waves; a rung that stages parameter groups (2, 4-6, 9-11) also
    runs with none staged, bit-equal to the staged launch and timed in
    turns with it; the ladder's kernel launch count is set to 0 just
    before and read just after;
12. the integrator microbenchmark
    (``magicsoup_tpu_torch.performance.integrator_bench``) at its defaults
    (16384 x 32 x 28, 75% live rows, chains of 10 steps, median of 4):
    ``cuda`` at B 1 and 4, ``torch-fast`` at B 1, one kernel launch per
    chained ``cuda`` step;
13. deterministic mode on the card against the CPU, as
    ``scripts/bitrepro.py`` checks it: the workload step of 5 at 500
    cells, a 64x64 map, 300-bp genomes, seed 7, 10 steps on
    ``device="cpu"`` and on ``"cuda"`` in lockstep with
    ``MAGICSOUP_TPU_DETERMINISTIC=1``, every piece of state hashed after
    every step; then the pipelined stepper at K = 1 for 10 dispatches on
    both devices, with the arguments of the CPU parity tests, compared
    after ``flush()``; the first divergent (step, tensor), with its
    largest absolute and ULP difference, fails the run.  The 10 steps also
    run on the CPU without the flush-to-zero bit (the card keeps
    subnormals as that run does), and whether and where its bits first
    differ from the flushed CPU run's is recorded.  Then a token world
    (``genome_backend="token"``) runs the same 10 steps on both devices,
    each step followed by ``recombinate_cells(p=1e-5)`` and
    ``mutate_cells(p=1e-4)`` so that the token programs change genomes,
    with the store's tokens and lengths among the hashed state;
14. the threefry kernel (``csrc/threefry.cu``) against its plain version
    (``ops/prng.py::hash_counters_plain`` on the same card), bit for bit:
    ``random_bits`` at (16384, 1024) under one key (the token store's
    shape at 10k cells) and at (4, 16384) under four keys, ``split`` of one
    key and of four into 4, and odd sizes (1, 7, 1000003); one launch per
    draw; the kernel's median time per draw at (16384, 1024), the plain
    version's, and the bound (bytes written at the card's memory rate,
    counted integer operations at its CUDA-core rate);
15. the token classic workload: phase 5 with ``genome_backend="token"``
    (the same world, seed, warm-up, timed block and phase pass): steps/s
    beside phase 5's, seconds per phase, one K1 launch per step, threefry
    launches per step, whole-store host fetches per step, and the genome
    decodes of the timed block (only phenotype-cache misses decode);
16. the token stepper at K = 1: phase 6 over a token world (no
    sync-free check: a riding refresh reads the store's host snapshot);
    one K2 launch per simulated step, threefry launches per step;
17. the token fleet: phase 7 over four token worlds, one K2 launch per
    fleet step, flags decoded as in 6 and 7;
18. the genome-ops microbenchmark
    (``magicsoup_tpu_torch.performance.genome_ops``) at its defaults: 1k,
    8k and 40k cells of 1k-bp genomes, string against token for mutate,
    recombinate and the warm translate feed.

19. persistence at full width, on the classic worlds of 5 and 15 after
    their timed steps: ``save`` -> ``from_file(device="cuda")``, ``save``
    -> ``from_file(device="cpu")`` -> ``save`` -> ``from_file("cuda")``,
    and ``save_state`` -> ``load_state`` into a fresh world; after each,
    every state array (full capacity, kinetic parameters and token
    tables, the token store), the genomes, labels, counters and both RNG
    states equal the saved world's bit for bit (``load_state``: the
    state-file set, genomes, labels and counters; the RNG states are not
    part of that format), and ``check.assert_consistent`` passes; the
    world restored on the card runs 10 workload steps with one K1 launch
    each, finite and >= 0 state and an empty audit; seconds and bytes of
    ``save``, ``from_file``, ``save_state`` and ``load_state``; then, in
    deterministic mode at phase 13's 500 cells, a restored world and an
    uninterrupted one, string and token, stay bit-equal for 10 steps;
20. the rest of the World API at full width, on the same worlds:
    ``move_cells()`` and ``reposition_cells()`` of every cell,
    ``get_cell`` of 100 cells, ``kill_cells`` of them and ``add_cells`` of
    them back, ``check.assert_consistent`` after each;
    ``kinetics.integrate_signals`` of the world's signals (one K1 launch)
    against the classic step's activity under the fast contract; a
    ``GenomeFact`` proteome spawned into a fresh world translates to its
    spec;
21. the differential harness on the card
    (``magicsoup_tpu_torch.check.differential``): every det path at seeds
    11 and 23 (the golden files' 16x16 maps, 12 and 16 cells) on
    ``device="cuda"`` and on ``"cpu"``: the structural digests equal the
    committed ``tests/fast/data/golden/differential_seed{11,23}.json`` at
    all 7 boundaries, and each path's ``state_digest`` per boundary equals
    the same path's on the CPU (the first differing array is printed if
    not); ``cuda_k1`` in fast mode, with the real K2, equals
    ``differential_pallas_seed11.json``; the fused paths (the schedule
    world in a mixed-rung fleet, companions on a 32x32 map, ``block=2``):
    ``fused2`` (K = 1, ``fusion="fleet"``) equals
    ``differential_fused2_seed11.json``, and ``fused2`` and
    ``fused_fleet`` (K = 4, ``fusion="auto"``) equal the ``k1`` and
    ``k4`` paths' full digests at every boundary on the card;
22. the guard and telemetry planes (``magicsoup_tpu_torch.guard``,
    ``.telemetry``): a fresh 10k world with a recorder attached runs 5
    classic steps (one K1 launch each), then the string stepper at K = 1
    in four windows of 30 steps with the recorder detached, attached,
    attached, detached (steps/s, rows and bytes written, one K2 launch
    per step, the device-time census one entry per dispatch with its
    total within the window's wall time), one enqueue with the recorder
    attached under ``set_sync_debug_mode("error")``, the JSONL through
    ``validate_rows`` and ``summarize_rows``; ``trace_window`` around 5
    steps (5 K2 launches; the Chrome trace holds the ``ms:*`` ranges and
    the K2 kernel);
    two token worlds from one seed, 20 stepper steps each with the
    recorder off and on (equal whole-store fetches per step); det mode at
    phase 13's 500 cells, the stepper with the recorder on and off,
    string and token, bit-equal; resumes restored in one fresh process
    (``--resume-child``, started by the run): det at 500 cells, string
    K = 1 and 4 and token K = 1, [n dispatches, ``save_run``, n] against
    [n, ``save_run``, restore, n] bit-equal with the audits equal, and the
    10k world of the windows (``save_run`` seconds and bytes,
    ``restore_run`` seconds onto the card with the audit, 10 resumed steps
    of one K2 launch each, an empty audit, finite and >= 0, bit-equal to
    the uninterrupted run or else equal in structure and within the
    per-cell contract of ROADMAP C4); then the injected faults:
    ``dispatch:transient@2x2`` absorbed by ``dispatch_retries=3`` with the
    fault-free det trajectory, ``fetch:delay:5`` past a 2 s
    ``MAGICSOUP_GUARD_FETCH_TIMEOUT`` raising ``WatchdogTimeout`` with one
    diagnostics record, ``checkpoint.write:enospc@2`` failing the second
    save typed and counted, a flipped newest checkpoint making
    ``load_latest`` fall back, and ``inject_nan`` under ``warn``
    (warned, counted), ``quarantine`` (the cell killed) and ``rollback``
    (``SentinelTripped``);
23. the rest of the fleet at the headline configuration (Wood-Ljungdahl,
    s 28, 500-bp genomes, fast mode, the ``cuda`` integrator, p 32):
    (1) the grouped launch (``ms_integrate_signals_grouped``) over seeded
    groups of 2 x 16384 and 2 x 32768 rows and one group at a
    ``SWEEP_SHAPES`` entry off the resident route: each world's sha256
    equal to its group's own launch's, each group under the fast
    contract, one launch per route; its median time against the groups'
    own launches in turns, the plain version's, host microseconds per
    call, CTAs per SM and the bound summed over the groups;
    (2) a mixed-rung fleet: 2 worlds of 10k cells on 128² (seeds 42, 43,
    capacity 16384) and 2 of 20k on 256² (seeds 44, 45, capacity 32768),
    phase 7's selection at K = 1 without capacity growth, ``block=2``,
    twice from the same seeds, ``fusion="rung"`` and ``fusion="fleet"``,
    in interleaved windows of 15 fleet steps (rung, fused, fused, rung):
    world-steps/s per window; per fleet step dispatches, record fetches,
    K2 launches, grouped launches (exactly one per fused step); a
    profiled 5-step window of each; peak memory; flags decoded as in 6
    and 7; after a flush every fused world bit-equal to its per-rung
    twin; (3) the grouped launch on a copy of the fused fleet's
    integrator inputs at its first timed step, each group equal to its
    own launch and under the real-state contract of 9, its times and
    bound (the kernels line's entry); (6) ``save_fleet`` of the per-rung
    fleet, ``restore_world`` of a 20k world onto the card with the
    audit: bit-equal to the lane's world at the save, then 10 steps of
    one K2 launch each, finite and >= 0, an empty audit; (4) the fused
    fleet's lanes readmitted into a ``fusion="auto"`` scheduler for 10
    steps: its sets and envelope; (5) phase 7's four worlds under
    ``FleetWarden(policy="heal", cadence=10, keep=2)``, with and without
    ``guard.inject_nan`` into world 2 after step 5: the poisoned world
    is tripped, evicted and readmitted from its stream, the other three
    bit-equal to the fault-free run; seconds per cadence save, the steps
    from the trip to eviction and readmission, the heal's restore
    seconds; no sentinel trip but the poisoned world's and no invariant
    flag but ``dead_param_residue`` (ROADMAP C3, on which the warden acts
    as on any trip);
24. serving (``magicsoup_tpu_torch.serve``): (a) ``FleetService(block=2,
    device="cuda")`` over loopback HTTP with two tenants at the headline
    shape (the Wood-Ljungdahl chemistry serialized into the spec, 128²,
    10,000 cells of 500 bp, fast mode, seeds 42 and 43, phase 7's
    selection at K = 1): 3 warm-up megasteps each, then one grant of 40
    megasteps each, timed from the grants until ``GET /tenants/<id>``
    shows both served (served world-steps/s), with exactly 1 dispatch, 1
    record fetch and 1 K2 launch per rung-group step (counted where the
    loop calls the scheduler); 20 single-megastep grants alternating
    tenants (grant-to-served p50 and p99); ``GET /accounting`` rows that
    sum to the megasteps served and conserve the process's fetch bytes
    and device time since the service started; two ``/metrics`` scrapes,
    every counter monotone, the tick and command-latency medians; after
    ``GET .../digest`` and the stop (drain, final checkpoints, registry)
    every world finite and >= 0, no flag but ``dead_param_residue`` (its
    trips per tenant); then a ``fusion="fleet"`` service with the two
    headline tenants and a chemistry-only 4,000-cell tenant on 64² (no
    kill, division or spawn, K = 1), 10 manual ticks after 3 warm-up
    ones: 1 dispatch, 1 fetch, 1 grouped launch and 0 K2 launches per
    step, accounting conserved; peak memory above the earlier phases'.  (b) the det schedule of
    ``performance/smoke.py --serve`` (t1 and t2 on 16², t3 on 8², 24
    cells of 200 bp, K = 2) through ``python -m magicsoup_tpu_torch.serve``
    children on the card: 3 fetches for 3 sequential single-megastep
    grants, each tenant re-attached after its checkpoint's flush without
    a rebuild (``attach_skipped``), under ``compile_budget`` 0 a cold spec refused with 429 and a
    warm one admitted and served with 0 compiles, rows that sum, SIGTERM
    exiting 0 with final checkpoints and a registry; a child killed with
    SIGKILL after the first half and its restart finish the schedule
    with digests bit-equal to the baseline's; the baseline's final
    checkpoints restored onto the CPU give the same ``state_digest``s,
    and its tenant digests the same, as the schedule run in process on
    the CPU;
25. meshes (``magicsoup_tpu_torch.parallel``): rank processes started by
    the run (``parallel.launch.RankPool``, every wait bounded) share the
    card.  (a) Two ranks over gloo, deterministic mode, at phase 13's
    500 cells on 64²: 10 classic workload steps and the stepper at K = 1
    (6 dispatches) and K = 4 (2), each final ``state_digest`` equal to
    the same run on one device on the card and on the CPU.  (b) The
    differential paths ``mesh2`` and ``token_mesh2`` ran in phase 21
    against the golden files and the CPU.  (c) The headline world over
    two ranks in fast mode (10,000 cells of 500 bp on 128², 64 map rows
    and 8192 of the 16384 slots per rank, seed 42): the first step's
    integrator output of each rank's slot block against the same world's
    on one device, every row bit-equal (the real-state contract read
    beside it); 20 classic steps, one
    K1 launch per rank per step; 60 stepper dispatches at K = 1 after 3
    warm-up ones, one launch per rank per step, every record's tile
    lanes summing to ``n_occupied``, no flag but ``dead_param_residue``;
    finite, >= 0 state; steps/s, collectives and bytes per step, host ms
    in collectives and each rank's peak memory.  (d) The world-sharded
    fleet: 4 worlds of one group over the two ranks, 10 fleet steps of
    ``fleet.sharding.sharded_fleet_step`` (its integrator left to the
    default) beside the unsharded group program, in fast mode (one K2
    launch per rank per fleet step) and in deterministic mode at 500
    cells, every leaf bit-equal (in fast mode the state and parameters,
    the records' mass lanes may differ).  (e) A one-rank NCCL mesh: a
    probe of the backend, then (a)'s runs, bit-equal to the single-device
    ones.  A ``{"meshes": ...}`` line; the mesh
    launches join the K1, K2 and threefry entries;
26. the analysis plane and the warm-up API (``magicsoup_tpu_torch.analysis``):
    (a) windows under ``hot_path_guard(compile_budget=0,
    transfers="disallow")`` at full width, with nothing dying, dividing,
    spawning or mutating (the JAX package's steady-state guard test): the
    string stepper at K = 1 and K = 4 (5 dispatches and ``drain()`` each
    after a warm-up), the 4-world fleet and a fused fleet of two 10k
    worlds on 128² and one on 256² (2 fleet steps and ``drain()`` each);
    each compiles nothing, synchronizes nowhere and launches K1/K2 once
    per simulated step (the fused one grouped once per fleet step), and an
    ``.item()`` inside a window raises while a sanctioned fetch passes;
    (b) the token stepper at K = 1 with phase 16's selection under
    ``transfers="log"``, its synchronizing calls counted by site (there
    must be none), then 5 more steps under ``hot_path_guard(0,
    "disallow")``; (c) in
    two fresh processes (``--warm-child``), a fresh 10k world's first
    activity cold, and after ``prewarm_activity()`` + ``wait_warm()``
    (state digest unchanged) under ``hot_path_guard(0)``, with their
    times; (d) ``integrate_signals_steps(..., 3, det=True)`` on 256 rows of
    the world's state, bit-equal to the CPU's; (e) ``python -m
    magicsoup_tpu_torch.analysis --check`` exits 0 (run beside the
    rest).  A ``{"analysis": ...}`` line; its launches join the K1, K2,
    grouped and threefry entries.
27. the measurement drivers (``magicsoup_tpu_torch.performance``) at the
    headline's width (10,000 cells, 128², Wood-Ljungdahl, 500-bp genomes,
    seed 42), each at a cut depth: ``python -m
    magicsoup_tpu_torch.performance.bench --config headline`` as a child
    process (its classic line, then its headline line with ``bench.py``'s
    keys plus ``"device"``, the value the faster driver's), then
    ``bench.main`` in this process (one K1 launch per classic step, one
    K2 launch per simulated step of the pipelined driver);
    ``run_simulation`` classic (30 steps) and ``--pipelined`` (10) under
    ``build/``, each final checkpoint restored on the card with the run's
    cell count; ``check --n 10000 --s 1000 --r 2 --json`` (the ops in the
    JAX order); ``profile_step --warmup 5 --steps 10``; ``megastep_sweep
    --ks 1,4 --steps 24``; ``fleet_sweep --bs 1,4,16 --ks 1,4`` (one group,
    one K2 launch per simulated step) and ``--mixed-rungs --rungs 2 --bs
    4`` (two K2 launches per simulated step per rung, one grouped launch
    fused); ``mesh_sweep --devices 1,2 --steps 16`` (two ranks sharing the
    card over gloo) and ``--check --devices 2`` (det, the mesh bit-equal
    to one device).  Each driver is called through its ``main(argv)``
    with the launch counts set to 0 just before; its rows must carry its
    JAX script's keys and its launches be one per step.  A ``{"drivers":
    ...}`` line with the phase's wall seconds; its launches join the K1,
    K2, grouped and threefry entries.
28. the assembly kernel (``ops/cuda_params.py``, ``csrc/assemble.cu``) at
    the classic path's shapes: 5, 400 and 10,000 rows of random tokens at
    rung (16, 4) into protein capacities 64 and 128 of a 10,240-row state,
    Wood-Ljungdahl's tables (s 28).  At each: the nine tensors bit-equal
    to the plain ``ops/params.py::assemble_rows`` on the card (whole
    state), one launch; the kernel's median time (CUDA events after a
    spin) and host time per launch, the plain version's time, its wall
    time per call and its device kernels per call, and the bound: the
    bytes written (16 + 12 s per protein slot of every row) and read (the
    tokens, the rows, and the table rows that each domain type reaches,
    row 0 of every table once) at 3.35 TB/s; the wall time of a whole
    call from the host batch (the pinned upload and the launch).  An
    ``{"assembly": ...}`` line; the kernel's entry joins the kernels
    line with its launches on every World path above: phases 2-5 and 15
    (the work, both backends, each launch and row matched against the
    ``assembly.*`` counters), 21 (each differential path), 22 (the
    classic world with a recorder), 25 (each rank of the headline mesh
    and of the det meshes), 26 (the guarded windows, and a guarded
    ``scatter_dense`` of 400 rows: one launch, no synchronization, no
    compile) and 27 (each driver).

Phases 10, 11 and 14 run right after the build, 15 after 5, 19 and 20
after 5 and after 15, 16 and 17 after 7, 12, 18, 13 and 21 after 9, 22,
23, 24 and 25 after them, then 26, 27 and 28.  Each phase's wall seconds are
printed when it ends, and all of them on one ``{"phase_seconds": ...}``
line.

With ``--parent DIR`` the run also builds an earlier version of the
integrator kernel and of the ladder from DIR (its ``magicsoup_tpu_torch/
ops/cuda_integrate.py`` and ``ops/cuda_bisect.py`` with ``csrc/
integrate.cu``, ``csrc/bisect.cu`` and the header they include, as ``git
show REV:...`` writes them) and, in phases 3, 4, 8 and 9, runs the
integrator beside this one on the same inputs: its error against the
plain version, its time (the two kernels timed in turns: earlier, this,
this, earlier) and its host time per launch; in phase 11 it times the
earlier ladder's rungs 1-11 in turns beside these at both ladder shapes,
with their errors against the plain versions.  Nothing of the earlier
version is held to a contract.

It prints a ``{"threefry": ...}`` line, a ``{"workload": ...}`` line and
a ``{"token_workload": ...}`` line, ``{"persistence": ...}`` and
``{"api": ...}`` lines for each, a ``{"stepper": ...}`` line, a
``{"fleet": ...}`` line (each with its token runs), a
``{"genome_ops": ...}`` line, the flags per window, the seeded and real-state
K2 lines, the digests, sweep, ladder, microbenchmark and det lines, a
``{"differential": ...}`` line, a ``{"guard": ...}`` line, a
``{"fused_fleet": ...}`` line, a ``{"serve": ...}`` line, a
``{"meshes": ...}`` line, an ``{"analysis": ...}`` line, a ``{"drivers":
...}`` line, the phases' seconds, the whole run's seconds, a ``{"kernels": [...]}`` line (K1, K2, the grouped launch, K3,
threefry, the assembly kernel), the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``.  Any failure raises, and the
run exits non-zero without that last line.  It needs one card.

    python3 chip_smoke.py [--dump DIR] [--parent DIR]
"""
import contextlib
import hashlib
import json
import math
import os
import random
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUN_T0 = time.perf_counter()
#: each phase's wall seconds, in the order they ran
_LAPS: dict[str, float] = {}
_LAP_T = [RUN_T0]


def _lap(name: str) -> None:
    """Close the wall-clock lap of phase ``name`` and print its seconds."""
    t = time.perf_counter()
    _LAPS[name] = round(t - _LAP_T[0], 3)
    _LAP_T[0] = t
    print(f"phase {name}: {_LAPS[name]:.3f} s", flush=True)

# H100 SXM, NVIDIA's data sheet: the f32 rate outside the tensor cores
# (the kernel's arithmetic is f32 on the CUDA cores); the memory rate is
# magicsoup_tpu_torch.performance.HBM_BYTES_PER_S
F32_FLOP_PER_S = 67e12

N_CELLS = 10_000
MAP_SIZE = 128
GENOME_SIZE = 500
SEED = 42
WARMUP_STEPS = 3
TIMED_BLOCKS = 1
BLOCK_STEPS = 40
PHASE_STEPS = 10
KERNEL_REPS = 25
PLAIN_REPS = 5
K2_WORLDS = 4
STEPPER_STEPS = 60
STEPPER_WARMUP = 3
FLEET_WORLDS = 4
FLEET_STEPS = 20
#: the digests' shapes: K1 at (q, p, s), K2 at (K2_WORLDS, rows, p, s)
DIGEST_K1 = (10240, 32, 28)
DIGEST_K2_ROWS = 16384
#: the sha256 of K1's and K2's output at those shapes.  The kernel with a
#: cell's proteins in parallel keeps the first version's bits: each lane
#: sums its protein's row in the order of that version's warp butterfly
#: (csrc/integrate_body.cuh::tree_sum), every other sum keeps its order,
#: and where the parameters live (the launch plan's route) changes no
#: bit.  A left-to-right order in each lane gave other bits (K1
#: a105d106...65ae, K2 f9b4cef4...be65) and fewer cells within 1e-4 of the
#: plain version on real state.  A change of the kernel that changes
#: these must say so here
DIGESTS = {
    "k1": "147a9114359d46602e8e7767eab036b108e7c2d7bb33b155ee12e2b6c591b09d",
    "k2": "75a4199feb8299f8e94a5be68c4e85600e258ff14a403d8fa67e6ba632b52f1a",
}
#: the shape sweep: (p, s) the package reaches (Wood-Ljungdahl's s 28,
#: the CO2-fixing chemistry's s 82; p doubling with genome length), at
#: SWEEP_CELLS cells, and the B = 3 stack's worlds, rows and stride
SWEEP_SHAPES = ((8, 20), (32, 28), (64, 28), (32, 82), (64, 82))
SWEEP_CELLS = 10240
SWEEP_STACK = (3, 1024, 1280)
#: host time per launch: launches enqueued back to back
HOST_LAUNCHES = 200
#: an earlier version of the integrator kernel and of the ladder, run
#: beside this one (``--parent DIR``)
PARENT = None
PARENT_LADDER = None
#: the ladder's shapes: the JAX ladder's defaults and the workload's
LADDER_SHAPES = ((256, 8, 12), (10240, 32, 28))
#: the microbenchmark's points
BENCH_POINTS = (("cuda", 1), ("cuda", 4), ("torch-fast", 1))
#: det mode on the card: scripts/bitrepro.py's defaults, the steps cut
#: from its 20 to 10 to keep the whole run within half its time limit
DET_STEPS = 10
DET_CELLS = 500
DET_MAP = 64
DET_GENOME = 300
DET_SEED = 7
DET_DISPATCHES = 10
#: det mode of a token world: the extra evolution after each step
DET_TOKEN_P_RECOMBINATION = 1e-5
DET_TOKEN_P_MUTATION = 1e-4
#: the threefry draws: the token store's shape at 10k cells, the
#: stepper's per-world shape, odd sizes
THREEFRY_STORE = (16384, 1024)
THREEFRY_WORLDS = (4, 16384)
THREEFRY_ODD = (1, 7, 1_000_003)
#: integer operations per element of one threefry hash: two key adds,
#: 20 rounds of add, rotate and xor, 5 key injections of three adds, and
#: the words' xor
THREEFRY_OPS = 2 + 20 * 3 + 5 * 3 + 1
#: the genome-ops microbenchmark's defaults
GENOME_OPS = dict(sizes=[1000, 8000, 40000], s=1000, r=5, p=1e-4, pb=1e-5, seed=0)
#: persistence: steps the restored world runs on, and where the files go
#: (a git-ignored directory of the checkout, removed afterwards)
PERSIST_STEPS = 10
PERSIST_DIR = ROOT / "build" / "chip_smoke_persistence"
#: phase 28: rows per call, protein capacities, the rung and the state's
#: rows of the assembly kernel's measurement
ASSEMBLY_ROWS = (5, 400, 10_000)
ASSEMBLY_P = (64, 128)
ASSEMBLY_RUNG = (16, 4)
ASSEMBLY_CAP = 10_240
#: the API phase: cells taken out with get_cell/kill_cells and added back
API_CELLS = 100
#: the differential harness: the golden files of the det paths and of
#: the fast-mode kernel path
GOLDEN_DIR = ROOT / "tests" / "fast" / "data" / "golden"
DIFF_GOLDEN = ("differential_seed11.json", "differential_seed23.json")
DIFF_CUDA_GOLDEN = "differential_pallas_seed11.json"
DIFF_FUSED_GOLDEN = "differential_fused2_seed11.json"
#: where the real-state checks save their worst tiles (``--dump DIR``)
DUMP_DIR = None
STEPPER_KW = dict(
    mol_name="ATP",
    kill_below=1.0,
    divide_above=5.0,
    divide_cost=4.0,
    target_cells=N_CELLS,
    genome_size=GENOME_SIZE,
    lag=2,
)


def _environment():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "magicsoup_tpu_torch" / "__init__.py").exists():
        sys.exit(f"chip_smoke: no magicsoup_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(ROOT))
    from magicsoup_tpu_torch.performance import card_line

    print(f"torch {torch.__version__}  python {sys.version.split()[0]}")
    print(f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    print(f"card {card_line()}")
    return torch


def _build():
    from magicsoup_tpu_torch.native import engine
    from magicsoup_tpu_torch.ops import cuda_bisect, cuda_integrate, cuda_params, cuda_prng

    t0 = time.perf_counter()
    builds = [cuda_integrate.build, cuda_bisect.build, cuda_prng.build, cuda_params.build]
    builds += [PARENT.build, PARENT_LADDER.build] if PARENT else []
    with ThreadPoolExecutor(max_workers=len(builds) + 1) as pool:
        kernels = [pool.submit(b) for b in builds]
        genome = pool.submit(engine.get_lib)
        lib_paths = [k.result() for k in kernels]
        if genome.result() is None:
            raise RuntimeError("the genome engine did not build")
    print(f"build {time.perf_counter() - t0:.3f} s  ({', '.join(p.name for p in lib_paths)})")
    for lib_path in lib_paths:
        print(Path(f"{lib_path}.log").read_text().strip())


def _load_parent(root: Path, module: str, source: str):
    """The earlier wrapper module ``ops/<module>.py`` from ``root`` (its
    kernel source ``csrc/<source>`` and the header beside it as in the
    package), under its own name: its library is named after its own
    sources, its launch count is its own."""
    import importlib.util

    path = root / "magicsoup_tpu_torch" / "ops" / f"{module}.py"
    csrc = path.parents[1] / "csrc"
    for need in (path, csrc / source, csrc / "integrate_body.cuh"):
        if not need.is_file():
            sys.exit(f"chip_smoke: --parent {root} has no {need.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(f"parent_{module}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fast_errors(out, ref) -> tuple[float, float, float]:
    """q99 and max relative error, and max absolute error, of ``out``
    against ``ref`` (numpy)."""
    import numpy as np

    diff = np.abs(out - ref)
    rel = diff / (np.abs(ref) + 1e-6)
    return float(np.quantile(rel, 0.99)), float(rel.max()), float(diff.max())


def _host_us(torch, fn) -> float:
    """Host microseconds per call of ``fn`` (one launch), over
    HOST_LAUNCHES calls enqueued back to back, ending before the
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_LAUNCHES):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / HOST_LAUNCHES * 1e6


def _beside_parent(torch, X, params, ref_np, reps: int = KERNEL_REPS) -> tuple[float, dict]:
    """This kernel's median time on (X, params) and, with ``--parent``,
    the earlier kernel's errors against ``ref_np``, its time and host time
    per launch, both kernels timed in turns (earlier, this, this,
    earlier)."""
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.performance import cuda_median_ms

    new = lambda: ci.integrate_signals_cuda(X, params)  # noqa: E731
    if PARENT is None:
        return cuda_median_ms(new, reps), {}
    old = lambda: PARENT.integrate_signals_cuda(X, params)  # noqa: E731
    out = old()
    torch.cuda.synchronize()
    q99, rel_max, abs_max = _fast_errors(out.cpu().numpy(), ref_np)
    times = [cuda_median_ms(f, reps) for f in (old, new, new, old)]
    return (times[1] + times[2]) / 2, {
        "ms": (times[0] + times[3]) / 2,
        "ms_in_turns": times,
        "q99_rel_err": q99,
        "max_rel_err": rel_max,
        "max_abs_err": abs_max,
        "host_us_per_launch": _host_us(torch, old),
    }


def _bisect_inputs(torch, c: int, p: int, s: int, seed: int):
    """Seeded inputs drawn as performance/pallas_bisect.py draws them,
    with the edge cases written into the first tiles."""
    import numpy as np

    from magicsoup_tpu_torch.interop import params_from_numpy

    rng = np.random.default_rng(seed)
    d = dict(
        Ke=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmf=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmb=rng.uniform(0.1, 10, (c, p)).astype(np.float32),
        Kmr=rng.uniform(0.1, 10, (c, p, s)).astype(np.float32),
        Vmax=rng.uniform(0, 2, (c, p)).astype(np.float32),
        N=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
        Nf=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        Nb=rng.integers(0, 3, (c, p, s)).astype(np.int16),
        A=rng.integers(-2, 3, (c, p, s)).astype(np.int16),
    )
    X = rng.uniform(0, 4, (c, s)).astype(np.float32)
    X[0] = 0.0  # all-zero signals
    d["A"][1] = 0
    d["A"][1, :, 0] = -2  # absent inhibitor
    X[1, 0] = 0.0
    d["A"][2] = 0
    d["A"][2, :, 0] = 2  # absent activator
    X[2, 0] = 0.0
    for k in d:  # dead rows
        d[k][8:16] = 0
    d["N"][16:24, :, 3] = np.abs(d["N"][16:24, :, 3])  # nothing removed
    return torch.from_numpy(X).cuda(), params_from_numpy(d, "cuda")


def _kernel_check(torch, q: int, p: int, s: int) -> dict:
    import numpy as np

    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.performance import cuda_median_ms
    from magicsoup_tpu_torch.ops.integrate import CellParams

    X, params = _bisect_inputs(torch, q, p, s, seed=0)
    X, params = X[None], CellParams(*(t[None] for t in params))
    out = ci.integrate_signals_cuda(X, params)[0]
    torch.cuda.synchronize()
    ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)[0]
    out_np, ref_np = out.cpu().numpy(), ref.cpu().numpy()
    if not (np.isfinite(out_np).all() and (out_np >= 0).all()):
        raise AssertionError("kernel output is not finite and >= 0")
    q99, rel_max, abs_max = _fast_errors(out_np, ref_np)
    if not (q99 < 1e-4 and rel_max < 0.15):
        raise AssertionError(f"kernel vs plain: q99 {q99}, max {rel_max}")
    if not np.array_equal(out_np[8:16], X[0, 8:16].cpu().numpy()):
        raise AssertionError("dead rows changed")

    ms, parent = _beside_parent(torch, X, params, ref_np)
    plain_ms = cuda_median_ms(
        lambda: ci.integrate_signals_tiled(X, params, ci.TILE_C), PLAIN_REPS
    )
    return {
        "name": "integrate_signals",
        "route": "cuda",
        "source": "magicsoup_tpu_torch/csrc/integrate.cu",
        "replaces": "magicsoup_tpu/ops/pallas_integrate.py:266",
        "shape": {"q": q, "p": p, "s": s},
        "plan": ci.plan(p, s)._asdict(),
        "seeded_max_abs_err": abs_max,
        "seeded_max_rel_err": rel_max,
        "seeded_q99_rel_err": q99,
        "ms": ms,
        "plain_ms": plain_ms,
        "host_us_per_launch": _host_us(torch, lambda: ci.integrate_signals_cuda(X, params)),
        **_bound(torch, X, params),
        "library_ms": None,
        **({"parent": parent} if parent else {}),
    }


def _dump_worst(X, params, out, ref, cells, norm, label: str, n: int = 4) -> None:
    """Save the tiles of the ``n`` cells that differ most from the plain
    version (inputs, kernel and plain outputs) to ``DUMP_DIR``, one
    ``.npz`` per check, for analysis off the card."""
    import numpy as np

    from magicsoup_tpu_torch.ops.cuda_integrate import TILE_C

    arrays = {}
    worst = np.argsort(-norm)[:n]
    tiles = sorted({(int(cells[i, 0]), int(cells[i, 1]) // TILE_C) for i in worst})
    for j, (w, t) in enumerate(tiles):
        rows = slice(t * TILE_C, (t + 1) * TILE_C)
        arrays[f"t{j}_where"] = np.array([w, t * TILE_C])
        arrays[f"t{j}_X"] = X[w, rows].cpu().numpy()
        arrays[f"t{j}_out"] = out[w, rows].cpu().numpy()
        arrays[f"t{j}_ref"] = ref[w, rows].cpu().numpy()
        for name, v in params._asdict().items():
            arrays[f"t{j}_{name}"] = v[w, rows].cpu().numpy()
    arrays["worst_cells"] = cells[worst]
    arrays["worst_norm"] = norm[worst]
    DUMP_DIR.mkdir(parents=True, exist_ok=True)
    slug = "".join(ch if ch.isalnum() else "_" for ch in label)
    np.savez(DUMP_DIR / f"{slug}.npz", **arrays)


def _cell_shares(X, params, active, out, ref) -> tuple[dict, object, object]:
    """The per-cell errors of ``out`` against the plain version ``ref`` on
    the ``active`` rows of ``X`` (B, q, s), as the real-state contract
    reads them (:func:`_real_state_check`), a cell beyond 0.25 of the
    plain version held to the det integrator on its tile on the CPU; and
    each active cell's error relative to its largest value, with its
    (world, row)."""
    import numpy as np

    from magicsoup_tpu_torch.ops.cuda_integrate import TILE_C
    from magicsoup_tpu_torch.ops.integrate import CellParams, integrate_signals

    cells = active.nonzero().cpu().numpy()
    out_np, ref_np = out[active].cpu().numpy(), ref[active].cpu().numpy()
    rel = np.abs(out_np - ref_np) / (np.abs(ref_np) + 1e-6)
    scale = np.maximum(np.abs(ref_np).max(axis=1), 1e-6)
    norm = np.abs(out_np - ref_np).max(axis=1) / scale
    far = np.nonzero(norm >= 0.25)[0]
    det_err = []
    for i in far:
        w, row = (int(v) for v in cells[i])
        rows = slice(row - row % TILE_C, row - row % TILE_C + TILE_C)
        det = integrate_signals(
            X[w, rows].cpu(), CellParams(*(t[w, rows].cpu() for t in params)), det=True
        )[row % TILE_C].numpy()
        det_err.append(float(np.abs(out_np[i] - det).max() / max(np.abs(det).max(), 1e-6)))
    return {
        "finite_nonneg": bool(np.isfinite(out_np).all() and (out_np >= 0).all()),
        "max_abs_err": float(np.abs(out_np - ref_np).max()),
        "cells_within_1e-4": float((rel.max(axis=1) < 1e-4).mean()),
        "cells_within_0.01": float((norm < 0.01).mean()),
        "max_cell_err": float(norm.max()),
        "cells_beyond_0.25": [[int(v) for v in cells[i]] for i in far],
        "their_err_vs_det": det_err,
        "q99_rel_err": float(np.quantile(rel, 0.99)),
        "max_rel_err": float(rel.max()),
    }, norm, cells


def _real_state_check(torch, X, params, active, label: str) -> dict:
    """The kernel against its plain version on state that a main path
    handed it: ``X`` (B, q, s) and its parameters, ``active`` (B, q) the
    rows under the per-cell real-state contract of ROADMAP C: finite and
    >= 0; at least 85% of them within 1e-4 relative, 98% within 0.01 of
    their largest value; all within 0.25.  A cell further than that from
    the plain version sits on a branch point of the equilibrium
    correction, where summation order picks the branch: it must land
    within 0.25 of the branch that the det integrator takes on the CPU on
    its tile of 8 cells (the kernel's early-stop unit), where the det
    integrator is bit-equal to the JAX package's.  The other rows must
    equal the plain version exactly.  With ``--parent``, the earlier
    kernel's shares on the same inputs are recorded beside."""
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    out = ci.integrate_signals_cuda(X, params)
    ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)
    if not torch.equal(out[~active], ref[~active]):
        raise AssertionError(f"{label}: inactive rows differ from the plain version")
    got, norm, cells = _cell_shares(X, params, active, out, ref)
    if not got.pop("finite_nonneg"):
        raise AssertionError(f"{label}: kernel output is not finite and >= 0")
    if DUMP_DIR is not None:
        _dump_worst(X, params, out, ref, cells, norm, label)
    if not (got["cells_within_1e-4"] >= 0.85 and got["cells_within_0.01"] >= 0.98
            and all(e < 0.25 for e in got["their_err_vs_det"])):
        raise AssertionError(
            f"{label}: {got['cells_within_1e-4']} of cells within 1e-4,"
            f" {got['cells_within_0.01']} within 0.01 of their largest value; the cells"
            f" beyond 0.25 of the plain version are {got['their_err_vs_det']} from the det one"
        )
    B, q, s = X.shape
    got = {
        "shape": {"B": B, "q": q, "p": params.Ke.shape[-1], "s": s,
                  "world_stride": params.Ke.stride(0) // params.Ke[0, 0].numel()},
        "active_rows": int(active.sum()),
        **got,
    }
    if PARENT is not None:
        got["parent"] = _cell_shares(
            X, params, active, PARENT.integrate_signals_cuda(X, params), ref
        )[0]
    return got


def _world_kernel_check(torch, world) -> dict:
    """K1 against its plain version on the signals and parameters that
    the world's next workload step hands the integrator; its live rows
    under the real-state contract, the dead rows past them inert."""
    from magicsoup_tpu_torch.ops.integrate import CellParams

    X, params = world.integrator_inputs()
    X, params = X[None], CellParams(*(t[None] for t in params))
    live = torch.arange(X.shape[1], device=X.device)[None] < world.n_cells
    got = _real_state_check(torch, X, params, live, "K1 on the world's state")
    keys = ("max_abs_err", "cells_within_1e-4", "cells_within_0.01", "max_cell_err",
            "cells_beyond_0.25", "their_err_vs_det", "q99_rel_err", "parent")
    return {
        "world_shape": {"q": X.shape[1], "n_cells": world.n_cells, "p": params.Ke.shape[-1]},
        **{f"world_{k}": got[k] for k in keys if k in got},
    }


def _workload(torch, seed: int = SEED, genome_backend: str = "string",
              n_cells: int = N_CELLS, map_size: int = MAP_SIZE):
    """A world of the main paths, with its cells spawned."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY

    rng = random.Random(seed)
    t0 = time.perf_counter()
    world = mt.World(chemistry=CHEMISTRY, map_size=map_size, seed=seed,
                     genome_backend=genome_backend)
    world.spawn_cells(
        [mt.random_genome(s=GENOME_SIZE, rng=rng) for _ in range(n_cells)]
    )
    torch.cuda.synchronize()
    spawn_s = time.perf_counter() - t0
    if world.integrator != "cuda" or world.device.type != "cuda":
        raise AssertionError(f"world runs {world.integrator} on {world.device}")
    store = world.genome_store
    if (store is not None) != (genome_backend == "token") or (
        store is not None and store.tokens.device.type != "cuda"
    ):
        raise AssertionError(f"a {genome_backend} world's genome store is {store}")
    return world, spawn_s


def _run_steps(torch, world) -> dict:
    """The main path: warm-up, timed and phase-timed workload steps, with
    the kernels' launch counts set to 0 just before and read right after;
    the token store's host fetches and decodes are counted too, and the
    assembly kernel's launches and rows against the ``assembly.*``
    counters."""
    import numpy as np

    from magicsoup_tpu_torch import telemetry
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_params, cuda_prng
    from magicsoup_tpu_torch.workload import sim_step

    atp = world.chemistry.molname_2_idx["ATP"]
    rng = random.Random(SEED + 1)
    phases: dict[str, float] = {}

    class _Timer:
        def __init__(self, label):
            self.label = label

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            dt = time.perf_counter() - self.t0
            phases[self.label] = phases.get(self.label, 0.0) + dt

    def step(**kw):
        sim_step(
            world, rng, n_cells=N_CELLS, genome_size=GENOME_SIZE, atp_idx=atp, **kw
        )

    genome0 = runtime.genome_stats()
    counters0 = telemetry.counter_totals()
    ci.launches = 0
    cuda_prng.launches = 0
    cuda_params.launches = 0
    for _ in range(WARMUP_STEPS):
        step(sync=False)
    torch.cuda.synchronize()
    # steps/s: no barrier inside a block (the next step's ATP fetch is the
    # only wait, as in bench.py), one at its end
    block_s = []
    timed0 = (runtime.genome_stats(), world.phenotypes.misses)
    for _ in range(TIMED_BLOCKS):
        t0 = time.perf_counter()
        for _ in range(BLOCK_STEPS):
            step(sync=False)
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - t0)
    timed1 = (runtime.genome_stats(), world.phenotypes.misses)
    # seconds per phase: a separate pass with every phase synchronized
    for _ in range(PHASE_STEPS):
        step(timeit=_Timer)
    launches = ci.launches
    threefry_launches = cuda_prng.launches
    assembly_launches = cuda_params.launches
    genome1 = runtime.genome_stats()
    counters1 = telemetry.counter_totals()
    assembly = {k: counters1.get(f"assembly.{k}", 0) - counters0.get(f"assembly.{k}", 0)
                for k in ("rows", "kernel_rows", "launches")}

    n_steps = WARMUP_STEPS + TIMED_BLOCKS * BLOCK_STEPS + PHASE_STEPS
    if launches != n_steps:
        raise AssertionError(f"{launches} kernel launches in {n_steps} steps")
    if not (0 < assembly_launches == assembly["launches"]
            and 0 < assembly["rows"] == assembly["kernel_rows"]):
        raise AssertionError(f"{assembly_launches} assembly launches in {n_steps} steps,"
                             f" counters {assembly}")
    token = world.genome_store is not None
    if (threefry_launches > 0) != token:
        raise AssertionError(f"{threefry_launches} threefry launches in a"
                             f" {world.genome_backend} world")
    decoded = timed1[0]["genome_decode_rows"] - timed0[0]["genome_decode_rows"]
    misses = timed1[1] - timed0[1]
    if token and decoded != misses:
        raise AssertionError(f"{decoded} genome rows decoded for {misses} cache misses")
    cm = world.cell_molecules
    mm = world.molecule_map.cpu().numpy()
    for name, arr in (("cell_molecules", cm), ("molecule_map", mm)):
        if not (np.isfinite(arr).all() and (arr >= 0).all()):
            raise AssertionError(f"{name} is not finite and >= 0")
    if world.n_cells <= 0:
        raise AssertionError("no cells left")
    timed = TIMED_BLOCKS * BLOCK_STEPS
    return {
        "steps": n_steps,
        "launches": launches,
        "timed_steps": timed,
        "steps_per_s": timed / sum(block_s),
        "block_steps_per_s": [BLOCK_STEPS / t for t in block_s],
        "phase_steps": PHASE_STEPS,
        "phase_s_per_step": {k: v / PHASE_STEPS for k, v in phases.items()},
        "n_cells": world.n_cells,
        "capacity": world._capacity,
        "genome_backend": world.genome_backend,
        "threefry_launches": threefry_launches,
        "threefry_launches_per_step": threefry_launches / n_steps,
        "assembly_launches": assembly_launches,
        "assembly_launches_per_step": assembly_launches / n_steps,
        "assembly_rows_per_step": assembly["rows"] / n_steps,
        "store_fetches_per_step": (genome1["genome_fetches"] - genome0["genome_fetches"]) / n_steps,
        "store_fetch_bytes_per_step": (genome1["genome_fetch_bytes"]
                                       - genome0["genome_fetch_bytes"]) / n_steps,
        "timed_genome_decode_rows": decoded,
        "timed_cache_misses": misses,
        "store_shape": (list(world.genome_store.tokens.shape) if token else None),
    }


def _check_state(world, label: str) -> None:
    import numpy as np

    if world.n_cells <= 0:
        raise AssertionError(f"{label}: no cells left")
    for name, arr in (
        ("cell_molecules", world.cell_molecules),
        ("molecule_map", world.molecule_map.cpu().numpy()),
    ):
        if not (np.isfinite(arr).all() and (arr >= 0).all()):
            raise AssertionError(f"{label}: {name} is not finite and >= 0")


def _correction_steps(torch, X, params) -> tuple[float, float]:
    """The equilibrium correction's work on these inputs: per tile and
    trim pass, the mean number of quotient evaluations (1-4) and of
    updates (0-4) that the kernel's body runs before its tile's vote
    stops it, counted on the plain version's trim passes (X (B, q, s))."""
    from magicsoup_tpu_torch.ops import integrate as ti
    from magicsoup_tpu_torch.ops.cuda_integrate import TILE_C

    def tiles(t):
        return ti.group_rows(t.reshape((-1,) + tuple(t.shape[2:])), TILE_C)

    prm = ti.CellParams(*(tiles(t) for t in params))
    X0 = tiles(X)
    evals = updates = 0
    for trim in ti.TRIM_FACTORS:
        V = ti._velocities(X0, torch.clamp(prm.Vmax * trim, min=0.0), prm, det=False)
        W = V * ti._negative_factors(X0, prm.N, V, det=False)
        X1 = torch.clamp(ti._weighted_dx(X0, prm.N, W, det=False), min=0.0)
        F = torch.ones_like(V)
        fwd = V > 0.0
        live = torch.ones((V.shape[0], 1, 1), dtype=torch.bool, device=V.device)
        for inc in ti.INCREMENTS:
            evals += int(live.sum())
            QKe = ti._quotient(X1, prm, det=False) / prm.Ke
            low = torch.where(fwd, QKe < ti.LOWER_THRESH, QKe > ti.UPPER_THRESH) & ~(fwd & (F == 1.0))
            high = torch.where(fwd, QKe > ti.UPPER_THRESH, QKe < ti.LOWER_THRESH) & ~(~fwd & (F == 0.0))
            live = live & ((low | high) & (V.abs() > 0.1)).any(-1, keepdim=True).any(-2, keepdim=True)
            updates += int(live.sum())
            F = torch.where(live & high, F - inc, F)
            F = torch.clamp(torch.where(live & low, F + inc, F), 0.0, 1.0)
            X_new = torch.clamp(ti._weighted_dx(X0, prm.N, W * F, det=False), min=0.0)
            X1 = torch.where(live, X_new, X1)
        X0 = X1
    n = X0.shape[0] * len(ti.TRIM_FACTORS)
    return evals / n, updates / n


def _bound(torch, X, params) -> dict:
    """The least time of one integrator step on ``X`` (B, q, s) and its
    parameters: the larger of the byte time and the operation time.

    Bytes: read X and the nine parameter tensors once, write X1:
    ``B q (16p + 12ps + 8s)``, at HBM_BYTES_PER_S.

    Operations: the f32 operations of ``csrc/integrate_body.cuh`` on these
    inputs, at F32_FLOP_PER_S, counting as one each exact i16 widening
    (i2f: one add), add, multiply, compare, select and NaN-keeping
    min/max/clip, and each expf, logf and division too (they take several
    on the card, so the count is a floor).  Per trim pass (3):

    - per (cell, protein, signal): the velocities' two log-space sums,
      2 x (widen, multiply, add) = 6; the regulation factor for each
      nonzero A (``a``, the inputs' share of nonzero A): widen, multiply,
      min, expf, add, division, NaN test, compare, logf, add = 10; the
      negative guard's removed amounts (widen, multiply, negate, max,
      add = 5) and its min (widen, multiply, compare, select, min = 5);
      the first update (widen, multiply, add = 3); then per quotient
      evaluation of the correction its two log-space sums (6) and per
      update its weighted sum (3): ``19 + 10 a + 6 e + 3 u``, with ``e``
      and ``u`` the evaluations and updates per tile and pass that these
      inputs run (:func:`_correction_steps`);
    - per (cell, protein): the velocities' tail (3 expf, 3 divisions, 2
      Inf tests, 4 selects, 2 Inf scrubs, 3 adds, 4 multiplies or
      max, a clip) = 21 with the guard's ``W = V m``; per evaluation the
      quotient's tail (2 expf with their Inf tests and selects, 2
      divisions, a clip, a NaN test, 9 compares) = 19; per update the
      factor's (2 adds, a clip, a multiply) = 4: ``21 + 19 e + 4 u``;
    - per (cell, signal): the velocities' log X (compare, min, logf,
      select = 4), the guard's factor (division, compare, select = 3), the
      update's add and clamp (2), per evaluation the log X (4), per update
      the add and clamp (2): ``9 + 4 e + 2 u``.
    """
    from magicsoup_tpu_torch.performance import HBM_BYTES_PER_S

    B, q, s = X.shape
    p = params.Ke.shape[-1]
    n_rows = B * q
    n_bytes = n_rows * (16 * p + 12 * p * s + 8 * s)
    a = float(params.A.ne(0).float().mean())
    e, u = _correction_steps(torch, X, params)
    per_pass = (
        p * s * (19 + 10 * a + 6 * e + 3 * u)
        + p * (21 + 19 * e + 4 * u)
        + s * (9 + 4 * e + 2 * u)
    )
    n_ops = 3 * n_rows * per_pass
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes,
        "bytes_ms": bytes_ms,
        "operations": n_ops,
        "operations_ms": ops_ms,
        "a_nonzero_share": a,
        "correction_evals_per_pass": e,
        "correction_updates_per_pass": u,
    }


def _k2_stack(torch, rows: int, p: int, s: int):
    """Seeded inputs of K2_WORLDS worlds of ``rows`` rows each, stacked."""
    from magicsoup_tpu_torch.ops.integrate import CellParams

    worlds = [_bisect_inputs(torch, rows, p, s, seed=10 + w) for w in range(K2_WORLDS)]
    X = torch.stack([x for x, _ in worlds])
    return X, CellParams(*(torch.stack(ts) for ts in zip(*(pp for _, pp in worlds))))


def _k2_seeded(torch, X_stack, stack, q: int) -> dict:
    """K2 on seeded inputs: each world the q-row prefix of a stack (the
    world stride is the stack's rows), against its plain version under
    the fast contract; each world of the launch bit-equal to its own
    B = 1 launch; median times over 25 launches and the plain version's."""
    import numpy as np

    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.performance import cuda_median_ms
    from magicsoup_tpu_torch.ops.integrate import CellParams

    B, rows, s = X_stack.shape
    p = stack.Ke.shape[-1]
    X = X_stack[:, :q].contiguous()
    params = CellParams(*(t[:, :q] for t in stack))
    out = ci.integrate_signals_cuda(X, params)
    torch.cuda.synchronize()
    ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)
    out_np, ref_np = out.cpu().numpy(), ref.cpu().numpy()
    if not (np.isfinite(out_np).all() and (out_np >= 0).all()):
        raise AssertionError(f"K2 at q {q}: output is not finite and >= 0")
    q99, rel_max, abs_max = _fast_errors(out_np, ref_np)
    if not (q99 < 1e-4 and rel_max < 0.15):
        raise AssertionError(f"K2 at q {q} vs plain: q99 {q99}, max {rel_max}")
    for w in range(B):
        solo = ci.integrate_signals_cuda(
            X[w : w + 1].contiguous(), CellParams(*(t[w : w + 1] for t in params))
        )
        if not torch.equal(solo[0], out[w]):
            raise AssertionError(f"K2 at q {q}: world {w} differs from its B = 1 launch")
    ms, parent = _beside_parent(torch, X, params, ref_np)
    plain_ms = cuda_median_ms(
        lambda: ci.integrate_signals_tiled(X, params, ci.TILE_C), PLAIN_REPS
    )
    return {
        "shape": {"B": B, "q": q, "world_stride": rows, "p": p, "s": s},
        "max_abs_err": abs_max,
        "max_rel_err": rel_max,
        "q99_rel_err": q99,
        "worlds_bit_equal_to_solo_launch": True,
        "ms": ms,
        "plain_ms": plain_ms,
        **_bound(torch, X, params),
        **({"parent": parent} if parent else {}),
    }


def _k2_real_state(torch, inputs, label: str) -> dict:
    """K2 on the inputs a main path handed it (a copy taken in its timed
    window): the real-state contract on the rows with any protein (any
    nonzero Vmax), the kernel's median time over 25 launches on them and
    the plain version's."""
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.performance import cuda_median_ms

    X, params = inputs
    active = params.Vmax.ne(0).any(-1)
    got = _real_state_check(torch, X, params, active, label)
    if PARENT is None:
        got["ms"] = cuda_median_ms(lambda: ci.integrate_signals_cuda(X, params), KERNEL_REPS)
    else:
        times = [cuda_median_ms(f, KERNEL_REPS) for f in (
            lambda: PARENT.integrate_signals_cuda(X, params),
            lambda: ci.integrate_signals_cuda(X, params),
            lambda: ci.integrate_signals_cuda(X, params),
            lambda: PARENT.integrate_signals_cuda(X, params),
        )]
        got["ms"] = (times[1] + times[2]) / 2
        got["parent"].update(ms=(times[0] + times[3]) / 2, ms_in_turns=times)
    got["plain_ms"] = cuda_median_ms(
        lambda: ci.integrate_signals_tiled(X, params, ci.TILE_C), PLAIN_REPS
    )
    got.update(_bound(torch, X, params))
    return got


class _Taps:
    """Taps on the stepper's and the fleet's paths, read after a window:

    - a copy of the integrator's inputs at its first call after
      :meth:`arm` (the copy launches no kernel);
    - the invariant and health flag names of every tripped record that
      the host replays, counted per window (``window`` names the phase
      under way).
    """

    def __init__(self):
        self.window = "setup"
        self.flags: dict[str, dict[str, int]] = {}
        self.inputs = None
        self._armed = False
        self._undo = []

    def arm(self) -> None:
        self._armed, self.inputs = True, None

    def unexpected(self) -> list:
        """Flags other than dead_param_residue, which the reference trips
        as well (ROADMAP C)."""
        return sorted(
            {f for counts in self.flags.values() for f in counts}
            - {"invariant:dead_param_residue"}
        )

    def _tally(self, kind: str, decoded: dict) -> None:
        counts = self.flags.setdefault(self.window, {})
        for name, on in decoded.items():
            if on:
                key = f"{kind}:{name}"
                counts[key] = counts.get(key, 0) + 1

    def __enter__(self):
        from magicsoup_tpu_torch.check.invariants import decode_invariants
        from magicsoup_tpu_torch.guard.sentinel import decode_health
        from magicsoup_tpu_torch.ops import backends
        from magicsoup_tpu_torch.ops.integrate import CellParams
        from magicsoup_tpu_torch.stepper import PipelinedStepper

        taps = self
        integrate = backends.integrate
        on_invariant = PipelinedStepper.__dict__["_handle_invariant"]
        on_sentinel = PipelinedStepper.__dict__["_handle_sentinel"]

        def tapped_integrate(name, X, params, mesh=None):
            if taps._armed and X.ndim == 3:
                taps._armed = False
                taps.inputs = (X.clone(), CellParams(*(t.clone() for t in params)))
            return integrate(name, X, params, mesh)

        def tapped_invariant(stepper, out):
            taps._tally("invariant", decode_invariants(out.invariants))
            return on_invariant(stepper, out)

        def tapped_sentinel(stepper, out):
            taps._tally("health", decode_health(out.health))
            return on_sentinel(stepper, out)

        self._undo = [
            (backends, "integrate", integrate),
            (PipelinedStepper, "_handle_invariant", on_invariant),
            (PipelinedStepper, "_handle_sentinel", on_sentinel),
        ]
        backends.integrate = tapped_integrate
        PipelinedStepper._handle_invariant = tapped_invariant
        PipelinedStepper._handle_sentinel = tapped_sentinel
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self._undo:
            setattr(obj, name, orig)


PROFILE_STEPS = 10


def _profile(torch, run, n_steps: int) -> dict:
    """``run()`` (n_steps simulated steps, ending in a drain) under
    ``torch.profiler``: wall seconds; the card's kernel time per step and
    its busy share of the wall time (kernels only: the ``ms:*`` ranges
    also appear on the device timeline, as spans that include the waits
    for the host, and are left out); host milliseconds per step in each
    ``ms:*`` phase range of the step body (inflated by the profiler's own
    overhead); and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict[str, list] = {}
    phases: dict[str, float] = {}
    for e in prof.events():
        on_device = str(e.device_type).endswith("CUDA")
        us = e.time_range.elapsed_us()
        if e.name.startswith("ms:"):
            if not on_device:
                phases[e.name] = phases.get(e.name, 0.0) + us / 1e3 / n_steps
        elif on_device:
            k = kernels.setdefault(e.name[:90], [0.0, 0])
            k[0] += us
            k[1] += 1
    device_us = sum(k[0] for k in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    most = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    return {
        "steps": n_steps,
        "wall_s": wall,
        "device_ms_per_step": device_us / 1e3 / n_steps,
        "device_busy_share": device_us / 1e6 / wall,
        "kernel_launches_per_step": sum(k[1] for k in kernels.values()) / n_steps,
        "host_phase_ms_per_step": phases,
        "top_kernels": [
            {"name": name, "device_ms_per_step": us / 1e3 / n_steps,
             "launches_per_step": n / n_steps}
            for name, (us, n) in top
        ],
        "most_launched": [
            {"name": name, "launches_per_step": n / n_steps} for name, (_, n) in most
        ],
    }


def _stepper_run(torch, taps: _Taps, k: int, capture: bool,
                 genome_backend: str = "string") -> dict:
    """The pipelined stepper at full width, megastep k; with ``capture``,
    ``taps`` keeps the integrator's inputs of the timed window's first
    step.  A token world's dispatch is not checked for being sync-free:
    a riding refresh reads the store's host snapshot, as in the JAX
    package."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_prng

    world, spawn_s = _workload(torch, genome_backend=genome_backend)
    token = genome_backend == "token"
    label = f"{'token ' if token else ''}stepper K{k}"
    torch.cuda.reset_peak_memory_stats()
    taps.window = f"{label} warm-up"
    st = mt.PipelinedStepper(world, megastep=k, **STEPPER_KW)
    for _ in range(STEPPER_WARMUP):
        st.step()
    st.drain()
    if not token:
        # one dispatch with the fetcher idle: enqueueing must not synchronize
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        st.drain()
    torch.cuda.synchronize()
    stats0 = dict(st.stats)
    taps.window = f"{label} timed"
    if capture:
        taps.arm()
    genome0 = runtime.genome_stats()
    ci.launches = 0
    cuda_prng.launches = 0
    t0 = time.perf_counter()
    for _ in range(STEPPER_STEPS // k):
        st.step()
    st.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ci.launches
    threefry_launches = cuda_prng.launches
    genome1 = runtime.genome_stats()
    if launches != STEPPER_STEPS:
        raise AssertionError(f"{label}: {launches} K2 launches in {STEPPER_STEPS} steps")
    if threefry_launches == 0:
        raise AssertionError(f"{label}: no threefry launch")
    window = {key: st.stats[key] - stats0[key] for key in st.stats}

    def _more():
        for _ in range(PROFILE_STEPS // k):
            st.step()
        st.drain()

    taps.window = f"{label} profiled"
    prof = _profile(torch, _more, PROFILE_STEPS)
    taps.window = f"{label} flush"
    st.flush()
    _check_state(world, label)
    return {
        "genome_backend": genome_backend,
        "megastep": k,
        "timed_steps": STEPPER_STEPS,
        "steps_per_s": STEPPER_STEPS / dt,
        "launches": launches,
        "threefry_launches": threefry_launches,
        "threefry_launches_per_step": threefry_launches / STEPPER_STEPS,
        "store_fetches_per_step": (genome1["genome_fetches"]
                                   - genome0["genome_fetches"]) / STEPPER_STEPS,
        "genome_decode_rows": genome1["genome_decode_rows"] - genome0["genome_decode_rows"],
        "window_s": dt,
        # host seconds per simulated step in the window: enqueueing the
        # dispatches, blocked on record fetches, and the whole step() calls
        "dispatch_s_per_step": window["dispatch_ms"] / 1e3 / STEPPER_STEPS,
        "fetch_wait_s_per_step": window["fetch_ms"] / 1e3 / STEPPER_STEPS,
        "step_call_s_per_step": window["step_ms"] / 1e3 / STEPPER_STEPS,
        "sync_free_dispatch": True if not token else "not checked",
        "profile": prof,
        "stats": {key: st.stats[key] for key in st.stats},
        "n_cells": world.n_cells,
        "capacity": world._capacity,
        "spawn_s": spawn_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def _fleet_run(torch, taps: _Taps, genome_backend: str = "string") -> dict:
    """Four worlds as one rung group of a FleetScheduler; ``taps`` keeps
    the integrator's inputs of the timed window's first fleet step."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_prng

    worlds = [_workload(torch, seed=SEED + i, genome_backend=genome_backend)[0]
              for i in range(FLEET_WORLDS)]
    label = "token fleet" if genome_backend == "token" else "fleet"
    torch.cuda.reset_peak_memory_stats()
    taps.window = f"{label} warm-up"
    fleet = mt.FleetScheduler(block=FLEET_WORLDS)
    for w in worlds:
        fleet.admit(w, megastep=1, **STEPPER_KW)
    fleet.step()
    fleet.drain()
    torch.cuda.synchronize()
    taps.window = f"{label} timed"
    taps.arm()
    runtime.reset_counters()
    ci.launches = 0
    cuda_prng.launches = 0
    t0 = time.perf_counter()
    for _ in range(FLEET_STEPS):
        fleet.step()
    fleet.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ci.launches
    threefry_launches = cuda_prng.launches
    census = runtime.snapshot()
    genome = runtime.genome_stats()
    if launches != FLEET_STEPS:
        raise AssertionError(f"{label}: {launches} K2 launches in {FLEET_STEPS} fleet steps")
    if census.get("dispatches") != FLEET_STEPS:
        raise AssertionError(f"{label}: dispatch census {census}")
    if threefry_launches == 0:
        raise AssertionError(f"{label}: no threefry launch")

    def _more():
        for _ in range(PROFILE_STEPS):
            fleet.step()
        fleet.drain()

    taps.window = f"{label} profiled"
    prof = _profile(torch, _more, PROFILE_STEPS)
    taps.window = f"{label} flush"
    fleet.flush()
    for i, w in enumerate(worlds):
        _check_state(w, f"{label} world {i}")
    return {
        "genome_backend": genome_backend,
        "worlds": FLEET_WORLDS,
        "threefry_launches": threefry_launches,
        "threefry_launches_per_fleet_step": threefry_launches / FLEET_STEPS,
        "store_fetches_per_fleet_step": genome["genome_fetches"] / FLEET_STEPS,
        "genome_decode_rows": genome["genome_decode_rows"],
        "timed_fleet_steps": FLEET_STEPS,
        "steps_per_s_per_world": FLEET_STEPS / dt,
        "steps_per_s_aggregate": FLEET_WORLDS * FLEET_STEPS / dt,
        "launches": launches,
        "census": census,
        "profile": prof,
        "window_s": dt,
        "n_cells": [w.n_cells for w in worlds],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def _sha256(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _digests(torch) -> dict:
    """The sha256 of K1's output on the seeded inputs at DIGEST_K1 and of
    K2's on K2_WORLDS stacked worlds of DIGEST_K2_ROWS rows; each must
    equal its entry of DIGESTS."""
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops.integrate import CellParams

    q, p, s = DIGEST_K1
    X, params = _bisect_inputs(torch, q, p, s, seed=0)
    X_stack, stack = _k2_stack(torch, DIGEST_K2_ROWS, p, s)
    runs = {
        "k1": ({"q": q, "p": p, "s": s}, X[None], CellParams(*(t[None] for t in params))),
        "k2": ({"B": K2_WORLDS, "q": DIGEST_K2_ROWS, "p": p, "s": s}, X_stack, stack),
    }
    out = {}
    for key, (shape, X_, params_) in runs.items():
        got = ci.integrate_signals_cuda(X_, params_)
        torch.cuda.synchronize()
        out[key] = {"shape": shape, "sha256": _sha256(got)}
    wrong = {key: v["sha256"] for key, v in out.items() if v["sha256"] != DIGESTS[key]}
    if wrong:
        raise AssertionError(f"integrator output digests changed: {wrong}, want {DIGESTS}")
    return out


def _sweep(torch) -> dict:
    """The kernel at every (p, s) of SWEEP_SHAPES on seeded inputs of
    SWEEP_CELLS cells, against its plain version under the fast contract,
    dead rows unchanged, with the launch plan's route, the kernel's median
    time and its byte bound; then a B = 3 stack at the largest shape,
    each world the prefix of a longer block (world stride > rows), each
    world bit-equal to its own launch."""
    import numpy as np

    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops.integrate import CellParams
    from magicsoup_tpu_torch.performance import HBM_BYTES_PER_S, cuda_median_ms

    limit = ci.smem_limit(0)
    shapes = []
    for p, s in SWEEP_SHAPES:
        X, params = _bisect_inputs(torch, SWEEP_CELLS, p, s, seed=p + s)
        X, params = X[None], CellParams(*(t[None] for t in params))
        out = ci.integrate_signals_cuda(X, params)[0].cpu().numpy()
        ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)[0].cpu().numpy()
        q99, rel_max, abs_max = _fast_errors(out, ref)
        if not (np.isfinite(out).all() and (out >= 0).all() and q99 < 1e-4 and rel_max < 0.15):
            raise AssertionError(f"sweep at p {p}, s {s}: q99 {q99}, max {rel_max}")
        if not np.array_equal(out[8:16], X[0, 8:16].cpu().numpy()):
            raise AssertionError(f"sweep at p {p}, s {s}: dead rows changed")
        plan = ci.launch_plan(p, s, limit)
        ms = cuda_median_ms(lambda: ci.integrate_signals_cuda(X, params), KERNEL_REPS)
        bytes_ms = SWEEP_CELLS * (16 * p + 12 * p * s + 8 * s) / HBM_BYTES_PER_S * 1e3
        shapes.append({"p": p, "s": s, "c": SWEEP_CELLS, "route": plan.route,
                       "resident": list(plan.resident), "smem_bytes": plan.smem_bytes,
                       "ms": ms, "bytes_bound_ms": bytes_ms,
                       "q99_rel_err": q99, "max_rel_err": rel_max, "max_abs_err": abs_max})
        print(f"sweep p {p:3d} s {s:3d}: route {plan.route} ({', '.join(plan.resident) or 'none'}"
              f" resident, {plan.smem_bytes} B), {ms:.4f} ms (bytes {bytes_ms:.4f} ms),"
              f" q99 {q99:.3g}, max {rel_max:.3g}", flush=True)

    B, q, rows = SWEEP_STACK
    p, s = SWEEP_SHAPES[-1]
    del X, params
    worlds = [_bisect_inputs(torch, rows, p, s, seed=100 + w) for w in range(B)]
    X = torch.stack([x[:q] for x, _ in worlds])
    params = CellParams(*(torch.stack(ts)[:, :q] for ts in zip(*(pp for _, pp in worlds))))
    out = ci.integrate_signals_cuda(X, params)
    ref = ci.integrate_signals_tiled(X, params, ci.TILE_C)
    q99, rel_max, abs_max = _fast_errors(out.cpu().numpy(), ref.cpu().numpy())
    if not (q99 < 1e-4 and rel_max < 0.15):
        raise AssertionError(f"sweep stack: q99 {q99}, max {rel_max}")
    for w in range(B):
        solo = ci.integrate_signals_cuda(X[w : w + 1].contiguous(),
                                         CellParams(*(t[w : w + 1] for t in params)))
        if not torch.equal(solo[0], out[w]):
            raise AssertionError(f"sweep stack: world {w} differs from its own launch")
    stack = {"B": B, "q": q, "world_stride": rows, "p": p, "s": s,
             "route": ci.launch_plan(p, s, limit).route, "q99_rel_err": q99,
             "max_rel_err": rel_max, "max_abs_err": abs_max,
             "worlds_bit_equal_to_solo_launch": True}
    print(f"sweep stack {B} x {q} of {rows} rows at p {p}, s {s}: worlds bit-equal to their"
          f" own launches, q99 {q99:.3g}, max {rel_max:.3g}", flush=True)
    return {"shapes": shapes, "stack": stack}


def _ladder(torch) -> dict:
    """K3 at LADDER_SHAPES: every rung must hold its plain version; the
    ladder kernels' launch count over the two runs; with ``--parent``,
    the earlier ladder's rungs 1-11 timed beside these."""
    from magicsoup_tpu_torch.ops import cuda_bisect as cb
    from magicsoup_tpu_torch.performance.kernel_bisect import run_ladder

    runs = {}
    cb.launches = 0
    for c, p, s in LADDER_SHAPES:
        rows, ok = run_ladder(c, p, s, device="cuda")
        if not ok:
            raise AssertionError(f"ladder at {c} x {p} x {s}: {[r for r in rows if not r['ok']]}")
        runs[f"{c}x{p}x{s}"] = rows
    launches = cb.launches
    if launches == 0:
        raise AssertionError("the ladder launched no kernel")
    got = {"runs": runs, "launches": launches}
    if PARENT_LADDER is not None:
        got["parent"] = {f"{c}x{p}x{s}": _ladder_beside_parent(torch, c, p, s)
                         for c, p, s in LADDER_SHAPES}
    return got


def _ladder_beside_parent(torch, c: int, p: int, s: int) -> dict:
    """Rungs 1-11 of this ladder and of the earlier one on the ladder's
    inputs at (c, p, s), timed in turns (earlier, this, this, earlier);
    the earlier rungs' errors against the plain versions, held to
    nothing."""
    from magicsoup_tpu_torch.interop import params_from_numpy
    from magicsoup_tpu_torch.ops import cuda_bisect as cb
    from magicsoup_tpu_torch.performance import cuda_median_ms
    from magicsoup_tpu_torch.performance.kernel_bisect import KERNEL_REPS, draw_inputs

    X_np, d = draw_inputs(c, p, s)
    X = torch.from_numpy(X_np).cuda()
    params = params_from_numpy(d, "cuda")
    rows = {}
    for r in cb.RUNGS:
        new = lambda r=r: cb.run_rung(r, X, params)  # noqa: E731
        old = lambda r=r: PARENT_LADDER.run_rung(r, X, params)  # noqa: E731
        out = old()
        torch.cuda.synchronize()
        ref = cb.plain_rung(r, X, params)
        _, err = cb.holds(cb.RUNGS[r].contract, out, ref, cb.scale(r, X, params, ref))
        times = [cuda_median_ms(f, KERNEL_REPS) for f in (old, new, new, old)]
        rows[r] = {"ms": (times[1] + times[2]) / 2,
                   "parent": {"ms": (times[0] + times[3]) / 2, "ms_in_turns": times, **err}}
        print(f"ladder {c}x{p}x{s} rung {r:2d}: {rows[r]['ms']:.4f} ms, earlier"
              f" {rows[r]['parent']['ms']:.4f} ms (in turns {', '.join(f'{t:.4f}' for t in times)})",
              flush=True)
    return rows


def _microbench(torch) -> list:
    """The integrator microbenchmark at its defaults at BENCH_POINTS; one
    kernel launch per chained cuda step."""
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.performance import integrator_bench as ib

    chain, reps = 10, 4
    ci.launches = 0
    rows, ok = ib.bench(16384, 32, 28, 0.75, chain, reps, list(BENCH_POINTS), "cuda")
    if not ok:
        raise AssertionError("a microbenchmark point failed")
    # per cuda point: the checked chain, the timer's warm-up and reps chains
    n_cuda = sum(1 for name, _ in BENCH_POINTS if name == "cuda")
    if ci.launches != n_cuda * (reps + 2) * chain:
        raise AssertionError(f"microbenchmark: {ci.launches} launches for {n_cuda} cuda points")
    return rows


def _genome_ops() -> list:
    """The genome-ops microbenchmark at its defaults (phase 18); each
    token op must launch the threefry kernel."""
    from magicsoup_tpu_torch.ops import cuda_prng
    from magicsoup_tpu_torch.performance import genome_ops

    cuda_prng.launches = 0
    rows = genome_ops.bench(**GENOME_OPS, device="cuda",
                            log=lambda line: print(f"genome_ops {line}", flush=True))
    if cuda_prng.launches == 0 or len(rows) != 6 * len(GENOME_OPS["sizes"]):
        raise AssertionError(f"genome_ops: {len(rows)} rows, {cuda_prng.launches} launches")
    return rows


@contextlib.contextmanager
def _det_env(on: bool = True):
    """Scope with ``MAGICSOUP_TPU_DETERMINISTIC`` set to 1 (or unset)."""
    saved = os.environ.get("MAGICSOUP_TPU_DETERMINISTIC")
    if on:
        os.environ["MAGICSOUP_TPU_DETERMINISTIC"] = "1"
    else:
        os.environ.pop("MAGICSOUP_TPU_DETERMINISTIC", None)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MAGICSOUP_TPU_DETERMINISTIC", None)
        else:
            os.environ["MAGICSOUP_TPU_DETERMINISTIC"] = saved


def _state_arrays(world) -> dict:
    """Every piece of a world's state, as scripts/bitrepro.py hashes it."""
    import numpy as np

    n = world.n_cells
    out = {
        "molecule_map": world.molecule_map.cpu().numpy(),
        "cell_molecules": np.asarray(world.cell_molecules)[:n],
        "positions": np.asarray(world.cell_positions),
        "lifetimes": np.asarray(world.cell_lifetimes),
        "divisions": np.asarray(world.cell_divisions),
        "genomes": np.frombuffer("\n".join(world.cell_genomes).encode(), dtype=np.uint8),
    }
    for name, t in world.kinetics.params._asdict().items():
        out[f"params.{name}"] = t[:n].cpu().numpy()
    if world.genome_store is not None:
        out["store.tokens"] = world.genome_store.tokens.cpu().numpy()
        out["store.lengths"] = world.genome_store.lengths.cpu().numpy()
    return out


def _first_divergence(a: dict, b: dict) -> dict | None:
    """The first tensor whose bytes differ between two state snapshots,
    with its largest absolute and ULP difference."""
    import numpy as np

    for key in a:
        x, y = a[key], b[key]
        if x.shape == y.shape and x.tobytes() == y.tobytes():
            continue
        out = {"tensor": key}
        if x.shape != y.shape:
            out["shapes"] = [list(x.shape), list(y.shape)]
            return out
        out["n_diff"] = int((x != y).sum())
        out["max_abs"] = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max())
        if x.dtype == np.float32:
            xi, yi = x.view(np.int32).astype(np.int64), y.view(np.int32).astype(np.int64)
            out["max_ulp"] = int(np.abs(xi - yi).max())
        return out
    return None


@contextlib.contextmanager
def _no_flush_bit(torch):
    """Scope in which det work on the CPU runs as it does but without the
    thread's flush-to-zero bits: ``flush_denormal`` still runs it on one
    thread, and its ``torch.set_flush_denormal`` calls do nothing."""
    saved = torch.set_flush_denormal
    torch.set_flush_denormal = lambda mode: False
    try:
        yield
    finally:
        torch.set_flush_denormal = saved


def _det_on_card(torch) -> dict:
    """Deterministic mode on the card against the CPU (phase 13); the
    workload also runs on the CPU without the flush bit, and where that
    run's bits first differ from the flushed CPU run's is recorded (the
    card keeps subnormals as the CPU does without the bit)."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu_torch.workload import sim_step

    with _det_env():
        t0 = time.perf_counter()
        atp = CHEMISTRY.molname_2_idx["ATP"]
        worlds = {d: mt.World(chemistry=CHEMISTRY, map_size=DET_MAP, seed=DET_SEED,
                              device=d.split("-")[0])
                  for d in ("cpu", "cuda", "cpu-no-flush")}
        rngs = {d: random.Random(DET_SEED) for d in worlds}
        if {w.integrator for w in worlds.values()} != {"torch-det"}:
            raise AssertionError("det worlds do not run the det integrator")
        n_cells, no_flush_div = [], None
        for step in range(DET_STEPS):
            for d, w in worlds.items():
                scope = _no_flush_bit(torch) if d == "cpu-no-flush" else contextlib.nullcontext()
                with scope:
                    sim_step(w, rngs[d], n_cells=DET_CELLS, genome_size=DET_GENOME,
                             atp_idx=atp, sync=True)
            states = {d: _state_arrays(w) for d, w in worlds.items()}
            div = _first_divergence(states["cpu"], states["cuda"])
            if div is not None:
                raise AssertionError(f"det mode: card and CPU diverge at step {step}: {div}")
            if no_flush_div is None:
                no_flush_div = _first_divergence(states["cpu"], states["cpu-no-flush"])
                if no_flush_div is not None:
                    no_flush_div["step"] = step
                    del worlds["cpu-no-flush"]
            n_cells.append(worlds["cuda"].n_cells)
        classic_s = time.perf_counter() - t0

        # the stepper, with the arguments of tests/test_torch_stepper.py
        kw = dict(mol_name="ATP", kill_below=1.0, divide_above=3.0, divide_cost=1.0,
                  target_cells=40, genome_size=300, lag=2, max_divisions=64,
                  spawn_block=16, push_block=16, p_mutation=1e-3, p_recombination=1e-4,
                  megastep=1)
        states, stats = [], []
        for d in ("cpu", "cuda"):
            w = mt.World(chemistry=CHEMISTRY, map_size=16, seed=3, device=d)
            rng = random.Random(3)
            w.spawn_cells([mt.random_genome(s=300, rng=rng) for _ in range(20)])
            w._ensure_capacity(100)
            st = mt.PipelinedStepper(w, **kw)
            for _ in range(DET_DISPATCHES):
                st.step()
            st.flush()
            states.append(_state_arrays(w))
            stats.append({k: v for k, v in st.stats.items() if not k.endswith("_ms")})
        div = _first_divergence(*states)
        if div is not None or stats[0] != stats[1]:
            raise AssertionError(f"det stepper: card and CPU diverge: {div}, stats {stats}")

        # a token world: the workload plus raised evolution after each step
        t0 = time.perf_counter()
        tworlds = {d: mt.World(chemistry=CHEMISTRY, map_size=DET_MAP, seed=DET_SEED, device=d,
                               genome_backend="token") for d in ("cpu", "cuda")}
        trngs = {d: random.Random(DET_SEED) for d in tworlds}
        token_cells, token_misses = [], 0
        for step in range(DET_STEPS):
            for d, w in tworlds.items():
                sim_step(w, trngs[d], n_cells=DET_CELLS, genome_size=DET_GENOME,
                         atp_idx=atp, sync=True)
                w.recombinate_cells(p=DET_TOKEN_P_RECOMBINATION)
                w.mutate_cells(p=DET_TOKEN_P_MUTATION)
            tstates = {d: _state_arrays(w) for d, w in tworlds.items()}
            div = _first_divergence(tstates["cpu"], tstates["cuda"])
            if div is not None:
                raise AssertionError(f"det token world: card and CPU diverge at step {step}: {div}")
            token_cells.append(tworlds["cuda"].n_cells)
            token_misses = tworlds["cuda"].phenotypes.misses
        token_s = time.perf_counter() - t0
    return {
        "classic": {"steps": DET_STEPS, "cells": DET_CELLS, "map_size": DET_MAP,
                    "seed": DET_SEED, "n_cells": n_cells, "tensors": sorted(_state_arrays(worlds["cuda"])),
                    "bit_equal_every_step": True, "wall_s": classic_s,
                    "cpu_without_flush_bit": {"bit_equal_every_step": no_flush_div is None,
                                              "first_divergence": no_flush_div}},
        "stepper_K1": {"dispatches": DET_DISPATCHES, "steps": stats[1]["steps"],
                       "n_cells": int(states[1]["positions"].shape[0]),
                       "bit_equal_after_flush": True},
        "token_classic": {"steps": DET_STEPS, "cells": DET_CELLS, "map_size": DET_MAP,
                          "seed": DET_SEED, "p_recombination": DET_TOKEN_P_RECOMBINATION,
                          "p_mutation": DET_TOKEN_P_MUTATION, "n_cells": token_cells,
                          "phenotype_cache_misses": token_misses,
                          "store_shape": list(tworlds["cuda"].genome_store.tokens.shape),
                          "tensors": sorted(_state_arrays(tworlds["cuda"])),
                          "bit_equal_every_step": True, "wall_s": token_s},
    }


def _persist_snapshot(world) -> tuple[dict, dict]:
    """Every piece of a world's state that ``save`` must keep: arrays at
    full capacity (the kinetic parameters and token tables, the token
    store) and the host state, RNG states included."""
    import numpy as np

    arrays = {
        "molecule_map": world.molecule_map.cpu().numpy(),
        "cell_molecules": world._cell_molecules.cpu().numpy(),
        "positions": world._np_positions.copy(),
        "lifetimes": world._np_lifetimes.copy(),
        "divisions": world._np_divisions.copy(),
        "cell_map": world.cell_map.copy(),
        "genomes": np.frombuffer("\n".join(world.cell_genomes).encode(), dtype=np.uint8),
    }
    for group in ("params", "tables"):
        for name, t in getattr(world.kinetics, group)._asdict().items():
            arrays[f"{group}.{name}"] = t.cpu().numpy()
    if world.genome_store is not None:
        arrays["store.tokens"] = world.genome_store.tokens.cpu().numpy()
        arrays["store.lengths"] = world.genome_store.lengths.cpu().numpy()
    meta = {
        "n_cells": world.n_cells,
        "capacity": world._capacity,
        "labels": list(world.cell_labels),
        "rng": world._rng.getstate(),
        "nprng": world._nprng.bit_generator.state,
        "deterministic": world.deterministic,
        "integrator_choice": world._integrator_choice,
        "kinetics_caps": (world.kinetics.max_cells, world.kinetics.max_proteins,
                          world.kinetics.max_doms),
    }
    return arrays, meta


def _timed(torch, fn):
    """``fn()`` and its seconds, between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _persistence(torch, world) -> dict:
    """Phase 19 at full width on one classic world: the three round trips,
    each bit-equal and audited, the restored world's 10 steps, and what a
    checkpoint costs."""
    import shutil

    import numpy as np

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.check import assert_consistent, audit_world
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.workload import sim_step

    label = f"persistence ({world.genome_backend})"
    base = PERSIST_DIR / world.genome_backend
    shutil.rmtree(base, ignore_errors=True)
    want = _persist_snapshot(world)

    def same(other, how: str) -> None:
        got = _persist_snapshot(other)
        div = _first_divergence(want[0], got[0])
        meta = sorted(k for k in want[1] if want[1][k] != got[1][k])
        if div is not None or meta:
            raise AssertionError(f"{label}, {how}: {div}, host state differs in {meta}")
        assert_consistent(other)

    _, save_s = _timed(torch, lambda: world.save(base / "a"))
    save_bytes = (base / "a" / "world.pkl").stat().st_size
    drops0 = runtime.phenotype_cache_stats()["pickle_drops"]
    card, from_file_s = _timed(torch, lambda: mt.World.from_file(base / "a", device="cuda"))
    drops = runtime.phenotype_cache_stats()["pickle_drops"] - drops0
    if card.device.type != "cuda" or card.kinetics.params.Ke.device.type != "cuda":
        raise AssertionError(f"{label}: from_file(device='cuda') gave a world on {card.device}")
    same(card, "save -> from_file(cuda)")
    cpu, from_file_cpu_s = _timed(torch, lambda: mt.World.from_file(base / "a", device="cpu"))
    if cpu.kinetics.params.Ke.device.type != "cpu":
        raise AssertionError(f"{label}: from_file(device='cpu') left tensors on the card")
    same(cpu, "save -> from_file(cpu)")
    cpu.save(base / "b")
    del cpu
    again = mt.World.from_file(base / "b", device="cuda")
    same(again, "save -> from_file(cpu) -> save -> from_file(cuda)")
    del again

    _, save_state_s = _timed(torch, lambda: world.save_state(base / "c"))
    state_bytes = sum(f.stat().st_size for f in (base / "c").iterdir())
    fresh = mt.World(chemistry=world.chemistry, map_size=world.map_size, seed=world.seed,
                     genome_backend=world.genome_backend)
    _, load_state_s = _timed(torch, lambda: fresh.load_state(base / "c"))
    n = world.n_cells
    for name, a, b in (
        ("molecule_map", want[0]["molecule_map"], fresh.molecule_map.cpu().numpy()),
        ("cell_molecules", want[0]["cell_molecules"][:n], fresh.cell_molecules),
        ("positions", want[0]["positions"][:n], fresh.cell_positions),
        ("lifetimes", want[0]["lifetimes"][:n], fresh.cell_lifetimes),
        ("divisions", want[0]["divisions"][:n], fresh.cell_divisions),
        ("cell_map", want[0]["cell_map"], fresh.cell_map),
        ("genomes", want[0]["genomes"],
         np.frombuffer("\n".join(fresh.cell_genomes).encode(), dtype=np.uint8)),
    ):
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"{label}: save_state -> load_state changed {name}")
    if fresh.cell_labels != want[1]["labels"] or fresh.n_cells != n:
        raise AssertionError(f"{label}: save_state -> load_state changed the labels or count")
    assert_consistent(fresh)
    del fresh

    # the world restored on the card runs on
    atp = card.chemistry.molname_2_idx["ATP"]
    rng = random.Random(SEED + 2)
    ci.launches = 0
    misses0 = card.phenotypes.misses
    sim_step(card, rng, n_cells=N_CELLS, genome_size=GENOME_SIZE, atp_idx=atp)
    first_step_misses = card.phenotypes.misses - misses0
    for _ in range(PERSIST_STEPS - 1):
        sim_step(card, rng, n_cells=N_CELLS, genome_size=GENOME_SIZE, atp_idx=atp, sync=False)
    torch.cuda.synchronize()
    launches = ci.launches
    if launches != PERSIST_STEPS:
        raise AssertionError(f"{label}: {launches} K1 launches in {PERSIST_STEPS} restored steps")
    _check_state(card, label)
    violations = audit_world(card)
    if violations:
        raise AssertionError(f"{label}: the restored world's audit after its steps: {violations}")
    shutil.rmtree(base, ignore_errors=True)
    return {
        "n_cells": n,
        "capacity": world._capacity,
        "save_s": save_s,
        "save_bytes": save_bytes,
        "from_file_cuda_s": from_file_s,
        "from_file_cpu_s": from_file_cpu_s,
        "save_state_s": save_state_s,
        "save_state_bytes": state_bytes,
        "load_state_s": load_state_s,
        "round_trips_bit_equal": 3,
        "phenotype_pickle_drops": drops,
        "first_step_cache_misses": first_step_misses,
        "restored_steps": PERSIST_STEPS,
        "restored_launches": launches,
        "restored_n_cells": card.n_cells,
    }


def _det_restore(torch) -> dict:
    """Phase 19's det part: at phase 13's 500 cells, a world restored
    with ``save``/``from_file`` and the uninterrupted one, string and
    token, bit-equal for 10 workload steps."""
    import shutil

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu_torch.workload import sim_step

    atp = CHEMISTRY.molname_2_idx["ATP"]
    out = {}
    with _det_env():
        for backend in ("string", "token"):
            world = mt.World(chemistry=CHEMISTRY, map_size=DET_MAP, seed=DET_SEED,
                             genome_backend=backend)
            rng = random.Random(DET_SEED)
            for _ in range(5):
                sim_step(world, rng, n_cells=DET_CELLS, genome_size=DET_GENOME, atp_idx=atp)
            base = PERSIST_DIR / f"det_{backend}"
            world.save(base)
            restored = mt.World.from_file(base, device="cuda")
            shutil.rmtree(base, ignore_errors=True)
            rng2 = random.Random()
            rng2.setstate(rng.getstate())
            for step in range(PERSIST_STEPS):
                sim_step(world, rng, n_cells=DET_CELLS, genome_size=DET_GENOME, atp_idx=atp)
                sim_step(restored, rng2, n_cells=DET_CELLS, genome_size=DET_GENOME, atp_idx=atp)
                div = _first_divergence(_state_arrays(world), _state_arrays(restored))
                if div is not None:
                    raise AssertionError(
                        f"det restore ({backend}): the restored world diverges at step {step}: {div}"
                    )
            out[backend] = {"steps": PERSIST_STEPS, "n_cells": restored.n_cells,
                            "bit_equal_every_step": True}
    return out


def _api(torch, world) -> dict:
    """Phase 20 on one classic world at full width."""
    import numpy as np

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.check import assert_consistent
    from magicsoup_tpu_torch.ops import backends
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    label = f"api ({world.genome_backend})"
    out = {"n_cells": world.n_cells}
    before = world.cell_positions.copy()
    _, out["move_cells_s"] = _timed(torch, world.move_cells)
    assert_consistent(world)
    out["moved"] = int((world.cell_positions != before).any(axis=1).sum())
    _, out["reposition_cells_s"] = _timed(torch, world.reposition_cells)
    assert_consistent(world)

    idxs = sorted(set(np.linspace(0, world.n_cells - 1, API_CELLS).astype(int).tolist()))
    cells, out["get_cell_s"] = _timed(torch, lambda: [world.get_cell(by_idx=i) for i in idxs])
    for c in cells:  # read before the rows move
        c.genome, c.int_molecules
    _, out["kill_cells_s"] = _timed(torch, lambda: world.kill_cells(idxs))
    assert_consistent(world)
    new, out["add_cells_s"] = _timed(torch, lambda: world.add_cells(cells))
    if len(new) != len(cells):
        raise AssertionError(f"{label}: add_cells placed {len(new)} of {len(cells)} cells")
    assert_consistent(world)
    genomes = world.cell_genomes
    if (
        [genomes[i] for i in new] != [c.genome for c in cells]
        or [world.cell_labels[i] for i in new] != [c.label for c in cells]
        or world.cell_molecules[new].tobytes()
        != np.stack([c.int_molecules for c in cells]).tobytes()
        or world.cell_lifetimes[new].tolist() != [c.n_steps_alive for c in cells]
    ):
        raise AssertionError(f"{label}: the added cells differ from the ones taken out")
    out["cells_round_trip"] = len(new)

    # Kinetics.integrate_signals against the classic step's activity
    X0, params_q = world.integrator_inputs()
    q = X0.shape[0]
    X = torch.zeros((world._capacity, X0.shape[1]), dtype=torch.float32, device=X0.device)
    X[:q] = X0
    ref = backends.integrate("cuda", X0, params_q)
    ci.launches = 0
    got = world.kinetics.integrate_signals(X)
    torch.cuda.synchronize()
    out["integrate_signals_launches"] = ci.launches
    if ci.launches != 1:
        raise AssertionError(f"{label}: integrate_signals made {ci.launches} K1 launches")
    got_np, ref_np = got[:q].cpu().numpy(), ref.cpu().numpy()
    q99, rel_max, abs_max = _fast_errors(got_np, ref_np)
    if not (np.isfinite(got_np).all() and (got_np >= 0).all() and q99 < 1e-4 and rel_max < 0.15):
        raise AssertionError(f"{label}: integrate_signals breaks the fast contract: {q99}, {rel_max}")
    out["integrate_signals"] = {"rows": q, "q99_rel": q99, "max_rel": rel_max,
                                "max_abs_err": abs_max,
                                "bit_equal": bool(got_np.tobytes() == ref_np.tobytes())}

    # a GenomeFact proteome in a fresh world translates to its spec
    chem = world.chemistry
    subs, prods = chem.reactions[0]
    mol = chem.molecules[0]
    fresh = mt.World(chemistry=chem, map_size=MAP_SIZE, seed=SEED + 3,
                     genome_backend=world.genome_backend)
    fact = mt.GenomeFact(world=fresh, proteome=[
        [mt.CatalyticDomainFact(reaction=(subs, prods), km=1.0, vmax=2.0)],
        [mt.TransporterDomainFact(molecule=mol, is_exporter=True)],
    ])
    want_reaction = {tuple(sorted(subs)), tuple(sorted(prods))}
    for attempt in range(3):  # random spacers can break a CDS, as in the JAX tests
        (idx,) = fresh.spawn_cells([fact.generate()])
        doms = [d for p in fresh.get_cell(by_idx=idx).proteome for d in p.domains]
        catal = any(isinstance(d, mt.CatalyticDomain)
                    and {tuple(sorted(d.substrates)), tuple(sorted(d.products))} == want_reaction
                    for d in doms)
        trans = any(isinstance(d, mt.TransporterDomain) and d.molecule is mol and d.is_exporter
                    for d in doms)
        if catal and trans:
            break
    else:
        raise AssertionError(f"{label}: no GenomeFact genome translated to its spec in 3 tries")
    assert_consistent(fresh)
    out["genome_fact_tries"] = attempt + 1
    return out


def _both_digests(world) -> tuple:
    """The structural and the full digest of a world, and its arrays for
    a report of where two worlds differ."""
    from magicsoup_tpu_torch.check import differential

    return (differential.structural_digest(world), differential.state_digest(world),
            _state_arrays(world))


def _differential(torch) -> dict:
    """Phase 21: the differential harness on the card against the golden
    files and against the CPU in the same call."""
    from magicsoup_tpu_torch.check import differential
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_params, cuda_prng

    paths = (differential.PATHS + differential.FLEET_PATHS + differential.TOKEN_PATHS
             + differential.FUSED_PATHS)
    out = {"paths": list(paths), "seconds": {"cuda": 0.0, "cpu": 0.0}, "launches": {}}
    states, structural = {}, {}
    for name in DIFF_GOLDEN:
        rec = json.loads((GOLDEN_DIR / name).read_text())
        kw = dict(seed=rec["seed"], map_size=rec["map_size"], n_cells=rec["n_cells"],
                  digest_fn=_both_digests)
        for path in paths:
            ci.launches = ci.grouped_launches = cuda_prng.launches = cuda_params.launches = 0
            # a mesh path's ranks are child processes: their digests come
            # back by name, without the arrays of a divergence report
            mesh_kw = dict(kw, digest_fn=differential.both_digests)
            pkw = mesh_kw if path in differential.MESH_PATHS else kw
            t0 = time.perf_counter()
            card = differential.run_path(path, device="cuda", **pkw)
            out["seconds"]["cuda"] += time.perf_counter() - t0
            # a mesh path's ranks count in their own processes (phase 25)
            out["launches"][f"{path}/seed{rec['seed']}"] = {
                "k1_k2": ci.launches, "grouped": ci.grouped_launches,
                "threefry": cuda_prng.launches, "assembly": cuda_params.launches}
            if path in ("classic", "token_classic") and cuda_params.launches == 0:
                raise AssertionError(f"differential {path}: no assembly launch on the card")
            t0 = time.perf_counter()
            cpu = differential.run_path(path, device="cpu", **pkw)
            if path in differential.MESH_PATHS:
                card = [(a, b, None) for a, b in card]
                cpu = [(a, b, None) for a, b in cpu]
            out["seconds"]["cpu"] += time.perf_counter() - t0
            got = [d[0] for d in card]
            states[path, rec["seed"]] = [d[1] for d in card]
            structural[path, rec["seed"]] = got
            if got != rec["structural_digests"]:
                at = [b for b, x, y in zip(differential.BOUNDARIES, got, rec["structural_digests"])
                      if x != y]
                raise AssertionError(f"differential {path}, seed {rec['seed']}, on the card:"
                                     f" structural digests differ from {name} at {at}")
            for b, c, h in zip(differential.BOUNDARIES, card, cpu):
                if c[1] != h[1]:
                    where = _first_divergence(h[2], c[2]) if c[2] is not None else path
                    raise AssertionError(
                        f"differential {path}, seed {rec['seed']}: the card's state digest"
                        f" differs from the CPU's at {b}: {where}")
    # the fused paths: fused2 against its own golden file, and each equal
    # to its solo path's full digests at every boundary on the card
    rec = json.loads((GOLDEN_DIR / DIFF_FUSED_GOLDEN).read_text())
    if structural["fused2", rec["seed"]] != rec["structural_digests"]:
        raise AssertionError(f"differential fused2 on the card differs from {DIFF_FUSED_GOLDEN}")
    for (path, seed), digests in states.items():
        solo = {"fused2": "k1", "fused_fleet": "k4", "mesh2": "k1",
                "token_mesh2": "token_k1"}.get(path)
        if solo is not None and digests != states[solo, seed]:
            at = [b for b, x, y in zip(differential.BOUNDARIES, digests, states[solo, seed]) if x != y]
            raise AssertionError(f"differential {path}, seed {seed}: differs from {solo} at {at}")
    rec = json.loads((GOLDEN_DIR / DIFF_CUDA_GOLDEN).read_text())
    ci.launches = 0
    got = differential.run_path("cuda_k1", device="cuda", seed=rec["seed"],
                                map_size=rec["map_size"], n_cells=rec["n_cells"],
                                digest_fn=differential.structural_digest)
    out["launches"]["cuda_k1/seed11"] = {"k1_k2": ci.launches}
    steps = sum(differential.PHASES)
    if got != rec["structural_digests"] or ci.launches < steps:
        raise AssertionError(f"differential cuda_k1: golden digests equal {got == rec['structural_digests']},"
                             f" {ci.launches} K2 launches in {steps} steps")
    out["golden_equal"] = len(DIFF_GOLDEN) * len(paths) + 2
    out["fused_equal_solo"] = 2 * len(DIFF_GOLDEN)
    out["mesh_equal_solo"] = len(differential.MESH_PATHS) * len(DIFF_GOLDEN)
    out["state_digests_card_equal_cpu"] = len(DIFF_GOLDEN) * len(paths)
    return out


def _threefry(torch) -> dict:
    """Phase 14: the threefry kernel against its plain version on the
    card, bit for bit, one launch per draw; times and bound at the
    store's shape."""
    from magicsoup_tpu_torch.ops import cuda_prng, prng
    from magicsoup_tpu_torch.performance import HBM_BYTES_PER_S, cuda_median_ms

    key = prng.prng_key(SEED, "cuda")
    n_keys, n = THREEFRY_WORLDS
    keys = torch.stack([prng.prng_key(SEED + i, "cuda") for i in range(n_keys)])
    cases = [("random_bits", key, THREEFRY_STORE), ("random_bits", keys, (n,)),
             ("split", key, (4,)), ("split", keys, (4,))]
    cases += [("random_bits", key, (m,)) for m in THREEFRY_ODD]
    checked = []
    for name, k, shape in cases:
        pair = name == "split"
        before = cuda_prng.launches
        out = prng._hash_counters(k, shape, pair)
        torch.cuda.synchronize()
        launched = cuda_prng.launches - before
        ref = prng.hash_counters_plain(k, shape, pair)
        if launched != 1 or not torch.equal(out, ref):
            raise AssertionError(f"threefry {name} {tuple(k.shape)} {shape}: {launched}"
                                 f" launches, bit-equal {torch.equal(out, ref)}")
        checked.append({"draw": name, "keys": list(k.shape[:-1]), "shape": list(shape),
                        "launches": launched, "bit_equal": True})
    # the CPU's plain version gives the same bits
    small = prng._hash_counters(keys, (1000,))
    if not torch.equal(small.cpu(), prng.hash_counters_plain(keys.cpu(), (1000,))):
        raise AssertionError("threefry: the card's bits differ from the CPU's")
    del out, ref
    draw = lambda: prng.random_bits(key, THREEFRY_STORE)  # noqa: E731
    plain = lambda: prng.hash_counters_plain(key, THREEFRY_STORE)  # noqa: E731
    before = cuda_prng.launches
    ms = cuda_median_ms(draw, KERNEL_REPS)
    launches = cuda_prng.launches - before
    plain_ms = cuda_median_ms(plain, PLAIN_REPS)
    elements = THREEFRY_STORE[0] * THREEFRY_STORE[1]
    bytes_ms = (8 * elements + 16) / HBM_BYTES_PER_S * 1e3
    ops_ms = THREEFRY_OPS * elements / F32_FLOP_PER_S * 1e3
    got = {
        "checked": checked,
        "card_equals_cpu": True,
        "shape": list(THREEFRY_STORE),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_bound_ms": bytes_ms,
        "ops_bound_ms": ops_ms,
        "ops_per_element": THREEFRY_OPS,
        "timing_launches": launches,
        "host_us_per_launch": _host_us(torch, draw),
    }
    print(f"threefry at {THREEFRY_STORE}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound"
          f" {got['bound_ms']:.4f} ms by {got['bound_by']}), {len(checked)} draws bit-equal,"
          f" one launch each", flush=True)
    return got


def _assembly_tokens(rng, b: int, p_r: int, d_r: int, n1: int, n2: int):
    """A random token batch ``(b, p_r, d_r, 5)``: each cell 1..p_r
    proteins of 1..d_r domains of random type, zeros beyond them."""
    import numpy as np

    n_p = rng.integers(1, p_r + 1, b)
    n_d = rng.integers(1, d_r + 1, (b, p_r))
    live = (np.arange(p_r)[None, :, None] < n_p[:, None, None]) & (
        np.arange(d_r)[None, None, :] < n_d[:, :, None])
    dense = np.zeros((b, p_r, d_r, 5), dtype=np.int16)
    dense[..., 0] = rng.integers(1, 4, live.shape) * live
    dense[..., 1:4] = rng.integers(1, n1, live.shape + (3,)) * live[..., None]
    dense[..., 4] = rng.integers(1, n2, live.shape) * live
    return dense


def _assembly_read_bytes(dense, tables) -> int:
    """Bytes the batch needs read once: its tokens, its rows (int64), and
    each table row that a domain reaches (Km and sign by every domain,
    Vmax by a catalytic or transporter domain, hill and effector by a
    regulatory one, reaction by a catalytic one, transport by a
    transporter), with row 0 of every table once, where the zeroed
    indices and the fill slots go."""
    import numpy as np

    t, i0, i1, i2, i3 = (dense[..., k] for k in range(5))
    reached = {
        "km_weights": i1, "signs": i2,
        "vmax_weights": i0[(t == 1) | (t == 2)], "hills": i0[t == 3],
        "reactions": i3[t == 1], "transports": i3[t == 2], "effectors": i3[t == 3],
    }
    n = dense.nbytes + 8 * dense.shape[0]
    for name, idx in reached.items():
        table = getattr(tables, name)
        rows = len(np.union1d(idx, [0]))
        n += rows * table[0].numel() * table.element_size()
    return n + tables.mol_energies.numel() * tables.mol_energies.element_size()


def _assembly(torch) -> dict:
    """Phase 28: the assembly kernel against the plain ``assemble_rows``
    on the card at the classic path's shapes."""
    import numpy as np

    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu_torch.kinetics import Kinetics
    from magicsoup_tpu_torch.ops import cuda_params
    from magicsoup_tpu_torch.ops import params as P
    from magicsoup_tpu_torch.ops.integrate import CellParams
    from magicsoup_tpu_torch.performance import HBM_BYTES_PER_S, cuda_median_ms

    kin = Kinetics(chemistry=CHEMISTRY, seed=SEED, device="cuda")
    tables, temp = kin.tables, kin._abs_temp_t
    s = tables.mol_energies.shape[0]
    n1, n2 = tables.km_weights.shape[0], tables.reactions.shape[0]
    p_r, d_r = ASSEMBLY_RUNG
    rng = np.random.default_rng(SEED)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    def device_ops(fn):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)

    shapes = []
    for P_ in ASSEMBLY_P:
        for b in ASSEMBLY_ROWS:
            dense_np = _assembly_tokens(rng, b, p_r, d_r, n1, n2)
            rows_np = rng.permutation(ASSEMBLY_CAP)[:b]
            dense, rows = torch.from_numpy(dense_np).cuda(), torch.from_numpy(rows_np).cuda()
            got = kin._alloc(ASSEMBLY_CAP, P_)
            want = CellParams(*(t.clone() for t in got))
            before = cuda_params.launches
            cuda_params.assemble_rows(got, dense_np, tables, temp, rows_np)
            launched = cuda_params.launches - before
            P.assemble_rows(want, dense, tables, temp, rows)
            torch.cuda.synchronize()
            equal = all(torch.equal(bits(a), bits(w)) for a, w in zip(got, want))
            if launched != 1 or not equal:
                raise AssertionError(f"assembly at b {b}, P {P_}: {launched} launches,"
                                     f" bit-equal {equal}")
            kernel = lambda: cuda_params.launch(got, dense, tables, temp, rows)  # noqa: E731
            call = lambda: cuda_params.assemble_rows(got, dense_np, tables, temp, rows_np)  # noqa: E731
            plain = lambda: P.assemble_rows(want, dense, tables, temp, rows)  # noqa: E731
            written = b * P_ * (16 + 12 * s)
            read = _assembly_read_bytes(dense_np, tables)
            ms = cuda_median_ms(kernel, KERNEL_REPS)
            bound_ms = (written + read) / HBM_BYTES_PER_S * 1e3
            row = {
                "rows": b, "P": P_, "rung": [p_r, d_r], "s": s, "bit_equal": True,
                "launches": launched, "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
                "bound_share_pct": 100.0 * bound_ms / ms,
                "written_bytes": written, "read_bytes": read,
                "host_us_per_launch": _host_us(torch, kernel),
                "wall_ms": wall_ms(call, PLAIN_REPS),
                "plain_ms": cuda_median_ms(plain, PLAIN_REPS),
                "plain_wall_ms": wall_ms(plain, PLAIN_REPS),
                "plain_device_ops": device_ops(plain),
                "device_ops": device_ops(kernel),
            }
            shapes.append(row)
            print(f"assembly b {b} P {P_}: {ms:.4f} ms (bound {bound_ms:.4f}, plain"
                  f" {row['plain_ms']:.3f} ms device / {row['plain_wall_ms']:.3f} ms wall,"
                  f" {row['plain_device_ops']} device ops), host {row['host_us_per_launch']:.1f}"
                  f" us a launch, {row['wall_ms']:.3f} ms a call, bit-equal", flush=True)
            del got, want
    return {"shapes": shapes}


def _assembly_entry(assembly: dict, per_path: dict) -> dict:
    """The assembly kernel's entry of the kernels line: times from phase
    28 at 400 rows into P 64, launches from the classic work (phase 5),
    per path beside."""
    main = next(r for r in assembly["shapes"] if r["rows"] == 400 and r["P"] == ASSEMBLY_P[0])
    return {
        "name": "assemble_rows",
        "route": "cuda",
        "source": "magicsoup_tpu_torch/csrc/assemble.cu",
        # no Pallas kernel: the JAX package's XLA program,
        # magicsoup_tpu/ops/params.py
        "replaces": None,
        "shape": {k: main[k] for k in ("rows", "P", "rung", "s")},
        "launches": per_path["classic"],
        "launches_per_path": per_path,
        "launches_per_call": main["launches"],
        "max_abs_err": 0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ok": True,
    }


def _threefry_entry(threefry: dict, per_path: dict) -> dict:
    """The threefry kernel's entry of the kernels line: times from phase
    14, launches from the token classic run (phase 15), per path beside."""
    return {
        "name": "threefry2x32",
        "route": "cuda",
        "source": "magicsoup_tpu_torch/csrc/threefry.cu",
        # no Pallas kernel: the draws of the JAX package's XLA programs,
        # first of them the token store's uniform
        "replaces": "magicsoup_tpu/genomes.py:196",
        "shape": threefry["shape"],
        "launches": per_path["token_classic"],
        "launches_per_path": per_path,
        "max_abs_err": 0,
        "ms": threefry["ms"],
        "plain_ms": threefry["plain_ms"],
        "bound_ms": threefry["bound_ms"],
        "bound_by": threefry["bound_by"],
        "library_ms": None,
        "ok": True,
    }


def _k3_entry(ladder: dict) -> dict:
    """The ladder's entry of the kernels line: per rung at each shape;
    its top-level times are the sums over the kernel rungs (1-11) at the
    workload's shape."""
    c, p, s = LADDER_SHAPES[-1]
    work = [r for r in ladder["runs"][f"{c}x{p}x{s}"] if r["rung"] <= 11]
    keys = ("name", "ms", "plain_ms", "bytes", "bound_ms", "library_ms",
            "smem_bytes", "ctas_per_sm", "waves", "streamed_ms", "streamed_bit_equal",
            "max_abs_err", "max_rel_err", "q99_rel_err", "bit_equal_to_integrator",
            "worlds_bit_equal_to_solo", "ok")
    return {
        "name": "kernel_bisect",
        "route": "cuda",
        "source": "magicsoup_tpu_torch/csrc/bisect.cu",
        "replaces": "performance/pallas_bisect.py:98",
        "shape": [{"c": c, "p": p, "s": s} for c, p, s in LADDER_SHAPES],
        "rungs": {shape: [{k: r[k] for k in ("rung",) + keys if k in r} for r in rows]
                  for shape, rows in ladder["runs"].items()},
        "launches": ladder["launches"],
        "max_abs_err": max(r["max_abs_err"] for rows in ladder["runs"].values() for r in rows),
        "ms": sum(r["ms"] for r in work),
        "plain_ms": sum(r["plain_ms"] for r in work),
        "bound_ms": sum(r["bound_ms"] for r in work),
        "bound_by": "bytes",
        "library_ms": None,
        **({"parent": ladder["parent"]} if "parent" in ladder else {}),
        "ok": True,
    }


#: phase 22: the recorder's windows (steps each, string stepper at
#: K 1), the token stepper's windows, the profiled window, the fast
#: world's resumed steps, det dispatches per side of a checkpoint, the
#: watchdog budget of the fetch fault, and where the files go (a
#: git-ignored directory of the checkout, removed afterwards)
GUARD_STEPS = 30
GUARD_TOKEN_STEPS = 20
GUARD_TRACE_STEPS = 5
GUARD_RESUME_STEPS = 10
GUARD_DET_DISPATCHES = {1: 6, 4: 3}
GUARD_FETCH_TIMEOUT = 2.0
GUARD_DIR = ROOT / "build" / "chip_smoke_guard"
#: the det stepper of phase 22 at phase 13's 500 cells
GUARD_DET_KW = dict(
    mol_name="ATP", kill_below=1.0, divide_above=3.0, divide_cost=1.0,
    target_cells=DET_CELLS, genome_size=DET_GENOME, lag=2, max_divisions=256,
    spawn_block=64, push_block=64, p_mutation=1e-4, p_recombination=1e-5,
)


def _det_world(genome_backend: str = "string", telemetry=None):
    """Phase 13's 500 cells as a stepper's world (det mode must be on)."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY

    w = mt.World(chemistry=CHEMISTRY, map_size=DET_MAP, seed=DET_SEED,
                 genome_backend=genome_backend, telemetry=telemetry)
    rng = random.Random(DET_SEED)
    w.spawn_cells([mt.random_genome(s=DET_GENOME, rng=rng) for _ in range(DET_CELLS)])
    if not w.deterministic or w.integrator != "torch-det":
        raise AssertionError("phase 22's det world does not run det mode")
    return w


def _run_state(world, st) -> dict:
    """A run's whole resume-relevant state: the world's arrays (through
    ``guard.snapshot_run``, which flushes the stepper) plus the random
    streams, the device key and the stepper's schedule, as arrays."""
    import numpy as np

    from magicsoup_tpu_torch import guard

    snap = guard.snapshot_run(world, st)
    aux = snap["stepper"]
    sched = repr((snap["world_rng_state"], snap["world_nprng_state"], aux["rng_state"],
                  aux["spawn_queue"], aux["growth_hist"], aux["change_seq"],
                  aux["dispatched_seq"]))
    return {
        **_state_arrays(world),
        "key": np.asarray(aux["key"]),
        "schedule": np.frombuffer(sched.encode(), dtype=np.uint8),
    }


def _fast_arrays(world) -> dict:
    """A 10k world's structure and molecules (no parameters: those are
    ~400 MB at capacity)."""
    import numpy as np

    n = world.n_cells
    return {
        "molecule_map": world.molecule_map.cpu().numpy(),
        "cell_molecules": np.asarray(world.cell_molecules)[:n],
        "positions": np.asarray(world.cell_positions),
        "lifetimes": np.asarray(world.cell_lifetimes),
        "divisions": np.asarray(world.cell_divisions),
        "genomes": np.frombuffer("\n".join(world.cell_genomes).encode(), dtype=np.uint8),
    }


def _audit_codes(world):
    """The deep audit's violation codes, as ``_resume_child`` stores them."""
    import numpy as np

    from magicsoup_tpu_torch.check import audit_world

    codes = repr(sorted(v.code for v in audit_world(world)))
    return np.frombuffer(codes.encode(), dtype=np.uint8)


def _recorder_windows(torch, tmp: Path) -> tuple[dict, object, object]:
    """Phase 22.1: the classic world with a recorder attached (K1), then
    the string stepper at K 1 on it, 30 steps each way in the order
    detached, attached, attached, detached, with the census checked in
    every window; the enqueue sync-free with the recorder attached; the
    JSONL validated and summarized.  Returns the numbers, the world and
    its stepper (the resume and trace parts go on from them)."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import telemetry
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_params, cuda_prng
    from magicsoup_tpu_torch.workload import sim_step

    path = tmp / "run.jsonl"
    world, spawn_s = _workload(torch)
    world.telemetry.attach(path)
    atp = CHEMISTRY.molname_2_idx["ATP"]
    rng = random.Random(SEED)
    ci.launches = cuda_params.launches = 0
    for _ in range(5):
        sim_step(world, rng, n_cells=N_CELLS, genome_size=GENOME_SIZE, atp_idx=atp)
    torch.cuda.synchronize()
    classic_launches, classic_assembly = ci.launches, cuda_params.launches
    if classic_launches != 5 or classic_assembly == 0:
        raise AssertionError(f"classic world with a recorder: {classic_launches} K1 launches"
                             f" and {classic_assembly} assembly launches in 5 steps")
    st = mt.PipelinedStepper(world, megastep=1, **STEPPER_KW)
    if st.telemetry is not world.telemetry:
        raise AssertionError("the stepper does not share the world's recorder")
    for _ in range(STEPPER_WARMUP):
        st.step()
    st.drain()
    # one dispatch with the fetcher idle and the recorder attached: the
    # enqueue (dispatch row included) must not synchronize
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    st.drain()
    windows = []
    for attached in (False, True, True, False):
        if attached and not world.telemetry.attached:
            world.telemetry.attach(path)
        elif not attached and world.telemetry.attached:
            world.telemetry.detach()
        torch.cuda.synchronize()
        rows0 = world.telemetry.rows_emitted
        bytes0 = path.stat().st_size
        runtime.reset_counters()
        ci.launches = 0
        cuda_prng.launches = 0
        t0 = time.perf_counter()
        for _ in range(GUARD_STEPS):
            st.step()
        st.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        census = runtime.snapshot()
        if ci.launches != GUARD_STEPS:
            raise AssertionError(f"recorder window: {ci.launches} K2 launches in {GUARD_STEPS} steps")
        if census["device_dispatches"] != GUARD_STEPS:
            raise AssertionError(f"device-time census: {census['device_dispatches']} entries"
                                 f" for {GUARD_STEPS} dispatches")
        if census["device_time_us"] > dt * 1e6:
            raise AssertionError(f"device-time census {census['device_time_us']} us exceeds"
                                 f" the window's {dt * 1e6:.0f} us")
        world.telemetry.flush()
        windows.append({
            "attached": attached,
            "steps_per_s": GUARD_STEPS / dt,
            "window_s": dt,
            "launches": ci.launches,
            "threefry_launches": cuda_prng.launches,
            "rows": world.telemetry.rows_emitted - rows0,
            "bytes": path.stat().st_size - bytes0,
            "device_time_us": census["device_time_us"],
            "device_dispatches": census["device_dispatches"],
        })
    for w in windows:
        want = 2 * GUARD_STEPS if w["attached"] else 0
        if w["rows"] < want:
            raise AssertionError(f"recorder window wrote {w['rows']} rows, want >= {want}")
    world.telemetry.attach(path)
    st.flush()  # the counters row and the buffered rows go to disk
    world.telemetry.detach()
    rows = telemetry.read_jsonl(path)
    problems = telemetry.validate_rows(rows)
    if problems:
        raise AssertionError(f"the recorder's JSONL does not validate: {problems[:5]}")
    summary = telemetry.summarize_rows(rows)
    _check_state(world, "phase 22 recorder windows")
    on = [w["steps_per_s"] for w in windows if w["attached"]]
    off = [w["steps_per_s"] for w in windows if not w["attached"]]
    return {
        "classic_with_recorder": {"steps": 5, "k1_launches": classic_launches,
                                  "assembly_launches": classic_assembly},
        "windows": windows,
        "steps_per_s_attached": on,
        "steps_per_s_detached": off,
        "overhead_share": 1.0 - (sum(on) / len(on)) / (sum(off) / len(off)),
        "sync_free_dispatch_attached": True,
        "jsonl_rows": len(rows),
        "jsonl_bytes": path.stat().st_size,
        "validate_rows": problems,
        "summary": {"steps": summary["steps"], "dispatches": summary["dispatches"],
                    "phases": summary["phases"], "final": summary["final"]},
        "spawn_s": spawn_s,
    }, world, st


def _token_fetch_windows(torch, tmp: Path) -> dict:
    """Phase 22.1's token part: two token worlds from one seed, the
    stepper at K 1 on each for 20 steps after its warm-up, the recorder
    detached on the first and attached on the second: the same
    trajectory, so the whole-store fetches per step must be equal (the
    step row reads the store's length vector alone)."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    out = {}
    for attached in (False, True):
        world, _ = _workload(torch, genome_backend="token")
        st = mt.PipelinedStepper(world, megastep=1, **STEPPER_KW)
        for _ in range(STEPPER_WARMUP):
            st.step()
        st.drain()
        if attached:
            world.telemetry.attach(tmp / "token.jsonl")
        torch.cuda.synchronize()
        g0 = runtime.genome_stats()
        ci.launches = 0
        t0 = time.perf_counter()
        for _ in range(GUARD_TOKEN_STEPS):
            st.step()
        st.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        g1 = runtime.genome_stats()
        if ci.launches != GUARD_TOKEN_STEPS:
            raise AssertionError(f"token window: {ci.launches} K2 launches")
        st.flush()
        world.telemetry.detach()
        _check_state(world, "phase 22 token windows")
        out["attached" if attached else "detached"] = {
            "steps_per_s": GUARD_TOKEN_STEPS / dt,
            "launches": ci.launches,
            "n_cells": world.n_cells,
            **{f"{k}_per_step": (g1[k] - g0[k]) / GUARD_TOKEN_STEPS
               for k in ("genome_fetches", "genome_fetch_bytes", "genome_length_fetches",
                         "genome_length_fetch_bytes", "genome_decode_calls")},
        }
        del world, st
    off, on = out["detached"], out["attached"]
    if (on["genome_fetches_per_step"], on["n_cells"]) != (off["genome_fetches_per_step"], off["n_cells"]):
        raise AssertionError(f"token store fetches per step: {off} detached, {on} attached")
    return out


def _det_recorder_on_off(torch, tmp: Path) -> dict:
    """Phase 22.2: det mode at 500 cells, the stepper at K 1 with the
    recorder on and off, string and token: bit-equal state."""
    import magicsoup_tpu_torch as mt

    out = {}
    with _det_env():
        for backend in ("string", "token"):
            states = []
            for telemetry in (None, tmp / f"det_{backend}.jsonl"):
                w = _det_world(backend, telemetry)
                st = mt.PipelinedStepper(w, megastep=1, **GUARD_DET_KW)
                for _ in range(DET_DISPATCHES):
                    st.step()
                states.append(_run_state(w, st))
                w.telemetry.detach()
            div = _first_divergence(*states)
            if div is not None:
                raise AssertionError(f"det {backend}: recorder on and off diverge: {div}")
            out[backend] = {"dispatches": DET_DISPATCHES, "bit_equal": True,
                            "n_cells": int(states[0]["positions"].shape[0])}
    return out


def _trace_check(torch, st, tmp: Path) -> dict:
    """Phase 22.3: ``trace_window`` around 5 stepper steps (5 K2
    launches); the Chrome trace must exist and hold the ``ms:*`` ranges
    and the K2 kernel, whose records in it are counted."""
    from magicsoup_tpu_torch import telemetry
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    ci.launches = 0
    with telemetry.trace_window(tmp / "trace") as prof:
        for _ in range(GUARD_TRACE_STEPS):
            st.step()
        st.drain()
        torch.cuda.synchronize()
    path = Path(prof.trace_path)
    doc = json.loads(path.read_text())
    names = [e.get("name", "") for e in doc.get("traceEvents", [])]
    ranges = sorted({n for n in names if n.startswith("ms:")})
    k2 = sum(1 for e in doc["traceEvents"]
             if "integrate_kernel" in e.get("name", "") and e.get("cat") == "kernel")
    if not {"ms:activity", "ms:physics", "ms:divide"} <= set(ranges):
        raise AssertionError(f"trace_window: ms:* ranges missing, found {ranges}")
    # the launch count is exact; the trace must hold the kernel (a full
    # run's trace has dropped one of the window's 5 kernel records)
    if k2 < 1 or ci.launches != GUARD_TRACE_STEPS:
        raise AssertionError(f"trace_window: {k2} K2 kernels in the trace, {ci.launches} launches")
    return {"bytes": path.stat().st_size, "ranges": ranges, "k2_launches": ci.launches,
            "k2_kernels_in_trace": k2, "events": len(names)}


def _resume_child(torch, job_path: Path) -> None:
    """The fresh process of phase 22.4 (``--resume-child JOBS``): restores
    every job's checkpoint onto the card and continues it; writes the
    states and numbers beside the jobs."""
    import numpy as np

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import guard
    from magicsoup_tpu_torch.check import audit_world
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    jobs = json.loads(job_path.read_text())
    report = {}
    for name, job in jobs.items():
        with _det_env(job["det"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            world, aux, meta = guard.restore_run(
                guard.CheckpointManager(job["dir"]), device="cuda", audit=job["audit"]
            )
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            st = mt.PipelinedStepper(world, **job["kwargs"])
            guard.restore_stepper(st, aux)
            per_step = []
            for _ in range(job["dispatches"]):
                ci.launches = 0
                st.step()
                per_step.append(ci.launches)
            if job["det"]:
                arrays = _run_state(world, st)
            else:
                st.flush()
                arrays = _fast_arrays(world)
            arrays["audit"] = np.frombuffer(
                repr(sorted(v.code for v in audit_world(world))).encode(), dtype=np.uint8
            )
            np.savez(Path(job["dir"]) / "resumed.npz", **arrays)
            report[name] = {"restore_s": restore_s, "launches_per_dispatch": per_step,
                            "meta_step": meta["step"], "n_cells": world.n_cells,
                            "device": str(world.device)}
    report["_jax_loaded"] = "jax" in sys.modules or "magicsoup_tpu" in sys.modules
    (job_path.parent / "report.json").write_text(json.dumps(report))


def _resume_cases(torch, world, st, tmp: Path) -> dict:
    """Phase 22.4: det mode at 500 cells (string K 1 and 4, token K 1)
    and the 10k fast world of 22.1: [n dispatches, save_run, n] here
    against [n, save_run] here and restore + n in one fresh process."""
    import numpy as np

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import guard
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    jobs, refs = {}, {}
    with _det_env():
        for backend, k in (("string", 1), ("string", 4), ("token", 1)):
            name = f"det_{backend}_K{k}"
            n = GUARD_DET_DISPATCHES[k]
            kwargs = dict(GUARD_DET_KW, megastep=k)
            wa = _det_world(backend)
            sa = mt.PipelinedStepper(wa, **kwargs)
            for _ in range(n):
                sa.step()
            guard.save_run(guard.CheckpointManager(tmp / name / "ref"), wa, sa, step=n)
            for _ in range(n):
                sa.step()
            refs[name] = _run_state(wa, sa)
            refs[name]["audit"] = _audit_codes(wa)
            wb = _det_world(backend)
            sb = mt.PipelinedStepper(wb, **kwargs)
            for _ in range(n):
                sb.step()
            guard.save_run(guard.CheckpointManager(tmp / name), wb, sb)
            del wa, sa, wb, sb
            # the det worlds are not audited at the restore: the dead-row
            # parameter residue of ROADMAP C3 may show at a flush (the
            # JAX package's too); their audits are compared instead
            jobs[name] = {"dir": str(tmp / name), "kwargs": kwargs, "dispatches": n,
                          "det": True, "audit": False}
    # the 10k fast world: its checkpoint, then the uninterrupted steps
    mgr = guard.CheckpointManager(tmp / "fast_10k")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = guard.save_run(mgr, world, st)
    save_s = time.perf_counter() - t0
    save_bytes = path.stat().st_size
    ci.launches = 0
    for _ in range(GUARD_RESUME_STEPS):
        st.step()
    st.flush()
    ref_launches = ci.launches
    refs["fast_10k"] = _fast_arrays(world)
    refs["fast_10k"]["audit"] = _audit_codes(world)
    jobs["fast_10k"] = {"dir": str(tmp / "fast_10k"), "kwargs": dict(STEPPER_KW, megastep=1),
                        "dispatches": GUARD_RESUME_STEPS, "det": False, "audit": True}
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--resume-child", str(tmp / "jobs.json")],
        capture_output=True, text=True, timeout=600,
    )
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the resume process failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    report = json.loads((tmp / "report.json").read_text())
    if report.pop("_jax_loaded"):
        raise AssertionError("the resume process loaded JAX")
    out = {"child_s": child_s}
    for name, ref in refs.items():
        got = dict(np.load(Path(jobs[name]["dir"]) / "resumed.npz"))
        rep = report[name]
        audit = got["audit"].tobytes().decode()
        if name == "fast_10k" and audit != "[]":
            raise AssertionError(f"{name}: the resumed world fails the audit: {audit}")
        # one K2 launch per simulated step in fast mode; det mode runs the
        # det integrator, no kernel
        k = 0 if jobs[name]["det"] else jobs[name]["kwargs"]["megastep"]
        if rep["launches_per_dispatch"] != [k] * jobs[name]["dispatches"]:
            raise AssertionError(f"{name}: K2 launches per resumed dispatch {rep['launches_per_dispatch']}")
        div = _first_divergence(ref, got)
        entry = {"restore_s": rep["restore_s"], "n_cells": rep["n_cells"], "audit": audit,
                 "launches_per_dispatch": rep["launches_per_dispatch"],
                 "bit_equal": div is None, "first_divergence": div}
        if name.startswith("det_") and div is not None:
            raise AssertionError(f"{name}: the resumed run diverges: {div}")
        if name == "fast_10k":
            cm = got["cell_molecules"]
            if not (np.isfinite(cm).all() and (cm >= 0).all()
                    and np.isfinite(got["molecule_map"]).all() and (got["molecule_map"] >= 0).all()):
                raise AssertionError("fast_10k: the resumed state is not finite and >= 0")
            if div is not None:
                # fast mode: structure bit-equal, molecules per-cell
                for key in ("positions", "lifetimes", "divisions", "genomes"):
                    if ref[key].tobytes() != got[key].tobytes():
                        raise AssertionError(f"fast_10k: resumed structure differs in {key}")
                rel = np.abs(cm - ref["cell_molecules"]) / (np.abs(ref["cell_molecules"]) + 1e-6)
                scale = np.maximum(np.abs(ref["cell_molecules"]).max(axis=1), 1e-6)
                norm = np.abs(cm - ref["cell_molecules"]).max(axis=1) / scale
                entry["cells_within_1e-4"] = float((rel.max(axis=1) < 1e-4).mean())
                entry["cells_within_0.01"] = float((norm < 0.01).mean())
                entry["cells_beyond_0.25"] = int((norm >= 0.25).sum())
                if entry["cells_within_1e-4"] < 0.85 or entry["cells_within_0.01"] < 0.98:
                    raise AssertionError(f"fast_10k: resumed molecules off the contract: {entry}")
            entry.update(save_s=save_s, save_bytes=save_bytes, steps=GUARD_RESUME_STEPS,
                         uninterrupted_launches=ref_launches)
        out[name] = entry
    return out


def _fault_cases(torch, tmp: Path) -> dict:
    """Phase 22.5: each injected fault on the card gives its typed
    outcome."""
    import errno
    import warnings

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import guard
    from magicsoup_tpu_torch.guard import chaos
    from magicsoup_tpu_torch.guard import watchdog

    out = {}
    with _det_env():
        # dispatch:transient x2, absorbed by dispatch_retries=3
        states, retries = [], []
        for spec in (None, "dispatch:transient@2x2"):
            w = _det_world()
            st = mt.PipelinedStepper(w, megastep=1, dispatch_retries=3, **GUARD_DET_KW)
            if spec:
                chaos.arm(spec)
            try:
                for _ in range(4):
                    st.step()
            finally:
                chaos.disarm()
            retries.append(st.stats["dispatch_retries"])
            states.append(_run_state(w, st))
        div = _first_divergence(*states)
        if retries != [0, 2] or div is not None:
            raise AssertionError(f"dispatch fault: retries {retries}, divergence {div}")
        out["dispatch_transient_x2"] = {"retries": retries[1], "bit_equal": True}

        # fetch:delay past a 2 s budget
        saved = os.environ.get("MAGICSOUP_GUARD_FETCH_TIMEOUT")
        os.environ["MAGICSOUP_GUARD_FETCH_TIMEOUT"] = str(GUARD_FETCH_TIMEOUT)
        records = []
        dump = watchdog.dump_diagnostics
        watchdog.dump_diagnostics = lambda tag, extra=None: records.append(dump(tag, extra)) or records[-1]
        try:
            w = _det_world()
            st = mt.PipelinedStepper(w, megastep=1, **dict(GUARD_DET_KW, lag=1))
            if st._fetch_timeout != GUARD_FETCH_TIMEOUT:
                raise AssertionError(f"the stepper's fetch budget is {st._fetch_timeout}")
            st.step()
            chaos.arm("fetch:delay:5")
            t0 = time.perf_counter()
            try:
                st.step()
                raise AssertionError("fetch delay: no WatchdogTimeout")
            except guard.WatchdogTimeout as exc:
                waited = time.perf_counter() - t0
                phase = exc.phase
        finally:
            chaos.disarm()
            watchdog.dump_diagnostics = dump
            if saved is None:
                os.environ.pop("MAGICSOUP_GUARD_FETCH_TIMEOUT", None)
            else:
                os.environ["MAGICSOUP_GUARD_FETCH_TIMEOUT"] = saved
        if len(records) != 1 or phase != "fetch":
            raise AssertionError(f"fetch delay: {len(records)} diagnostics records, phase {phase}")
        out["fetch_delay"] = {"budget_s": GUARD_FETCH_TIMEOUT, "waited_s": waited,
                              "diagnostics": len(records),
                              "cuda_memory_allocated": records[0].get("cuda_memory_allocated")}
        del st, w

        # checkpoint.write:enospc@2 and a flipped newest checkpoint
        w = _det_world()
        st = mt.PipelinedStepper(w, megastep=1, **GUARD_DET_KW)
        mgr = guard.CheckpointManager(tmp / "faults", keep=3)
        chaos.arm("checkpoint.write:enospc@2")
        try:
            st.step()
            guard.save_run(mgr, w, st, step=1)
            st.step()
            try:
                guard.save_run(mgr, w, st, step=2)
                raise AssertionError("checkpoint.write:enospc@2: the second save did not fail")
            except OSError as exc:
                if exc.errno != errno.ENOSPC:
                    raise
        finally:
            chaos.disarm()
        counters = mgr.failure_counters()
        if counters["save_failures"] != 1 or [s for s, _ in mgr.checkpoints()] != [1]:
            raise AssertionError(f"enospc: counters {counters}, files {mgr.checkpoints()}")
        st.step()
        guard.save_run(mgr, w, st, step=3)
        guard.flip_byte(mgr.latest())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _payload, meta, used = mgr.load_latest()
        if meta["step"] != 1 or not any("skipping" in str(c.message) for c in caught):
            raise AssertionError(f"flip_byte: load_latest gave step {meta['step']}")
        out["checkpoint_enospc_at_2"] = {"failure_counters": counters}
        out["flip_byte_newest"] = {"loaded_step": meta["step"], "fell_back": True}
        del st, w

        # inject_nan under the three policies
        quiet = dict(GUARD_DET_KW, kill_below=-1.0, divide_above=1e30, target_cells=None,
                     p_mutation=0.0, p_recombination=0.0, lag=1)
        policies = {}
        for policy in ("warn", "quarantine", "rollback"):
            w = _det_world()
            st = mt.PipelinedStepper(w, megastep=1, sentinel_policy=policy, **quiet)
            st.step()
            st.drain()
            n_before = w.n_cells
            guard.inject_nan(st, row=3, mol=2)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    for _ in range(3):
                        st.step()
                    st.drain()
                    raised = None
                except guard.SentinelTripped as exc:
                    raised = exc
            warned = any("sentinel" in str(c.message) for c in caught)
            if policy == "rollback":
                if raised is None or raised.n_bad_cells < 1:
                    raise AssertionError("rollback: no SentinelTripped")
                policies[policy] = {"raised": type(raised).__name__, "flags": raised.flags}
                continue
            st.flush()
            if policy == "warn" and not (warned and st.stats["sentinel_trips"] >= 1):
                raise AssertionError(f"warn: warned {warned}, trips {st.stats['sentinel_trips']}")
            if policy == "quarantine":
                cm = w.cell_molecules
                import numpy as np

                if not (st.stats["quarantined"] >= 1 and w.n_cells < n_before
                        and np.isfinite(cm).all()):
                    raise AssertionError(f"quarantine: {st.stats['quarantined']} quarantined")
            policies[policy] = {"sentinel_trips": st.stats["sentinel_trips"],
                                "quarantined": st.stats["quarantined"], "warned": warned,
                                "n_cells": [n_before, w.n_cells]}
        out["inject_nan"] = policies
    return out


def _guard_phase(torch) -> tuple[dict, dict]:
    """Phase 22: telemetry and guard on the card; returns its record and
    the kernels' launches on its paths."""
    import shutil

    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_prng

    shutil.rmtree(GUARD_DIR, ignore_errors=True)
    GUARD_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        recorder, world, st = _recorder_windows(torch, GUARD_DIR)
        recorder["trace_window"] = _trace_check(torch, st, GUARD_DIR)
        ci.launches = cuda_prng.launches = 0
        resume = _resume_cases(torch, world, st, GUARD_DIR)
        resume_threefry = cuda_prng.launches
        del world, st
        recorder["token"] = _token_fetch_windows(torch, GUARD_DIR)
        det = _det_recorder_on_off(torch, GUARD_DIR)
        faults = _fault_cases(torch, GUARD_DIR)
    finally:
        shutil.rmtree(GUARD_DIR, ignore_errors=True)
    launches = {
        "k1_classic_with_recorder": recorder["classic_with_recorder"]["k1_launches"],
        "assembly_classic_with_recorder": recorder["classic_with_recorder"]["assembly_launches"],
        "k2_recorder_windows": [w["launches"] for w in recorder["windows"]],
        "k2_trace_window": recorder["trace_window"]["k2_launches"],
        "k2_resumed_fast_10k": resume["fast_10k"]["launches_per_dispatch"],
        "k2_token_windows": [v["launches"] for v in recorder["token"].values()],
        "threefry_recorder_windows": [w["threefry_launches"] for w in recorder["windows"]],
        "threefry_resume_cases_parent": resume_threefry,
    }
    return {"recorder": recorder, "det_recorder_on_off": det, "resume": resume,
            "faults": faults, "wall_s": time.perf_counter() - t0}, launches


# --------------------------------------------------------------------- #
# phase 23: the grouped launch and the rest of the fleet                #
# --------------------------------------------------------------------- #

#: the grouped launch's seeded groups, (worlds, rows) at GROUPED_PS, then
#: one group of SWEEP_CELLS rows at the first SWEEP_SHAPES entry whose
#: launch plan is not the resident route
GROUPED_GROUPS = ((2, 16384), (2, 32768))
GROUPED_PS = (32, 28)
#: the mixed-rung fleet, per rung: target cells, map size, seeds, capacity
MIXED_RUNGS = ((10_000, 128, (42, 43), 16384), (20_000, 256, (44, 45), 32768))
MIXED_WINDOW = 15
MIXED_PROFILE = 5
AUTO_STEPS = 10
#: the warden: phase 7's four worlds under heal, cadence 10, keep 2;
#: world 2 poisoned after step 5
WARDEN_STEPS = 20
WARDEN_POISON_AFTER = 5
WARDEN_WORLD = 2
#: the restored world's steps after restore_world
FLEET_RESTORE_STEPS = 10
FLEET_DIR = ROOT / "build" / "chip_smoke_fleet"
#: where restore_world places the world
FLEET_DEVICE = "cuda"


def _mixed_kw(target: int) -> dict:
    """A mixed-fleet lane's stepper arguments: phase 7's selection at
    K = 1 and its rung's target, at the rung's capacity: with growth on,
    a world whose divisions crowd its capacity doubles it and moves to
    another rung mid-window."""
    return dict(STEPPER_KW, target_cells=target, megastep=1, auto_grow=False)


def _device_inputs(torch, B: int, c: int, p: int, s: int, seed: int):
    """Seeded integrator inputs of B worlds of c rows, drawn on the card
    in the ranges of performance/pallas_bisect.py, rows 8-15 of every
    world dead."""
    from magicsoup_tpu_torch.ops.integrate import CellParams

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int16)

    params = CellParams(
        Ke=uniform((B, c, p), 0.1, 10), Kmf=uniform((B, c, p), 0.1, 10),
        Kmb=uniform((B, c, p), 0.1, 10), Kmr=uniform((B, c, p, s), 0.1, 10),
        Vmax=uniform((B, c, p), 0, 2), N=ints((B, c, p, s), -2, 3),
        Nf=ints((B, c, p, s), 0, 3), Nb=ints((B, c, p, s), 0, 3), A=ints((B, c, p, s), -2, 3),
    )
    for t in params:
        t[:, 8:16] = 0
    return uniform((B, c, s), 0, 4), params


def _grouped_times(torch, groups) -> dict:
    """The grouped launch against the groups' own launches, timed in
    turns (own, grouped, grouped, own), the plain version's time, host
    microseconds per call of each, CTAs per SM and the bound summed over
    the groups."""
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.performance import cuda_median_ms

    Xs, ps = [X for X, _ in groups], [prm for _, prm in groups]
    grouped = lambda: ci.integrate_signals_cuda_grouped(Xs, ps)  # noqa: E731
    own = lambda: [ci.integrate_signals_cuda(X, prm) for X, prm in groups]  # noqa: E731
    times = [cuda_median_ms(f, KERNEL_REPS) for f in (own, grouped, grouped, own)]
    plain_ms = cuda_median_ms(
        lambda: [ci.integrate_signals_tiled(X, prm, ci.TILE_C) for X, prm in groups], PLAIN_REPS)
    bounds = [_bound(torch, X, prm) for X, prm in groups]
    bytes_ms = sum(b["bytes_ms"] for b in bounds)
    ops_ms = sum(b["operations_ms"] for b in bounds)
    return {
        "ms": (times[1] + times[2]) / 2,
        "separate_ms": (times[0] + times[3]) / 2,
        "ms_in_turns": times,
        "plain_ms": plain_ms,
        "host_us_per_call": _host_us(torch, grouped),
        "separate_host_us_per_call": _host_us(torch, own),
        "occupancy": ci.grouped_occupancy(Xs, ps),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": sum(b["bytes"] for b in bounds),
        "bytes_ms": bytes_ms,
        "operations": sum(b["operations"] for b in bounds),
        "operations_ms": ops_ms,
    }


def _grouped_seeded(torch) -> dict:
    """Phase 23.1: the grouped launch over seeded groups; each world's
    sha256 equal to its group's own launch's, each group under the fast
    contract against the plain version, dead rows unchanged, one launch
    per route."""
    import numpy as np

    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    limit = ci.smem_limit(0)
    off = next((ps for ps in SWEEP_SHAPES if ci.launch_plan(*ps, limit).route != "resident"), None)
    if off is None:
        raise AssertionError("grouped launch: every SWEEP_SHAPES entry is on the resident route")
    specs = [(B, c) + GROUPED_PS for B, c in GROUPED_GROUPS] + [(1, SWEEP_CELLS) + off]
    groups = [_device_inputs(torch, *spec, seed=300 + g) for g, spec in enumerate(specs)]
    routes = {ci.launch_plan(prm.Ke.shape[-1], X.shape[2], limit).route == "resident"
              for X, prm in groups}
    before = ci.grouped_launches
    outs = ci.integrate_signals_cuda_grouped([X for X, _ in groups], [prm for _, prm in groups])
    torch.cuda.synchronize()
    launched = ci.grouped_launches - before
    if launched != len(routes):
        raise AssertionError(f"grouped launch: {launched} launches for {len(routes)} routes")
    per_group, max_abs = [], 0.0
    for g, ((X, prm), out) in enumerate(zip(groups, outs)):
        own = ci.integrate_signals_cuda(X, prm)
        ref = ci.integrate_signals_tiled(X, prm, ci.TILE_C)
        torch.cuda.synchronize()
        for w in range(X.shape[0]):
            if _sha256(out[w]) != _sha256(own[w]):
                raise AssertionError(f"grouped launch: group {g} world {w} differs from its own launch")
        if not torch.equal(out[:, 8:16], X[:, 8:16]):
            raise AssertionError(f"grouped launch: group {g}: dead rows changed")
        out_np, ref_np = out.cpu().numpy(), ref.cpu().numpy()
        if not (np.isfinite(out_np).all() and (out_np >= 0).all()):
            raise AssertionError(f"grouped launch: group {g} is not finite and >= 0")
        q99, rel_max, abs_max = _fast_errors(out_np, ref_np)
        if not (q99 < 1e-4 and rel_max < 0.15):
            raise AssertionError(f"grouped launch: group {g} vs plain: q99 {q99}, max {rel_max}")
        max_abs = max(max_abs, abs_max)
        B, c, s = X.shape
        per_group.append({
            "B": B, "c": c, "p": prm.Ke.shape[-1], "s": s,
            "route": ci.launch_plan(prm.Ke.shape[-1], s, limit).route,
            "q99_rel_err": q99, "max_rel_err": rel_max, "max_abs_err": abs_max,
            "worlds_sha256_equal_own_launch": True,
        })
    got = {"groups": per_group, "launches": launched, "max_abs_err": max_abs,
           **_grouped_times(torch, groups)}
    print(f"grouped launch, seeded: {len(groups)} groups in {launched} launches,"
          f" {got['ms']:.4f} ms against {got['separate_ms']:.4f} ms for the groups' own"
          f" launches (bound {got['bound_ms']:.4f} ms), occupancy {got['occupancy']}", flush=True)
    return got


class _GroupedTap:
    """Keeps a copy of the grouped integrator call's inputs at its first
    call after :meth:`arm` (the copy launches no kernel)."""

    def __init__(self):
        self.inputs = None
        self._armed = False

    def arm(self) -> None:
        self._armed, self.inputs = True, None

    def __enter__(self):
        from magicsoup_tpu_torch.ops import backends
        from magicsoup_tpu_torch.ops.integrate import CellParams

        self._inner = inner = backends.integrate_grouped
        tap = self

        def tapped(names, Xs, params_list):
            if tap._armed:
                tap._armed = False
                tap.inputs = [(X.clone(), CellParams(*(t.clone() for t in prm)))
                              for X, prm in zip(Xs, params_list)]
            return inner(names, Xs, params_list)

        backends.integrate_grouped = tapped
        return self

    def __exit__(self, *exc):
        from magicsoup_tpu_torch.ops import backends

        backends.integrate_grouped = self._inner


def _mixed_fleets(torch, taps: _Taps, gtap: _GroupedTap) -> tuple[dict, dict]:
    """Phase 23.2: two fleets of the same four worlds on two rungs, one
    per rung and one fused, in interleaved windows; returns the record
    and the fleets."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_prng
    from magicsoup_tpu_torch.telemetry.recorder import fetch_stats

    fleets = {}
    for fusion in ("rung", "fleet"):
        fleet = mt.FleetScheduler(block=2, fusion=fusion)
        worlds = []
        for target, size, seeds, cap in MIXED_RUNGS:
            for seed in seeds:
                w = _workload(torch, seed=seed, n_cells=target, map_size=size)[0]
                if w._capacity != cap:
                    raise AssertionError(f"mixed fleet: a {target}-cell world has capacity {w._capacity}")
                fleet.admit(w, **_mixed_kw(target))
                worlds.append(w)
        fleets[fusion] = (fleet, worlds)
    n_worlds = len(fleets["rung"][1])
    taps.window = "mixed fleet warm-up"
    for fleet, _ in fleets.values():
        fleet.step()
        fleet.drain()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    windows, launches, threefry = [], {"rung": 0, "fleet": 0}, 0
    for i, fusion in enumerate(("rung", "fleet", "fleet", "rung")):
        fleet, _ = fleets[fusion]
        taps.window = f"mixed fleet {fusion} window {i}"
        if i == 1:
            gtap.arm()
        runtime.reset_counters()
        ci.launches = ci.grouped_launches = cuda_prng.launches = 0
        fetch0 = fetch_stats()["fetches"]
        t0 = time.perf_counter()
        for _ in range(MIXED_WINDOW):
            fleet.step()
        fleet.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        census = runtime.snapshot()
        n_groups = len([g for sib in fleet._groups.values() for g in sib])
        want = ((MIXED_WINDOW, MIXED_WINDOW, 0) if fusion == "fleet"
                else (n_groups * MIXED_WINDOW, 0, n_groups * MIXED_WINDOW))
        got = (census["dispatches"], ci.grouped_launches, ci.launches)
        if n_groups != 2 or got != want:
            raise AssertionError(f"mixed fleet {fusion}: {n_groups} groups; (dispatches, grouped"
                                 f" launches, K2 launches) {got}, want {want}; capacities"
                                 f" {[lane._cap for lane in fleet.lanes]}")
        launches[fusion] += ci.grouped_launches if fusion == "fleet" else ci.launches
        threefry += cuda_prng.launches
        windows.append({
            "fusion": fusion,
            "fleet_steps_per_s": MIXED_WINDOW / dt,
            "world_steps_per_s": n_worlds * MIXED_WINDOW / dt,
            "window_s": dt,
            "dispatches_per_fleet_step": census["dispatches"] / MIXED_WINDOW,
            "fused_groups_per_fleet_step": census["fused_groups"] / MIXED_WINDOW,
            "fetches_per_fleet_step": (fetch_stats()["fetches"] - fetch0) / MIXED_WINDOW,
            "k2_launches_per_fleet_step": ci.launches / MIXED_WINDOW,
            "grouped_launches_per_fleet_step": ci.grouped_launches / MIXED_WINDOW,
            "threefry_launches_per_fleet_step": cuda_prng.launches / MIXED_WINDOW,
        })
        print(f"mixed fleet window {i} ({fusion}): {windows[-1]['world_steps_per_s']:.2f}"
              f" world-steps/s, {windows[-1]['dispatches_per_fleet_step']} dispatches,"
              f" {windows[-1]['fetches_per_fleet_step']} fetches,"
              f" {windows[-1]['k2_launches_per_fleet_step']} K2 and"
              f" {windows[-1]['grouped_launches_per_fleet_step']} grouped launches per fleet step",
              flush=True)
    profiles = {}
    for fusion, (fleet, _) in fleets.items():
        taps.window = f"mixed fleet {fusion} profiled"

        def _more(fleet=fleet):
            for _ in range(MIXED_PROFILE):
                fleet.step()
            fleet.drain()

        profiles[fusion] = _profile(torch, _more, MIXED_PROFILE)
    peak = torch.cuda.max_memory_allocated()
    taps.window = "mixed fleet flush"
    for fleet, _ in fleets.values():
        fleet.flush()
    for i in range(n_worlds):
        a, b = fleets["rung"][1][i], fleets["fleet"][1][i]
        _check_state(b, f"mixed fleet world {i}")
        diff = _first_divergence(_state_arrays(a), _state_arrays(b))
        if diff is not None:
            raise AssertionError(f"mixed fleet world {i}: the fused world differs from its"
                                 f" per-rung twin: {diff}")
    summed = {f: sum(w["world_steps_per_s"] for w in windows if w["fusion"] == f) / 2
              for f in ("rung", "fleet")}
    return {
        "windows": windows,
        "world_steps_per_s_mean": summed,
        "profile": profiles,
        "peak_mem_bytes": peak,
        "worlds": [{"n_cells": w.n_cells, "capacity": w._capacity} for w in fleets["fleet"][1]],
        "fused_bit_equal_to_per_rung": True,
        "launches": launches,
        "threefry_launches": threefry,
    }, fleets


def _grouped_real_state(torch, inputs) -> dict:
    """Phase 23.3: the grouped launch on the fused fleet's own inputs at
    its first timed step: each group equal to its own launch, each under
    the real-state contract of phase 9 on its rows with a protein; the
    grouped and the own launches' times and the plain version's."""
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    outs = ci.integrate_signals_cuda_grouped([X for X, _ in inputs], [p for _, p in inputs])
    groups = []
    for g, ((X, prm), out) in enumerate(zip(inputs, outs)):
        if not torch.equal(out, ci.integrate_signals_cuda(X, prm)):
            raise AssertionError(f"grouped launch on the fleet's state: group {g} differs from its own launch")
        active = prm.Vmax.ne(0).any(-1)
        groups.append(_real_state_check(torch, X, prm, active, f"grouped launch, group {g}, fleet state"))
    return {"groups": groups, "max_abs_err": max(g["max_abs_err"] for g in groups),
            **_grouped_times(torch, inputs)}


def _auto_fusion(torch, fleets) -> dict:
    """Phase 23.4: the fused fleet's lanes readmitted into a
    ``fusion="auto"`` scheduler for AUTO_STEPS steps: the sets it forms
    and its envelope."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    fleet, worlds = fleets["fleet"]
    lanes = list(fleet.lanes)
    for lane in lanes:
        fleet.retire(lane)
    auto = mt.FleetScheduler(block=2, fusion="auto")
    for lane in lanes:
        auto.readmit(lane)
    plan = auto._plan_fusion
    sets = []

    def recorded(groups):
        got = plan(groups)
        sets.append([[lanes.index(lane) for g in s for _, lane in g.members()] for s in got])
        return got

    auto._plan_fusion = recorded
    ci.launches = ci.grouped_launches = 0
    t0 = time.perf_counter()
    for _ in range(AUTO_STEPS):
        auto.step()
    auto.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    auto.flush()
    for i, w in enumerate(worlds):
        _check_state(w, f"auto fleet world {i}")
    formed = sorted({json.dumps(s) for s in sets})
    print(f"fusion auto: sets {formed}, envelope {[auto._env_k, auto._env_rec]}", flush=True)
    return {"sets": [json.loads(s) for s in formed], "envelope": [auto._env_k, auto._env_rec],
            "world_steps_per_s": len(worlds) * AUTO_STEPS / dt,
            "k2_launches": ci.launches, "grouped_launches": ci.grouped_launches}


def _fleet_checkpoint(torch, fleets, tmp: Path) -> dict:
    """Phase 23.6: ``save_fleet`` of the per-rung mixed fleet, then
    ``restore_world`` of one 20k world onto the card with the audit: its
    arrays equal the lane's world at the save, then 10 steps with one K2
    launch each, state finite and >= 0, the audit empty."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import guard
    from magicsoup_tpu_torch.check import audit_world
    from magicsoup_tpu_torch.fleet import restore_world, save_fleet
    from magicsoup_tpu_torch.ops import cuda_integrate as ci

    fleet, worlds = fleets["rung"]
    index = 2  # the first 20k world
    path = tmp / "fleet.msck"
    t0 = time.perf_counter()
    save_fleet(path, fleet)
    save_s = time.perf_counter() - t0
    saved = _state_arrays(fleet.lanes[index].world)
    t0 = time.perf_counter()
    world, aux, meta = restore_world(path, index, device=FLEET_DEVICE, audit=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = _first_divergence(saved, _state_arrays(world))
    if diff is not None or world.device.type != FLEET_DEVICE:
        raise AssertionError(f"restore_world: differs from the lane at the save: {diff}, on {world.device}")
    st = mt.PipelinedStepper(world, **_mixed_kw(MIXED_RUNGS[1][0]))
    guard.restore_stepper(st, aux)
    ci.launches = 0
    for _ in range(FLEET_RESTORE_STEPS):
        st.step()
    st.drain()
    torch.cuda.synchronize()
    launches = ci.launches
    st.flush()
    _check_state(world, "restore_world")
    violations = audit_world(world)
    if launches != FLEET_RESTORE_STEPS or violations:
        raise AssertionError(f"restore_world: {launches} K2 launches in {FLEET_RESTORE_STEPS}"
                             f" steps, audit {violations}")
    print(f"fleet checkpoint: save_fleet {save_s:.3f} s, {path.stat().st_size} B;"
          f" restore_world {restore_s:.3f} s", flush=True)
    return {"save_fleet_s": save_s, "bytes": path.stat().st_size, "worlds": meta["worlds"],
            "restore_world_s": restore_s, "n_cells": world.n_cells,
            "bit_equal_to_lane": True, "audit": [], "restored_launches": launches}


def _warden_run(torch, tmp: Path, poison: bool) -> dict:
    """Phase 23.5's fleet: phase 7's four worlds under a heal warden
    (cadence 10, keep 2) for WARDEN_STEPS steps; with ``poison``,
    ``guard.inject_nan`` poisons world WARDEN_WORLD after step
    WARDEN_POISON_AFTER.  Returns the healthy worlds' arrays and what the
    warden did when."""
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import guard
    from magicsoup_tpu_torch.fleet import FleetWarden
    from magicsoup_tpu_torch.guard import resume

    worlds = [_workload(torch, seed=SEED + i)[0] for i in range(FLEET_WORLDS)]
    fleet = mt.FleetScheduler(block=FLEET_WORLDS)
    lanes = [fleet.admit(w, megastep=1, **STEPPER_KW) for w in worlds]
    warden = FleetWarden(fleet, policy="heal", checkpoint_dir=tmp, cadence=10, keep=2)
    spent = {"save_run": [], "restore_run": []}
    saved = (resume.save_run, resume.restore_run)

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name].append((warden._steps, time.perf_counter() - t0))
        return call

    resume.save_run = timed("save_run", saved[0])
    resume.restore_run = timed("restore_run", saved[1])
    # every trip the warden takes, decoded: (fleet step, label, kind, flags)
    trips = []
    report = warden.report

    def tapped(lane, kind, out):
        from magicsoup_tpu_torch.check.invariants import decode_invariants
        from magicsoup_tpu_torch.guard.sentinel import decode_health

        rec = warden._by_lane.get(id(lane))
        flags = decode_health(out.health) if kind == "sentinel" else decode_invariants(out.invariants)
        trips.append((warden._steps, rec.label if rec else None, kind,
                      sorted(k for k, v in flags.items() if v)))
        return report(lane, kind, out)

    warden.report = tapped
    heal = warden._heal
    heals = []

    def timed_heal(rec, step):
        t0 = time.perf_counter()
        heal(rec, step)
        heals.append({"world": rec.label, "step": step, "s": time.perf_counter() - t0})

    warden._heal = timed_heal
    events = {}
    try:
        for i in range(WARDEN_STEPS):
            fleet.step()
            if poison and i + 1 == WARDEN_POISON_AFTER:
                guard.inject_nan(lanes[WARDEN_WORLD])
            st = warden.status_of(WARDEN_WORLD)
            hits = (
                ("trip", any(t[1] == WARDEN_WORLD and t[2] == "sentinel" for t in trips)),
                ("evicted", "trip" in events and st.status in ("cooldown", "parked")),
                ("readmitted", "evicted" in events and st.status == "active"),
            )
            for name, hit in hits:
                if hit and name not in events:
                    events[name] = i + 1
        fleet.flush()
    finally:
        resume.save_run, resume.restore_run = saved
    healthy = {i: _state_arrays(w) for i, w in enumerate(worlds) if i != WARDEN_WORLD}
    for i, w in enumerate(worlds):
        if i != WARDEN_WORLD:
            _check_state(w, f"warden world {i}")
    cadence = {}
    for step, dt in spent["save_run"]:
        cadence[step] = cadence.get(step, 0.0) + dt
    return {"healthy": healthy, "events": events, "trips": trips,
            "statuses": [vars(s) for s in warden.statuses()],
            "cadence_save_s": cadence, "restore_s": [dt for _, dt in spent["restore_run"]],
            "heals": heals,
            "lane": next(rec.lane for rec in warden._records if rec.label == WARDEN_WORLD)}


def _warden_phase(torch, tmp: Path) -> dict:
    """Phase 23.5: the warden heals a poisoned world; the three healthy
    worlds bit-equal to a fault-free run on the same cadence."""
    clean = _warden_run(torch, tmp / "clean", poison=False)
    run = _warden_run(torch, tmp / "poisoned", poison=True)
    for i, arrays in clean["healthy"].items():
        diff = _first_divergence(arrays, run["healthy"][i])
        if diff is not None:
            raise AssertionError(f"warden: healthy world {i} differs from the fault-free run: {diff}")
    status = run["statuses"][WARDEN_WORLD]
    ev = run["events"]
    if not ({"trip", "evicted", "readmitted"} <= set(ev) and status["restarts"] >= 1
            and status["status"] == "active" and run["restore_s"]):
        raise AssertionError(f"warden: world {WARDEN_WORLD} was not healed: {status}, events {ev}")
    _check_state(run["lane"].world, "warden healed world")
    # the only sentinel trip is the poisoned world's; an invariant trip may
    # only be dead_param_residue, which the reference trips too (ROADMAP
    # C3) and on which the warden acts as on any trip
    for name, r in (("fault-free", clean), ("poisoned", run)):
        for step, label, kind, flags in r["trips"]:
            if kind == "sentinel" and not (r is run and label == WARDEN_WORLD):
                raise AssertionError(f"warden, {name} run: sentinel trip of world {label}: {flags}")
            if kind == "invariant" and flags != ["dead_param_residue"]:
                raise AssertionError(f"warden, {name} run: world {label} tripped {flags}")
    out = {
        "statuses": run["statuses"],
        "poisoned_after_step": WARDEN_POISON_AFTER,
        "trip_at_step": ev["trip"],
        "steps_trip_to_eviction": ev["evicted"] - ev["trip"],
        "steps_trip_to_readmission": ev["readmitted"] - ev["trip"],
        "cadence_save_s_4_worlds": {str(k): v for k, v in clean["cadence_save_s"].items()},
        "heal_restore_s": run["restore_s"],
        # each heal: restore_run, admission and restore_stepper
        "heals": run["heals"],
        "trips": run["trips"],
        "fault_free_trips": clean["trips"],
        "fault_free_statuses": clean["statuses"],
        "healthy_bit_equal_to_fault_free": True,
    }
    print(f"warden: trip at step {ev['trip']}, evicted {out['steps_trip_to_eviction']} and"
          f" readmitted {out['steps_trip_to_readmission']} steps later; heals {run['heals']};"
          f" invariant trips (fault-free, poisoned) {len(clean['trips'])},"
          f" {sum(t[2] == 'invariant' for t in run['trips'])}", flush=True)
    return out


def _fleet_phase(torch) -> dict:
    """Phase 23: the grouped launch and the rest of the fleet at the
    headline configuration; returns its record and the grouped kernel's
    entry of the kernels line."""
    import shutil

    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    FLEET_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        seeded = _grouped_seeded(torch)
        with _Taps() as taps, _GroupedTap() as gtap:
            mixed, fleets = _mixed_fleets(torch, taps, gtap)
        if taps.unexpected():
            raise AssertionError(f"mixed fleet: flags other than dead_param_residue: {taps.unexpected()}")
        mixed["flags_per_window"] = taps.flags
        if gtap.inputs is None:
            raise AssertionError("mixed fleet: the fused windows made no grouped integrator call")
        real = _grouped_real_state(torch, gtap.inputs)
        del gtap
        checkpoint = _fleet_checkpoint(torch, fleets, FLEET_DIR)
        auto = _auto_fusion(torch, fleets)
        del fleets
        warden = _warden_phase(torch, FLEET_DIR / "warden")
    finally:
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    record = {"grouped_seeded": seeded, "mixed_fleet": mixed, "grouped_real_state": real,
              "auto": auto, "warden": warden, "fleet_checkpoint": checkpoint,
              "wall_s": time.perf_counter() - t0}
    entry = {
        "name": "integrate_signals_grouped",
        "route": "cuda",
        "source": "magicsoup_tpu_torch/csrc/integrate.cu",
        "replaces": "magicsoup_tpu/ops/pallas_integrate.py:186",
        # the fused fleet's groups at its first timed step
        "shape": [{k: g["shape"][k] for k in ("B", "q", "p", "s")} for g in real["groups"]],
        "launches": mixed["launches"]["fleet"],
        "launches_per_fused_step": 1.0,
        "max_abs_err": max(seeded["max_abs_err"], real["max_abs_err"]),
        "ms": real["ms"],
        "separate_ms": real["separate_ms"],
        "plain_ms": real["plain_ms"],
        "bound_ms": real["bound_ms"],
        "bound_by": real["bound_by"],
        "library_ms": None,
        "occupancy": real["occupancy"],
        "seeded_ms": seeded["ms"],
        "seeded_separate_ms": seeded["separate_ms"],
        "ok": True,
    }
    return record, entry


#: phase 24: the serving plane (``magicsoup_tpu_torch.serve``)
SERVE_DIR = ROOT / "build" / "chip_smoke_serve"
SERVE_SEEDS = (42, 43)
SERVE_WARMUP = 3
SERVE_WINDOW = 40
SERVE_LATENCY = 20
SERVE_FUSED_STEPS = 10
#: the fused sub-leg's third tenant: another rung, chemistry only
SERVE_THIRD = dict(seed=44, map_size=64, n_cells=4000)
#: the det schedule of ``performance/smoke.py::serve_main`` at its sizes
SERVE_DET = (("t1", 7, 16), ("t2", 11, 16), ("t3", 17, 8))
SERVE_DET_CELLS = 24
SERVE_DET_GENOME = 200
SERVE_DET_K = 2
SERVE_TIMEOUT = 600
#: where phase 24 runs (a CPU rehearsal at a tiny size sets "cpu")
SERVE_DEVICE = "cuda"


def _serve_chemistry() -> dict:
    """The Wood-Ljungdahl chemistry as a tenant spec's ``chemistry``."""
    from magicsoup_tpu_torch.examples.wood_ljungdahl import MOLECULES, REACTIONS

    return {
        "molecules": [
            {"name": m.name, "energy": m.energy, "half_life": m.half_life,
             "diffusivity": m.diffusivity, "permeability": m.permeability}
            for m in MOLECULES
        ],
        "reactions": [[[m.name for m in subs], [m.name for m in prods]] for subs, prods in REACTIONS],
    }


def _serve_spec(tid: str, seed: int) -> dict:
    """A headline tenant: phase 5's world and phase 7's selection, K = 1."""
    return {
        "tenant": tid, "seed": seed, "map_size": MAP_SIZE, "n_cells": N_CELLS,
        "genome_size": GENOME_SIZE, "deterministic": False, "chemistry": _serve_chemistry(),
        "stepper": {"mol_name": "ATP", "kill_below": 1.0, "divide_above": 5.0, "divide_cost": 4.0,
                    "target_cells": N_CELLS, "lag": 2, "megastep": 1},
    }


def _serve_det_spec(tid: str, seed: int, map_size: int) -> dict:
    return {
        "tenant": tid, "seed": seed, "map_size": map_size, "n_cells": SERVE_DET_CELLS,
        "genome_size": SERVE_DET_GENOME,
        "chemistry": {
            "molecules": [{"name": "sv-a", "energy": 10000.0},
                          {"name": "sv-atp", "energy": 8000.0, "half_life": 100000}],
            "reactions": [[["sv-a"], ["sv-atp"]]],
        },
        "stepper": {"mol_name": "sv-atp", "megastep": SERVE_DET_K},
    }


def _http(port: int, method: str, path: str, body=None, raw: bool = False):
    """One request to a service on this host: (status, JSON body or text)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT) as resp:
            blob = resp.read()
            return resp.status, (blob.decode() if raw else json.loads(blob))
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _http_ok(port: int, method: str, path: str, body=None, raw: bool = False):
    status, out = _http(port, method, path, body, raw=raw)
    if status != 200:
        raise AssertionError(f"serve: {method} {path} -> {status} {out}")
    return out


def _wait_served(port: int, targets: dict, poll: float = 0.002) -> float:
    """Poll ``GET /tenants/<id>`` until every tenant reached its megasteps;
    returns the monotonic time it was seen."""
    deadline = time.monotonic() + SERVE_TIMEOUT
    todo = dict(targets)
    while todo:
        for tid in list(todo):
            if _http_ok(port, "GET", f"/tenants/{tid}")["megasteps"] >= todo[tid]:
                del todo[tid]
        if not todo:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"serve: tenants {sorted(todo)} never reached {targets}")
        time.sleep(poll)
    return time.monotonic()


def _hist_p50(parsed: dict, name: str) -> float | None:
    """The upper bound of the bucket holding the median of a histogram
    family, summed over its label sets."""
    buckets: dict[float, float] = {}
    for s in parsed["samples"]:
        if s["name"] == f"{name}_bucket":
            le = float(s["labels"]["le"])
            buckets[le] = buckets.get(le, 0.0) + s["value"]
    if not buckets or buckets[max(buckets)] == 0:
        return None
    total = buckets[max(buckets)]
    return next(le for le in sorted(buckets) if buckets[le] >= total / 2)


class _WardenTap:
    """Counts the flags of every trip a warden records, per world label."""

    def __init__(self):
        self.flags: dict[int, dict[str, int]] = {}

    def __enter__(self):
        from magicsoup_tpu_torch.check.invariants import decode_invariants
        from magicsoup_tpu_torch.fleet.warden import FleetWarden
        from magicsoup_tpu_torch.guard.sentinel import decode_health

        self._orig = orig = FleetWarden.report
        tap = self

        def report(warden, lane, kind, out):
            rec = warden._by_lane.get(id(lane))
            if rec is not None:
                decoded = (decode_health(out.health) if kind == "sentinel"
                           else decode_invariants(out.invariants))
                counts = tap.flags.setdefault(rec.label, {})
                for name, on in decoded.items():
                    if on:
                        key = f"{kind}:{name}"
                        counts[key] = counts.get(key, 0) + 1
            return orig(warden, lane, kind, out)

        FleetWarden.report = report
        return self

    def __exit__(self, *exc):
        from magicsoup_tpu_torch.fleet.warden import FleetWarden

        FleetWarden.report = self._orig


def _serve_http_leg(torch, tmp: Path) -> tuple[dict, int]:
    """Phase 24 (a): two headline tenants over loopback HTTP; returns the
    record and the K2 launches of its timed window and latency grants."""
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.serve import FleetService
    from magicsoup_tpu_torch.telemetry import metrics as pulse
    from magicsoup_tpu_torch.telemetry.recorder import fetch_stats

    tids = [f"wl{seed}" for seed in SERVE_SEEDS]
    fetch0 = fetch_stats()["fetch_bytes"]
    device0 = pulse.device_time_stats()["device_time_us"]
    t0 = time.perf_counter()
    svc = FleetService(tmp, block=2, device=SERVE_DEVICE).start()
    port = svc.port
    # rung-group steps: the groups each scheduler step dispatched (one
    # while both tenants share a rung), counted where the loop calls it
    group_steps = [0]
    scheduler_step = svc.scheduler.step

    def counted_step():
        scheduler_step()
        group_steps[0] += len([g for sib in svc.scheduler._groups.values() for g in sib
                               if g.members()])

    svc.scheduler.step = counted_step
    try:
        with _WardenTap() as wtap:
            for tid, seed in zip(tids, SERVE_SEEDS):
                out = _http_ok(port, "POST", "/tenants", _serve_spec(tid, seed))
                if out["status"] != "active" or out["n_cells"] != N_CELLS:
                    raise AssertionError(f"serve: create {tid} -> {out}")
            create_s = time.perf_counter() - t0
            for tid in tids:
                _http_ok(port, "POST", f"/tenants/{tid}/step", {"megasteps": SERVE_WARMUP})
            _wait_served(port, {tid: SERVE_WARMUP for tid in tids})
            _http_ok(port, "GET", "/accounting")  # drains: the window starts empty
            before, f0 = runtime.snapshot(), fetch_stats()["fetches"]
            ci.launches = ci.grouped_launches = 0
            group_steps[0] = 0
            t_grant = time.monotonic()
            for tid in tids:
                _http_ok(port, "POST", f"/tenants/{tid}/step", {"megasteps": SERVE_WINDOW})
            t_served = _wait_served(port, {tid: SERVE_WARMUP + SERVE_WINDOW for tid in tids})
            _http_ok(port, "GET", "/accounting")
            after, f1 = runtime.snapshot(), fetch_stats()["fetches"]
            window_k2, window_grouped = ci.launches, ci.grouped_launches
            steps = group_steps[0]
            dispatches = after["dispatches"] - before["dispatches"]
            per_step = {
                "dispatches": dispatches / max(steps, 1),
                "fetches": (f1 - f0) / max(steps, 1),
                "k2_launches": window_k2 / max(steps, 1),
            }
            if not (SERVE_WINDOW <= steps <= 2 * SERVE_WINDOW) or (
                    dispatches, f1 - f0, window_k2, window_grouped) != (steps, steps, steps, 0):
                raise AssertionError(
                    f"serve window: {steps} rung-group steps, {dispatches} dispatches,"
                    f" {f1 - f0} fetches, {window_k2} K2 and {window_grouped} grouped launches")
            integ = {k: after[k] - before.get(k, 0) for k in after
                     if k.startswith("integrator_dispatches_") and after[k] != before.get(k, 0)}
            backend = "cuda" if SERVE_DEVICE == "cuda" else "torch-fast"
            if integ != {f"integrator_dispatches_{backend}": steps}:
                raise AssertionError(f"serve window: integrator dispatches {integ}")
            window_s = t_served - t_grant
            # latency: single-megastep grants, alternating tenants
            lat = []
            served = {tid: SERVE_WARMUP + SERVE_WINDOW for tid in tids}
            for i in range(SERVE_LATENCY):
                tid = tids[i % 2]
                served[tid] += 1
                t1 = time.monotonic()
                _http_ok(port, "POST", f"/tenants/{tid}/step", {"megasteps": 1})
                lat.append(_wait_served(port, {tid: served[tid]}) - t1)
            latency_k2 = ci.launches - window_k2
            acct = _http_ok(port, "GET", "/accounting")
            rows = {r["tenant"]: r for r in acct["rows"]}
            if {tid: rows[tid]["steps"] for tid in tids} != served or (
                    acct["total_steps"] != sum(r["steps"] for r in acct["rows"])):
                raise AssertionError(f"serve accounting: rows {acct['rows']}, served {served}")
            fetch_total = fetch_stats()["fetch_bytes"] - fetch0
            device_total = pulse.device_time_stats()["device_time_us"] - device0
            if (acct["total_fetch_bytes"], acct["total_device_us"]) != (fetch_total, device_total) or (
                    sum(r["fetch_bytes"] for r in acct["rows"]) != fetch_total
                    or sum(r["device_us"] for r in acct["rows"]) != device_total):
                raise AssertionError(
                    f"serve accounting not conserved: {acct}, process fetch bytes {fetch_total},"
                    f" device us {device_total}")
            scrapes = [pulse.parse_exposition(_http_ok(port, "GET", "/metrics", raw=True))
                       for _ in range(2)]
            for name, kind in scrapes[0]["types"].items():
                if kind != "counter":
                    continue
                for s in scrapes[0]["samples"]:
                    if s["name"] == name:
                        later = pulse.sample_value(scrapes[1], name, **s["labels"])
                        if later is None or later < s["value"]:
                            raise AssertionError(f"serve metrics: {name} {s['labels']} went"
                                                 f" {s['value']} -> {later}")
            health = _http_ok(port, "GET", "/healthz")
            digests = {tid: _http_ok(port, "GET", f"/tenants/{tid}/digest")["digest"] for tid in tids}
            observed = {tid: _http_ok(port, "GET", f"/tenants/{tid}") for tid in tids}
            svc.stop()
        if svc._loop_thread.is_alive():
            raise AssertionError("serve: the loop did not stop")
        labels = {tid: svc._tenants[tid].label for tid in tids}
        for tid in tids:
            _check_state(svc._tenants[tid].lane.world, f"served tenant {tid}")
        flags = {tid: wtap.flags.get(labels[tid], {}) for tid in tids}
        other = sorted({f for fl in flags.values() for f in fl} - {"invariant:dead_param_residue"})
        if other:
            raise AssertionError(f"serve: flags other than dead_param_residue: {flags}")
        if not (tmp / "tenants.json").exists():
            raise AssertionError("serve: the stop wrote no registry")
    finally:
        if svc._loop_thread.is_alive():
            svc.stop()
    import numpy as np

    return {
        "tenants": tids,
        "create_s": create_s,
        "window_megasteps_per_tenant": SERVE_WINDOW,
        "grant_to_served_s": window_s,
        "world_steps_per_s": len(tids) * SERVE_WINDOW / window_s,
        "group_steps": steps,
        "per_group_step": per_step,
        "integrator_dispatches": integ,
        "census": {k: after[k] - before.get(k, 0) for k in after},
        "latency_s": lat,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "accounting": acct,
        "tick_p50_s": _hist_p50(scrapes[1], "magicsoup_tick_seconds"),
        "command_latency_p50_s": _hist_p50(scrapes[1], "magicsoup_command_latency_seconds"),
        "scrapes_monotone": True,
        "health": health,
        "digests": digests,
        "n_cells": {tid: observed[tid]["n_cells"] for tid in tids},
        "stats": {tid: observed[tid]["stats"] for tid in tids},
        "flags": flags,
        "dead_param_residue_trips": {
            tid: flags[tid].get("invariant:dead_param_residue", 0) for tid in tids},
    }, window_k2 + latency_k2


def _serve_fused_leg(torch, tmp: Path) -> dict:
    """Phase 24 (a), the fused sub-leg: the two headline tenants and a
    chemistry-only tenant of another rung, ``fusion="fleet"``, driven by
    manual ticks."""
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.serve import FleetService
    from magicsoup_tpu_torch.telemetry.recorder import fetch_stats

    svc = FleetService(tmp, block=2, fusion="fleet", device=SERVE_DEVICE)
    third = {"tenant": "chem", "seed": SERVE_THIRD["seed"], "map_size": SERVE_THIRD["map_size"],
             "n_cells": SERVE_THIRD["n_cells"], "genome_size": GENOME_SIZE, "deterministic": False,
             "chemistry": _serve_chemistry(),
             # the default knobs (no kill, no division, no spawn) at K = 1
             "stepper": {"mol_name": "ATP", "megastep": 1}}
    specs = [_serve_spec(f"wl{seed}", seed) for seed in SERVE_SEEDS] + [third]
    tids = [s["tenant"] for s in specs]
    for spec in specs:
        svc._execute("create", spec)

    def run(n):
        for tid in tids:
            svc._execute("step", {"tenant": tid, "megasteps": n})
        for _ in range(n):
            svc._tick()
        svc._execute("accounting", {})

    run(SERVE_WARMUP)
    before, f0 = runtime.snapshot(), fetch_stats()["fetches"]
    ci.launches = ci.grouped_launches = 0
    t0 = time.perf_counter()
    run(SERVE_FUSED_STEPS)
    dt = time.perf_counter() - t0
    after, f1 = runtime.snapshot(), fetch_stats()["fetches"]
    got = {
        "dispatches": after["dispatches"] - before["dispatches"],
        "fused_groups": after["fused_groups"] - before["fused_groups"],
        "fetches": f1 - f0,
        "grouped_launches": ci.grouped_launches,
        "k2_launches": ci.launches,
    }
    n_groups = len([g for sib in svc.scheduler._groups.values() for g in sib])
    want = {"dispatches": SERVE_FUSED_STEPS, "fused_groups": n_groups * SERVE_FUSED_STEPS,
            "fetches": SERVE_FUSED_STEPS, "grouped_launches": SERVE_FUSED_STEPS, "k2_launches": 0}
    if n_groups < 2 or got != want:
        raise AssertionError(f"serve fused: {n_groups} groups, {got}, want {want}")
    acct = svc._execute("accounting", {})
    served = {tid: SERVE_WARMUP + SERVE_FUSED_STEPS for tid in tids}
    if {r["tenant"]: r["steps"] for r in acct["rows"]} != served or (
            acct["total_fetch_bytes"] != sum(r["fetch_bytes"] for r in acct["rows"])
            or acct["total_device_us"] != sum(r["device_us"] for r in acct["rows"])):
        raise AssertionError(f"serve fused accounting: {acct}")
    for tid in tids:
        svc._execute("digest", {"tenant": tid})
        _check_state(svc._tenants[tid].lane.world, f"fused tenant {tid}")
    n_third = svc._tenants["chem"].lane.world.n_cells
    if n_third != SERVE_THIRD["n_cells"]:
        raise AssertionError(f"serve fused: the chemistry-only tenant has {n_third} cells")
    return {
        "tenants": tids,
        "groups": n_groups,
        "steps": SERVE_FUSED_STEPS,
        "per_step": {k: v / SERVE_FUSED_STEPS for k, v in got.items()},
        "world_steps_per_s": len(tids) * SERVE_FUSED_STEPS / dt,
        "window_s": dt,
        "accounting": acct,
    }, ci.grouped_launches


def _serve_cpu_reference(tmp: Path) -> tuple[dict, dict]:
    """The det schedule's first half and digests in process on the CPU:
    tenant digests and world state digests at megastep 3."""
    from magicsoup_tpu_torch.check.differential import state_digest
    from magicsoup_tpu_torch.serve import FleetService

    with _det_env():
        svc = FleetService(tmp, block=2, device="cpu")
        for tid, seed, size in SERVE_DET:
            svc._execute("create", _serve_det_spec(tid, seed, size))

        def serve(tid, n):
            svc._execute("step", {"tenant": tid, "megasteps": n})
            while svc._tenants[tid].budget:
                svc._tick()

        for tid, _, _ in SERVE_DET:
            serve(tid, 2)
        for tid, _, _ in SERVE_DET:
            svc._execute("checkpoint", {"tenant": tid})
        svc._execute("accounting", {})
        for tid, _, _ in SERVE_DET:
            serve(tid, 1)
        digests = {tid: svc._execute("digest", {"tenant": tid})["digest"] for tid, _, _ in SERVE_DET}
        states = {tid: state_digest(svc._tenants[tid].lane.world) for tid, _, _ in SERVE_DET}
    return digests, states


def _serve_children(torch, tmp: Path) -> dict:
    """Phase 24 (b): the det schedule of ``performance/smoke.py --serve``
    through ``python -m magicsoup_tpu_torch.serve`` children on the card:
    a baseline, a victim killed after the first half and its restart."""
    import signal
    import subprocess

    from magicsoup_tpu_torch.check.differential import state_digest
    from magicsoup_tpu_torch.guard import CheckpointManager, restore_run

    env = dict(os.environ, MAGICSOUP_TPU_DETERMINISTIC="1")
    procs, logs = [], []
    tmp.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    def spawn(name):
        log = open(tmp / f"{name}.log", "a")
        logs.append(log)
        proc = subprocess.Popen(
            [sys.executable, "-m", "magicsoup_tpu_torch.serve", "--dir", str(tmp / name),
             "--port", "0", "--block", "2"]
            + ([] if SERVE_DEVICE == "cuda" else ["--device", SERVE_DEVICE]),
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=log, text=True,
        )
        procs.append(proc)
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        if not line.startswith("{"):
            raise AssertionError(f"serve child {name} printed no ready line:"
                                 f" {(tmp / f'{name}.log').read_text()[-3000:]}")
        return proc, json.loads(line), time.perf_counter() - t0

    def first_half(port):
        for tid, seed, size in SERVE_DET:
            out = _http_ok(port, "POST", "/tenants", _serve_det_spec(tid, seed, size))
            if out["status"] != "active":
                raise AssertionError(f"serve child: create {tid} -> {out}")
        for tid, _, _ in SERVE_DET:
            _http_ok(port, "POST", f"/tenants/{tid}/step", {"megasteps": 2})
        _wait_served(port, {tid: 2 for tid, _, _ in SERVE_DET})
        for tid, _, _ in SERVE_DET:
            _http_ok(port, "POST", f"/tenants/{tid}/checkpoint")

    def second_half(port):
        for tid, _, _ in SERVE_DET:
            _http_ok(port, "POST", f"/tenants/{tid}/step", {"megasteps": 1})
        _wait_served(port, {tid: 3 for tid, _, _ in SERVE_DET})

    def digests(port):
        return {tid: _http_ok(port, "GET", f"/tenants/{tid}/digest")["digest"]
                for tid, _, _ in SERVE_DET}

    def stop(proc, name):
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SERVE_TIMEOUT)
        if rc != 0:
            raise AssertionError(f"serve child {name}: SIGTERM exit code {rc}")

    k = SERVE_DET_K
    try:
        base, ready, ready_s = spawn("a")
        port = ready["port"]
        first_half(port)
        _http_ok(port, "GET", "/accounting")
        c1 = _http_ok(port, "GET", "/counters")["counters"]
        second_half(port)
        _http_ok(port, "GET", "/accounting")
        c2 = _http_ok(port, "GET", "/counters")["counters"]
        want_digests = digests(port)
        fetch_delta = c2["fetches"] - c1["fetches"]
        if fetch_delta != 3:
            raise AssertionError(f"serve child: {fetch_delta} fetches for 3 sequential"
                                 " single-megastep grants (want 3)")
        # the checkpoints flushed every lane: each resumed without a rebuild
        attach = {k: c2[k] - c1[k] for k in ("attach_full", "attach_skipped")}
        if attach != {"attach_full": 0, "attach_skipped": len(SERVE_DET)}:
            raise AssertionError(f"serve child: re-attaches after the checkpoints {attach}")
        _http_ok(port, "POST", "/admission", {"compile_budget": 0})
        status, out = _http(port, "POST", "/tenants", _serve_det_spec("cold", 5, 32))
        if status != 429:
            raise AssertionError(f"serve child: a cold create under budget 0 -> {status} {out}")
        out = _http_ok(port, "POST", "/tenants", _serve_det_spec("t4", 23, 16))
        if out["status"] != "active":
            raise AssertionError(f"serve child: a warm create under budget 0 -> {out}")
        compiles0 = _http_ok(port, "GET", "/counters")["counters"]["compiles"]
        _http_ok(port, "POST", "/tenants/t4/step", {"megasteps": 1})
        _wait_served(port, {"t4": 1})
        _http_ok(port, "GET", "/accounting")
        counters = _http_ok(port, "GET", "/counters")
        warm_compiles = counters["counters"]["compiles"] - compiles0
        if warm_compiles != 0:
            raise AssertionError(f"serve child: the warm tenant's step charged {warm_compiles} compiles")
        acct = _http_ok(port, "GET", "/accounting")
        served = {r["tenant"]: r["steps"] for r in acct["rows"]}
        if served != {"t1": 3 * k, "t2": 3 * k, "t3": 3 * k, "t4": k} or (
                acct["total_steps"] != sum(r["steps"] for r in acct["rows"])
                or acct["total_fetch_bytes"] != sum(r["fetch_bytes"] for r in acct["rows"])
                or acct["total_device_us"] != sum(r["device_us"] for r in acct["rows"])):
            raise AssertionError(f"serve child accounting: {acct}")
        stop(base, "a")
        if not (tmp / "a" / "tenants.json").exists() or not list(
                (tmp / "a" / "worlds").glob("world-003-*.msck")):
            raise AssertionError("serve child: SIGTERM left no registry or no final checkpoint")

        victim, ready, _ = spawn("b")
        first_half(ready["port"])
        victim.send_signal(signal.SIGKILL)
        if victim.wait(timeout=60) != -signal.SIGKILL:
            raise AssertionError("serve child: the victim did not die of SIGKILL")
        again, ready, restart_ready_s = spawn("b")
        port = ready["port"]
        if ready["tenants"] != 3:
            raise AssertionError(f"serve child: the restart re-adopted {ready['tenants']} tenants")
        for tid, _, _ in SERVE_DET:
            if _http_ok(port, "GET", f"/tenants/{tid}")["megasteps"] != 2:
                raise AssertionError(f"serve child: {tid} recovered off its checkpoint")
        second_half(port)
        got_digests = digests(port)
        if got_digests != want_digests:
            raise AssertionError(f"serve child: restart digests {got_digests} != {want_digests}")
        stop(again, "b")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        for log in logs:
            log.close()
    children_s = time.perf_counter() - t_start
    cpu_digests, cpu_states = _serve_cpu_reference(tmp / "cpu")
    card_states = {}
    for label, (tid, _, _) in enumerate(SERVE_DET):
        world, _, meta = restore_run(CheckpointManager(tmp / "a" / "worlds", keep=3,
                                                       prefix=f"world-{label:03d}"), device="cpu")
        if meta["megasteps"] != 3:
            raise AssertionError(f"serve child: {tid}'s final checkpoint is at {meta['megasteps']}")
        card_states[tid] = state_digest(world)
    if card_states != cpu_states or want_digests != cpu_digests:
        raise AssertionError(f"serve: det digests on the card {card_states}, {want_digests} !="
                             f" the CPU's {cpu_states}, {cpu_digests}")
    return {
        "ready_s": ready_s,
        "restart_ready_s": restart_ready_s,
        "fetches_for_3_grants": fetch_delta,
        "reattaches_after_checkpoints": attach,
        "warm_admission_compiles": warm_compiles,
        "admission": counters["admission"],
        "accounting_steps": served,
        "restart_bit_identical": True,
        "card_equals_cpu_state_and_tenant_digests": True,
        "state_digests": card_states,
        "children_s": children_s,
    }


def _serve_phase(torch, fleet_world_steps_per_s: float) -> tuple[dict, dict]:
    """Phase 24: serving on the card; returns its record and the serve
    launches of K2 and of the grouped entry."""
    import shutil

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # the earlier phases' live tensors: the phase's own peak is above them
    mem0 = torch.cuda.memory_allocated()
    try:
        http, k2_launches = _serve_http_leg(torch, SERVE_DIR / "http")
        print(f"serve: {http['world_steps_per_s']:.2f} world-steps/s over HTTP,"
              f" latency p50 {http['latency_p50_s']:.4f} s p99 {http['latency_p99_s']:.4f} s",
              flush=True)
        fused, grouped_launches = _serve_fused_leg(torch, SERVE_DIR / "fused")
        peak = torch.cuda.max_memory_allocated()
        det = _serve_children(torch, SERVE_DIR / "det")
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    record = {"http": http, "fused": fused, "det": det, "peak_mem_bytes": peak,
              "peak_mem_above_start_bytes": peak - mem0,
              "fleet_phase7_world_steps_per_s": fleet_world_steps_per_s,
              "wall_s": time.perf_counter() - t0}
    return record, {"k2": k2_launches, "grouped": grouped_launches}


MESH_DEVICE = "cuda"
#: the seeded mesh runs the rank processes call (``torch_mesh_runs``,
#: shared with the tests), put on the ranks' and this process's path
MESH_RUNS_DIR = str(ROOT / "tests")
MESH_TIMEOUT = 120.0
MESH_DET_STEPS = 10
MESH_DET_DISPATCHES = {1: 6, 4: 2}
MESH_CLASSIC_STEPS = 20
MESH_STEPPER_STEPS = 60
MESH_FLEET = dict(seeds=[42, 43, 44, 45], steps=10, map_size=64, n_cells=500, genome_size=300)


def _contract_shares(out, ref) -> dict:
    """The real-state contract's shares of ``out`` against ``ref`` (rows
    are cells): finite and >= 0, the share within 1e-4 relative, within
    0.01 of the cell's largest value, the largest cell error, and the
    share of rows bit-equal."""
    import numpy as np

    rel = np.abs(out - ref) / (np.abs(ref) + 1e-6)
    scale = np.maximum(np.abs(ref).max(axis=1), 1e-6)
    norm = np.abs(out - ref).max(axis=1) / scale
    return {
        "finite_nonneg": bool(np.isfinite(out).all() and (out >= 0).all()),
        "cells_within_1e-4": float((rel.max(axis=1) < 1e-4).mean()),
        "cells_within_0.01": float((norm < 0.01).mean()),
        "max_cell_err": float(norm.max()),
        "max_abs_err": float(np.abs(out - ref).max()),
        "rows_bit_equal": float((out == ref).all(axis=1).mean()),
    }


def _mesh_runs():
    if MESH_RUNS_DIR not in sys.path:
        sys.path.insert(0, MESH_RUNS_DIR)
    import torch_mesh_runs

    return torch_mesh_runs


def _mesh_det_args() -> dict:
    det_kw = dict(seed=DET_SEED, map_size=DET_MAP, n_cells=DET_CELLS, genome_size=DET_GENOME)
    det_stepper = dict(STEPPER_KW, target_cells=DET_CELLS, genome_size=DET_GENOME)
    return dict(steps=MESH_DET_STEPS, stepper_dispatches=MESH_DET_DISPATCHES,
                stepper_kw=det_stepper, **det_kw)


def _mesh_same(ref: dict, got: dict, label: str) -> None:
    """Every final digest of a mesh's det runs equal to one device's on
    the card and on the CPU."""
    for path, want in ref[MESH_DEVICE].items():
        if got[path]["digest"] != want["digest"] or want["digest"] != ref["cpu"][path]["digest"]:
            raise AssertionError(f"meshes {label}: {path} differs from one device"
                                 f" (card {want['digest'][:12]}, cpu"
                                 f" {ref['cpu'][path]['digest'][:12]}, mesh"
                                 f" {got[path]['digest'][:12]})")


def _mesh_det_gloo(pool, ref: dict) -> dict:
    """25 (a): deterministic mode over two ranks sharing the card."""
    got = pool.run("torch_mesh_runs:det_paths", **_mesh_det_args())
    if any(got[0][path]["digest"] != got[1][path]["digest"] for path in got[0]):
        raise AssertionError("meshes (a): the ranks disagree")
    _mesh_same(ref, got[0], "(a) gloo x2")
    return {path: {k: v for k, v in r.items() if k != "digest"} for path, r in got[0].items()}


def _mesh_headline(pool) -> dict:
    """25 (c): the headline world over two ranks, fast mode."""
    import numpy as np

    from magicsoup_tpu_torch.ops import backends

    runs = _mesh_runs()
    kw = dict(seed=SEED, map_size=MAP_SIZE, n_cells=N_CELLS, genome_size=GENOME_SIZE,
              classic_steps=MESH_CLASSIC_STEPS, stepper_steps=MESH_STEPPER_STEPS,
              stepper_kw=dict(STEPPER_KW, megastep=1), warmup=STEPPER_WARMUP)
    head = pool.run("torch_mesh_runs:headline_mesh", **kw)
    one = runs.make_world(None, seed=SEED, map_size=MAP_SIZE, n_cells=N_CELLS,
                          genome_size=GENOME_SIZE, det=False, device=MESH_DEVICE)
    X0, params = one.integrator_inputs()
    ref_X1 = backends.integrate(one.integrator, X0, params).cpu().numpy()[:N_CELLS]
    del one, X0, params
    mesh_X1 = np.concatenate([r.pop("first_X1") for r in head])[:N_CELLS]
    first = _contract_shares(mesh_X1, ref_X1)
    # each rank runs the same kernel on the same 8-cell tiles as one
    # device (a rank's block is a multiple of 8), so every row is
    # bit-equal; the real-state contract is read beside it
    if not (first["rows_bit_equal"] == 1.0 and first["finite_nonneg"]
            and first["cells_within_1e-4"] >= 0.85 and first["cells_within_0.01"] >= 0.98
            and first["max_cell_err"] < 0.25):
        raise AssertionError(f"meshes (c): the first integrator output: {first}")
    for rank, r in enumerate(head):
        for name in ("classic", "stepper"):
            w = r[name]
            if w["k1_k2"] != w["steps"]:
                raise AssertionError(f"meshes (c) rank {rank}: {w['k1_k2']} kernel launches"
                                     f" in {w['steps']} {name} steps")
            if not w["finite_nonneg"]:
                raise AssertionError(f"meshes (c) rank {rank}: {name} state not finite, >= 0")
            w["steps_per_s"] = w["steps"] / w["seconds"]
            w["collectives_per_step"] = w["collectives"] / w["steps"]
            w["collective_bytes_per_step"] = w["collective_bytes"] / w["steps"]
            w["collective_host_ms_per_step"] = w["collective_us"] / 1e3 / w["steps"]
        bad = sorted(set(r["stepper"]["flags"]) - {"invariant:dead_param_residue"})
        if bad or r["stepper"]["tile_records"]["mismatch"]:
            raise AssertionError(f"meshes (c) rank {rank}: flags {bad}, tile lanes"
                                 f" {r['stepper']['tile_records']}")
    return {"first_step_X1": first, "ranks": head}


def _mesh_fleet(pool) -> dict:
    """25 (d): the world-sharded fleet: one K2 launch per rank per fleet
    step in fast mode, every leaf bit-equal to the unsharded group in
    deterministic mode; in fast mode the state and parameters bit-equal
    too, only the records' mass lanes may differ (a reduction over a
    world's rows may take another order at another group size)."""
    fleet = {}
    for mode, det in (("fast", False), ("det", True)):
        # the sharded step left to its default integrator: ``cuda`` on the
        # card in fast mode (its K2 launches counted), ``torch-det`` in det
        got = pool.run("torch_mesh_runs:fleet_sharding", det=det, default_integrator=True,
                       **MESH_FLEET)
        for rank, r in enumerate(got):
            if det and not r["equal"]:
                raise AssertionError(f"meshes (d) det, rank {rank}: {r['differ']} differ")
            if not set(r["differ"]) <= {"records"}:
                raise AssertionError(f"meshes (d) {mode}, rank {rank}: {r['differ']} differ")
            if not det and r["launches"] != MESH_FLEET["steps"]:
                raise AssertionError(f"meshes (d) rank {rank}: {r['launches']} K2 launches"
                                     f" in {MESH_FLEET['steps']} fleet steps")
        fleet[mode] = got
    return fleet


def _mesh_nccl(ref: dict) -> dict:
    """25 (e): a one-rank NCCL mesh, bit-equal to one device."""
    from magicsoup_tpu_torch.parallel.launch import RankPool

    t0 = time.perf_counter()
    with RankPool(1, backend="nccl", device=MESH_DEVICE, timeout=MESH_TIMEOUT,
                  env={"PYTHONPATH": MESH_RUNS_DIR}) as pool:
        probe = pool.run("torch_mesh_runs:backend_probe")[0]
        got = pool.run("torch_mesh_runs:det_paths", **_mesh_det_args())[0]
    _mesh_same(ref, got, "(e) nccl x1")
    return {"probe": probe, "seconds": time.perf_counter() - t0,
            **{path: {k: v for k, v in r.items() if k != "digest"} for path, r in got.items()}}


def _mesh_phase(torch) -> dict:
    """Phase 25: meshes of rank processes sharing the card (module notes,
    25 a-e)."""
    from magicsoup_tpu_torch.parallel.launch import RankPool

    runs = _mesh_runs()
    t_phase = time.perf_counter()
    ref = {dev: runs.det_paths(None, device=dev, **_mesh_det_args()) for dev in (MESH_DEVICE, "cpu")}
    out = {}
    t0 = time.perf_counter()
    with RankPool(2, backend="gloo", device=MESH_DEVICE, timeout=MESH_TIMEOUT,
                  env={"PYTHONPATH": MESH_RUNS_DIR}) as pool:
        out["gloo_start_s"] = time.perf_counter() - t0
        out["det_gloo"] = _mesh_det_gloo(pool, ref)
        out["headline"] = _mesh_headline(pool)
        out["sharded_fleet"] = _mesh_fleet(pool)
        out["gloo_s"] = time.perf_counter() - t0
    out["nccl"] = _mesh_nccl(ref)
    out["det_equal_one_device"] = 2 * len(ref["cpu"])
    out["seconds"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------------------- #
# phase 26: the analysis plane and the warm-up API on the card          #
# --------------------------------------------------------------------- #
#: the guarded windows: warm-up dispatches, then the guarded ones
ANALYSIS_WARMUP = 8
ANALYSIS_STEPS = 5
ANALYSIS_FLEET_WARMUP = 4
ANALYSIS_FLEET_STEPS = 2
#: the fused fleet: two worlds on the headline map and one on a map twice
#: as wide (two rung groups, as tests/fast/test_fleet.py's fused fleet)
ANALYSIS_FUSED = ((SEED, MAP_SIZE), (SEED + 1, MAP_SIZE), (SEED + 2, 2 * MAP_SIZE))
#: rows of the world's state the det steps run on (the CPU side runs the
#: det integrator single-threaded)
ANALYSIS_DET_ROWS = 256
ANALYSIS_DET_STEPS = 3
ANALYSIS_DIR = ROOT / "build" / "chip_smoke_analysis"
#: the headline selection with nothing dying, dividing, spawning or
#: mutating, as the JAX package's steady-state guard test runs it
QUIET_KW = dict(STEPPER_KW, kill_below=-1.0, divide_above=1e30, divide_cost=0.0,
                target_cells=None, p_mutation=0.0, p_recombination=0.0)


def _zero_launches():
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_params, cuda_prng

    ci.launches = ci.grouped_launches = cuda_prng.launches = cuda_params.launches = 0


def _launch_counts() -> dict:
    from magicsoup_tpu_torch.ops import cuda_integrate as ci
    from magicsoup_tpu_torch.ops import cuda_params, cuda_prng

    return {"k1_k2": ci.launches, "grouped": ci.grouped_launches, "threefry": cuda_prng.launches,
            "assembly": cuda_params.launches}


def _guarded(torch, label: str, run, want: dict) -> dict:
    """``run()`` under ``hot_path_guard(compile_budget=0,
    transfers="disallow")`` with the launch counts set to 0 just before:
    it must compile nothing, synchronize nowhere and launch ``want``."""
    from magicsoup_tpu_torch.analysis import runtime

    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    with runtime.hot_path_guard(compile_budget=0, transfers="disallow") as stats:
        run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = _launch_counts()
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return {"compiles": stats.compiles, "window_s": dt, "launches": got}


def _guarded_stepper(torch, world, k: int) -> dict:
    import magicsoup_tpu_torch as mt

    st = mt.PipelinedStepper(world, megastep=k, **QUIET_KW)
    for _ in range(-(-ANALYSIS_WARMUP // k)):
        st.step()
    st.drain()

    def run():
        for _ in range(ANALYSIS_STEPS):
            st.step()
        st.drain()

    got = _guarded(torch, f"guarded stepper K{k}", run, {"k1_k2": ANALYSIS_STEPS * k})
    st.flush()
    _check_state(world, f"guarded stepper K{k}")
    return dict(got, megastep=k, dispatches=ANALYSIS_STEPS)


def _guarded_fleet(torch, worlds, fusion: str, block: int) -> dict:
    import magicsoup_tpu_torch as mt

    fleet = mt.FleetScheduler(block=block, fusion=fusion)
    for w in worlds:
        fleet.admit(w, **dict(QUIET_KW, megastep=1))
    for _ in range(ANALYSIS_FLEET_WARMUP):
        fleet.step()
    fleet.drain()

    def run():
        for _ in range(ANALYSIS_FLEET_STEPS):
            fleet.step()
        fleet.drain()

    n_groups = len([g for sib in fleet._groups.values() for g in sib])
    want = ({"grouped": ANALYSIS_FLEET_STEPS, "k1_k2": 0} if fusion == "fleet"
            else {"k1_k2": n_groups * ANALYSIS_FLEET_STEPS})
    got = _guarded(torch, f"guarded fleet ({fusion})", run, want)
    fleet.flush()
    for i, w in enumerate(worlds):
        _check_state(w, f"guarded fleet ({fusion}) world {i}")
    return dict(got, worlds=len(worlds), groups=n_groups, fleet_steps=ANALYSIS_FLEET_STEPS)


def _guarded_assembly(torch, world) -> dict:
    """``Kinetics.scatter_dense`` of ``ASSEMBLY_ROWS[1]`` random token rows
    at rung ``ASSEMBLY_RUNG`` into slots of ``world`` (which is dropped
    afterwards) under the guard, after one unguarded call: the pinned
    upload and the kernel's one launch synchronize nowhere and compile
    nothing."""
    import numpy as np

    kin = world.kinetics
    rng = np.random.default_rng(SEED + 28)
    p_r, d_r = ASSEMBLY_RUNG
    b = min(ASSEMBLY_ROWS[1], world._capacity)
    rows = rng.permutation(world._capacity)[:b]
    dense = _assembly_tokens(rng, b, min(p_r, kin.params.Vmax.shape[1]), d_r,
                             kin.tables.km_weights.shape[0], kin.tables.reactions.shape[0])
    kin.scatter_dense(rows, dense)
    got = _guarded(torch, "guarded assembly", lambda: kin.scatter_dense(rows, dense),
                   {"assembly": 1, "k1_k2": 0})
    return dict(got, rows=b, rung=list(dense.shape[1:3]))


def _sync_item_control(torch) -> dict:
    """The guard is live: ``.item()`` inside a window raises, a sanctioned
    fetch passes, and the mode found is back after the window."""
    from magicsoup_tpu_torch.analysis import runtime

    x = torch.arange(8, dtype=torch.float32, device="cuda")
    raised = None
    with runtime.hot_path_guard(compile_budget=0, transfers="disallow"):
        try:
            x.sum().item()
        except RuntimeError as exc:
            raised = str(exc).splitlines()[0]
        fetched = float(runtime.sanctioned_transfer(x).sum())
    if raised is None or fetched != 28.0:
        raise AssertionError(f"the guard is not live: .item() raised {raised!r}, fetch {fetched}")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("the guard left the sync debug mode set")
    return {"item_raised": raised, "sanctioned_fetch_passed": True}


def _token_sync_log(torch) -> dict:
    """The token stepper at K 1 with phase 16's selection (deaths,
    divisions, spawns and the token mutation programs on): 5 steps under
    ``transfers="log"``, every synchronizing call counted by where it
    comes from (there must be none: the token programs fill their
    operands on the device), then 5 more under ``hot_path_guard(0,
    "disallow")``, as the string stepper runs."""
    import warnings

    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch.analysis import runtime

    world, _ = _workload(torch, genome_backend="token")
    st = mt.PipelinedStepper(world, megastep=1, **STEPPER_KW)
    for _ in range(STEPPER_WARMUP):
        st.step()
    st.drain()
    torch.cuda.synchronize()
    _zero_launches()
    syncs: dict[str, int] = {}

    def _rel(path: str) -> str:
        return str(Path(path).relative_to(ROOT)) if Path(path).is_relative_to(ROOT) else path

    def note(message, category, filename, lineno, file=None, line=None):
        # a warning raised inside torch is filed under the innermost frame
        # of the port's code that called it, and the thread that ran it
        if "called a synchronizing CUDA operation" not in str(message):
            return
        where = f"{_rel(filename)}:{lineno}"
        if not Path(filename).is_relative_to(ROOT):
            port = [f for f in traceback.extract_stack()
                    if Path(f.filename).is_relative_to(ROOT / "magicsoup_tpu_torch")]
            if port:
                where += f" via {_rel(port[-1].filename)}:{port[-1].lineno} ({port[-1].name})"
            where += f" [{threading.current_thread().name}]"
        syncs[where] = syncs.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        with runtime.hot_path_guard(compile_budget=10**6, transfers="log") as stats:
            for _ in range(ANALYSIS_STEPS):
                st.step()
            st.drain()
    torch.cuda.synchronize()
    launches = _launch_counts()
    if launches["k1_k2"] != ANALYSIS_STEPS:
        raise AssertionError(f"token stepper under transfers=log: launches {launches}")
    if syncs:
        raise AssertionError(f"token stepper under transfers=log: synchronizing calls {syncs}")

    def run():
        for _ in range(ANALYSIS_STEPS):
            st.step()
        st.drain()

    guarded = _guarded(torch, "guarded token stepper K1", run, {"k1_k2": ANALYSIS_STEPS})
    st.flush()
    _check_state(world, "token stepper under the guard")
    return {"steps": ANALYSIS_STEPS, "compiles": stats.compiles, "launches": launches,
            "sync_calls": sum(syncs.values()), "sync_calls_by_site": syncs,
            "guarded": guarded}


def _warm_child(torch, out: Path) -> None:
    """One fresh process of phase 26 (c) (``--warm-child OUT``): a fresh
    headline world's first activity, cold (``OUT`` named ``cold.json``) or
    after ``prewarm_activity()`` + ``wait_warm()``, which must leave its
    state digest unchanged, under ``hot_path_guard(0)``."""
    from magicsoup_tpu_torch.analysis import runtime
    from magicsoup_tpu_torch.check.differential import state_digest

    torch.zeros(1, device="cuda").sum()
    torch.cuda.synchronize()  # the CUDA context, outside every timing
    world, spawn_s = _workload(torch)
    report = {"spawn_s": spawn_s, "n_cells": world.n_cells}
    if out.stem == "warm":
        d0 = state_digest(world)
        _zero_launches()
        c0 = runtime.compile_count()
        t0 = time.perf_counter()
        world.prewarm_activity()
        world.wait_warm()
        torch.cuda.synchronize()
        report["prewarm_s"] = time.perf_counter() - t0
        report["prewarm_compiles"] = runtime.compile_count() - c0
        report["prewarm_launches"] = _launch_counts()["k1_k2"]
        if state_digest(world) != d0:
            raise AssertionError("prewarm_activity changed the world's state")
        report["digest_unchanged"] = True
    _zero_launches()
    c0 = runtime.compile_count()
    t0 = time.perf_counter()
    if out.stem == "warm":
        with runtime.hot_path_guard(compile_budget=0, transfers="disallow") as stats:
            world.enzymatic_activity()
        report["guard_compiles"] = stats.compiles
    else:
        world.enzymatic_activity()
    torch.cuda.synchronize()
    report["first_activity_s"] = time.perf_counter() - t0
    report["first_activity_compiles"] = runtime.compile_count() - c0
    report["first_activity_launches"] = _launch_counts()["k1_k2"]
    _check_state(world, f"{out.stem} world's first activity")
    report["jax_loaded"] = "jax" in sys.modules or "magicsoup_tpu" in sys.modules
    out.write_text(json.dumps(report))


def _warm_up_children() -> dict:
    """Phase 26 (c): the cold and the warmed first activity, each in a
    fresh process (this one's shapes are warm from the earlier phases)."""
    import subprocess

    ANALYSIS_DIR.mkdir(parents=True, exist_ok=True)
    got = {}
    for mode in ("cold", "warm"):
        out = ANALYSIS_DIR / f"{mode}.json"
        out.unlink(missing_ok=True)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--warm-child", str(out)],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise AssertionError(f"the {mode} warm-up process failed:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-6000:]}")
        got[mode] = json.loads(out.read_text())
        if got[mode].pop("jax_loaded"):
            raise AssertionError(f"the {mode} warm-up process imported JAX")
    warm, cold = got["warm"], got["cold"]
    if warm["guard_compiles"] != 0 or warm["prewarm_launches"] < 1 or not warm["digest_unchanged"]:
        raise AssertionError(f"prewarm_activity: {warm}")
    if cold["first_activity_compiles"] < 1 or cold["first_activity_launches"] != 1:
        raise AssertionError(f"the cold world's first activity: {cold}")
    return got


def _det_steps(torch, world) -> dict:
    """Phase 26 (d): ``integrate_signals_steps(..., 3, det=True)`` on the
    world's state (its first live rows) on the card, bit-equal to the same
    on the CPU."""
    import numpy as np

    from magicsoup_tpu_torch.ops.integrate import CellParams, integrate_signals_steps

    X, params = world.integrator_inputs()
    rows = min(ANALYSIS_DET_ROWS, X.shape[0])
    X, params = X[:rows].contiguous(), CellParams(*(t[:rows].contiguous() for t in params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = integrate_signals_steps(X, params, ANALYSIS_DET_STEPS, det=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    X_cpu = X.cpu()
    t0 = time.perf_counter()
    cpu = integrate_signals_steps(
        X_cpu, CellParams(*(t.cpu() for t in params)), ANALYSIS_DET_STEPS, det=True
    )
    cpu_s = time.perf_counter() - t0
    if not torch.equal(X.cpu(), X_cpu):
        raise AssertionError("integrate_signals_steps changed its input")
    card_np, cpu_np = card.cpu().numpy(), cpu.numpy()
    if not np.array_equal(card_np, cpu_np):
        n = int((card_np != cpu_np).any(axis=1).sum())
        raise AssertionError(f"det integrate_signals_steps: {n} rows differ between card and CPU")
    if not (np.isfinite(card_np).all() and (card_np >= 0).all()):
        raise AssertionError("det integrate_signals_steps: not finite and >= 0")
    return {"rows": rows, "steps": ANALYSIS_DET_STEPS, "bit_equal_to_cpu": True,
            "card_s": card_s, "cpu_s": cpu_s, "sha256": _sha256(card)}


def _lint_gate():
    """Phase 26 (e): ``python -m magicsoup_tpu_torch.analysis --check``,
    started in the background; the returned callable waits for it."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "magicsoup_tpu_torch.analysis", "--check"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
    )

    def result() -> dict:
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"graftlint --check failed:\n{out[-4000:]}{err[-2000:]}")
        return {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                "summary": out.strip().splitlines()[-2:]}

    return result


def _analysis_phase(torch) -> tuple[dict, dict]:
    """Phase 26: the analysis plane and the warm-up API on the card; returns
    its record and the launches per kernel."""
    t0 = time.perf_counter()
    lint = _lint_gate()
    control = _sync_item_control(torch)
    world, _ = _workload(torch)
    windows = {"stepper_K1": _guarded_stepper(torch, world, 1),
               "stepper_K4": _guarded_stepper(torch, world, 4)}
    det = _det_steps(torch, world)
    windows["assembly"] = _guarded_assembly(torch, world)
    del world
    worlds = [_workload(torch, seed=SEED + i)[0] for i in range(FLEET_WORLDS)]
    windows["fleet"] = _guarded_fleet(torch, worlds, "rung", FLEET_WORLDS)
    del worlds
    worlds = [_workload(torch, seed=s, map_size=m)[0] for s, m in ANALYSIS_FUSED]
    windows["fused_fleet"] = _guarded_fleet(torch, worlds, "fleet", 2)
    del worlds
    for name, w in windows.items():
        if w["compiles"] != 0:
            raise AssertionError(f"guarded window {name}: {w['compiles']} compiles")
    token = _token_sync_log(torch)
    warm_up = _warm_up_children()
    lint = lint()
    launches = {
        "k1": {"prewarm": warm_up["warm"]["prewarm_launches"],
               "first_activity": {m: warm_up[m]["first_activity_launches"] for m in warm_up}},
        "k2": {name: w["launches"]["k1_k2"] for name, w in windows.items()
               if name not in ("fused_fleet", "assembly")}
              | {"token_stepper_K1": token["launches"]["k1_k2"],
                 "token_stepper_K1_guarded": token["guarded"]["launches"]["k1_k2"]},
        "grouped": windows["fused_fleet"]["launches"]["grouped"],
        "threefry": {name: w["launches"]["threefry"] for name, w in windows.items()}
                    | {"token_stepper_K1": token["launches"]["threefry"],
                       "token_stepper_K1_guarded": token["guarded"]["launches"]["threefry"]},
        "assembly": {name: w["launches"]["assembly"] for name, w in windows.items()}
                    | {"token_stepper_K1": token["launches"]["assembly"],
                       "token_stepper_K1_guarded": token["guarded"]["launches"]["assembly"]},
    }
    return {
        "item_control": control,
        "guarded_windows": windows,
        "token_stepper_log": token,
        "warm_up": warm_up,
        "det_steps": det,
        "lint": lint,
        "wall_s": time.perf_counter() - t0,
    }, launches


# --------------------------------------------------------------------- #
# phase 27: the measurement drivers on the card                         #
# --------------------------------------------------------------------- #
DRIVERS_DIR = ROOT / "build" / "chip_smoke_drivers"
#: where phase 27 runs (a CPU rehearsal at a tiny size sets "cpu")
DRIVERS_DEVICE = "cuda"
#: every driver runs at the headline's width, each at its own depth; the
#: in-process bench's depth (the child runs the command's defaults)
DRIVER_BENCH = dict(warmup=3, steps=10)
DRIVER_RUN_SIM = dict(classic=30, pipelined=10)
DRIVER_CHECK = dict(s=1000, r=2)
DRIVER_PROFILE = dict(warmup=5, steps=10)
DRIVER_MEGASTEP = dict(ks=(1, 4), steps=24, warmup=6)
DRIVER_FLEET = dict(bs=(1, 4, 16), ks=(1, 4), steps=16, warmup=4, mixed_bs=(4,), rungs=(2,))
DRIVER_MESH = dict(devices=(1, 2), steps=16, warmup=4, check_steps=8)
DRIVER_TIMEOUT = 600
#: the bench child's command line, as a user runs the headline
BENCH_CHILD_ARGS = ["--config", "headline"]
#: bench.py's result keys (its ``emit``, bench.py:319-340; the pipelined
#: fields, :388-395, 429); the port adds "device"
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device_rtt_ms", "rtt_free_steps_per_s"}
BENCH_CLASSIC_KEYS = BENCH_KEYS | {"driver", "device"}
BENCH_HEADLINE_KEYS = BENCH_KEYS | {"classic_steps_per_s", "pipelined_steps_per_s", "megastep",
                                    "pipeline_stats", "driver", "device"}
#: each sweep's row keys in its JAX script, plus the port's
CHECK_KEYS = {"metric", "op", "value", "unit", "sd", "repeats", "n_cells", "genome_size",
              "backend", "device"}
CHECK_OPS = ["spawn_cells", "update_cells", "divide_cells", "enzymatic_activity", "mutations"]
PROFILE_KEYS = {"device", "rtt_ms", "n_cells_end", "s_per_step", "steps_per_s"}
MEGASTEP_KEYS = {"metric", "value", "unit", "megastep", "dispatches", "ms_per_step",
                 "dispatch_ms_median", "final_n_cells", "pinned_population", "backend", "device"}
FLEET_KEYS = {"metric", "value", "unit", "fleet_size", "megastep", "dispatches", "ms_per_step",
              "aggregate_steps_per_s", "groups", "backend", "device"}
FUSED_KEYS = {"metric", "value", "unit", "rungs", "fleet_size", "worlds", "fused", "megastep",
              "dispatches", "ms_per_step", "backend", "device"}
MESH_KEYS = {"metric", "value", "unit", "n_devices", "megastep", "ms_per_step", "final_n_cells",
             "driver", "backend", "device", "cards"}
MESH_CHECK_KEYS = {"metric", "ok", "n_devices", "steps", "final_n_cells", "device", "cards"}


def _sync_device(torch) -> None:
    if DRIVERS_DEVICE == "cuda":
        torch.cuda.synchronize()


def _driver(torch, module: str, argv: list, want: dict) -> dict:
    """``python -m magicsoup_tpu_torch.performance.<module> *argv``, called
    in this process through its ``main(argv)`` with the launch counts set
    to 0 just before: it must return 0 and launch ``want``.  Returns its
    JSON rows, its other lines, its launches and its seconds."""
    import importlib
    import io

    mod = importlib.import_module(f"magicsoup_tpu_torch.performance.{module}")
    argv = [str(a) for a in argv] + ["--device", DRIVERS_DEVICE]
    out = io.StringIO()
    _sync_device(torch)
    _zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    _sync_device(torch)
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    lines = out.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"driver {module} {argv} exited {rc}:\n" + "\n".join(lines[-40:]))
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"driver {module}: launches {launches}, want {want}")
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    text = [line for line in lines if not line.startswith("{")]
    return {"argv": argv, "rows": rows, "lines": text, "launches": launches, "seconds": seconds}


def _keys(rows, want: set, label: str) -> None:
    for row in rows:
        if set(row) != want:
            raise AssertionError(f"{label}: keys {sorted(set(row) ^ want)} differ from the"
                                 f" JAX script's; row {row}")


def _bench_child(torch) -> dict:
    """``python -m magicsoup_tpu_torch.performance.bench --config headline``
    as a user runs it: its classic line, then its headline line, with
    bench.py's keys; the value is the faster driver's."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "magicsoup_tpu_torch.performance.bench", *BENCH_CHILD_ARGS,
         "--device", DRIVERS_DEVICE],
        capture_output=True, text=True, timeout=DRIVER_TIMEOUT, cwd=ROOT,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-6000:]}")
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    classic, head = (json.loads(line) for line in lines[-2:])
    _keys([classic], BENCH_CLASSIC_KEYS, "bench's classic line")
    _keys([head], BENCH_HEADLINE_KEYS, "bench's headline line")
    if not classic["metric"].endswith(" [classic]") or head["metric"] + " [classic]" != classic["metric"]:
        raise AssertionError(f"bench's metric names: {classic['metric']!r}, {head['metric']!r}")
    if head["value"] != max(head["classic_steps_per_s"], head["pipelined_steps_per_s"]):
        raise AssertionError(f"bench's headline value is not the faster driver's: {head}")
    if not all(math.isfinite(head[k]) and head[k] > 0 for k in
               ("value", "vs_baseline", "classic_steps_per_s", "pipelined_steps_per_s")):
        raise AssertionError(f"bench's headline: {head}")
    trace = [line for line in proc.stderr.splitlines() if line.startswith("[trace]")]
    return {"classic": classic, "headline": head, "trace": trace, "seconds": seconds}


def _bench_in_process(torch) -> dict:
    """The same measurement in this process at a cut depth, so that its
    launches per step can be read: one K1 launch per classic step, one
    K2 launch per simulated step of the pipelined driver."""
    w, n = DRIVER_BENCH["warmup"], DRIVER_BENCH["steps"]
    classic_steps, pipelined_steps = w + n, max(w, 3) + 4 * n
    got = _driver(torch, "bench", ["--n-cells", N_CELLS, "--map-size", MAP_SIZE,
                                   "--genome-size", GENOME_SIZE, "--seed", SEED,
                                   "--warmup", w, "--steps", n],
                  {"k1_k2": classic_steps + pipelined_steps, "grouped": 0})
    _keys(got["rows"][-1:], BENCH_HEADLINE_KEYS, "bench in process")
    got["classic_steps"], got["pipelined_steps"] = classic_steps, pipelined_steps
    got["threefry_per_pipelined_step"] = got["launches"]["threefry"] / pipelined_steps
    return got


def _run_simulation(torch) -> dict:
    """``run_simulation`` classic and ``--pipelined`` at the headline's
    width under ``build/``: a ``save_state`` at step 0 (and a ``save_run``
    with the stepper), a final checkpoint that restores on the card and
    verifies, one launch per step."""
    import shutil

    from magicsoup_tpu_torch import guard

    out = {}
    for mode, n in DRIVER_RUN_SIM.items():
        logdir = DRIVERS_DIR / f"run_simulation_{mode}"
        shutil.rmtree(logdir, ignore_errors=True)
        argv = ["--map-size", MAP_SIZE, "--n-cells", N_CELLS, "--n-steps", n,
                "--logdir", logdir] + (["--pipelined"] if mode == "pipelined" else [])
        got = _driver(torch, "run_simulation", argv, {"k1_k2": n, "grouped": 0})
        final = [line for line in got["lines"] if "final n_cells=" in line]
        n_final = int(final[0].split("final n_cells=")[1])
        ckpts = sorted((logdir / "checkpoints").glob("*.msck"))
        if not (logdir / "step=0" / "cell_molecules.npy").exists() or not ckpts:
            raise AssertionError(f"run_simulation {mode}: no state at step 0 or no checkpoint")
        if mode == "pipelined" and len(ckpts) != 2:
            raise AssertionError(f"run_simulation pipelined: checkpoints {ckpts}")
        world, _, meta = guard.restore_run(guard.CheckpointManager(logdir / "checkpoints"),
                                           device=DRIVERS_DEVICE)
        if world.n_cells != n_final or not meta.get("final"):
            raise AssertionError(f"run_simulation {mode}: the final checkpoint holds"
                                 f" {world.n_cells} cells ({meta}), the run {n_final}")
        _check_state(world, f"run_simulation {mode}'s final checkpoint")
        del world
        got.update(final_n_cells=n_final, checkpoints=len(ckpts))
        out[mode] = got
    return out


def _sweeps(torch) -> dict:
    """check, profile_step, megastep_sweep, fleet_sweep (and its
    ``--mixed-rungs``) and mesh_sweep (and its ``--check``), each with its
    JAX script's keys and its launches."""
    width = ["--n-cells", N_CELLS, "--map-size", MAP_SIZE, "--genome-size", GENOME_SIZE,
             "--seed", SEED]
    out = {}
    r = DRIVER_CHECK["r"]
    out["check"] = _driver(torch, "check", ["--n", N_CELLS, "--s", DRIVER_CHECK["s"], "--r", r,
                                            "--json"], {"k1_k2": r + 1, "grouped": 0})
    _keys(out["check"]["rows"], CHECK_KEYS, "check")
    if [row["op"] for row in out["check"]["rows"]] != CHECK_OPS:
        raise AssertionError(f"check's ops: {[row['op'] for row in out['check']['rows']]}")

    w, n = DRIVER_PROFILE["warmup"], DRIVER_PROFILE["steps"]
    out["profile_step"] = _driver(torch, "profile_step", width + ["--warmup", w, "--steps", n],
                                  {"k1_k2": w + n, "grouped": 0})
    _keys(out["profile_step"]["rows"], PROFILE_KEYS, "profile_step")

    ms = DRIVER_MEGASTEP
    disp = {k: max(ms["warmup"], 3) + -(-ms["steps"] // k) for k in ms["ks"]}
    out["megastep_sweep"] = _driver(
        torch, "megastep_sweep", width + ["--ks", ",".join(map(str, ms["ks"])),
                                          "--steps", ms["steps"], "--warmup", ms["warmup"]],
        {"k1_k2": sum(d * k for k, d in disp.items()), "grouped": 0})
    _keys(out["megastep_sweep"]["rows"], MEGASTEP_KEYS, "megastep_sweep")

    fl = DRIVER_FLEET
    per_point = {k: (max(fl["warmup"], 2) + -(-fl["steps"] // k)) * k for k in fl["ks"]}
    fleet_argv = width + ["--steps", fl["steps"], "--warmup", fl["warmup"]]
    out["fleet_sweep"] = _driver(
        torch, "fleet_sweep", fleet_argv + ["--bs", ",".join(map(str, fl["bs"])),
                                            "--ks", ",".join(map(str, fl["ks"]))],
        {"k1_k2": len(fl["bs"]) * sum(per_point.values()), "grouped": 0})
    _keys(out["fleet_sweep"]["rows"], FLEET_KEYS, "fleet_sweep")
    if any(row["groups"] != 1 for row in out["fleet_sweep"]["rows"]):
        raise AssertionError("fleet_sweep: a fleet took more than one group")
    # per (rungs, B) point: R K2 launches per simulated step per rung,
    # then one grouped launch per simulated step fused
    k0 = fl["ks"][0]
    n_mixed = len(fl["mixed_bs"]) * per_point[k0]
    out["fleet_sweep_mixed"] = _driver(
        torch, "fleet_sweep", fleet_argv + ["--mixed-rungs", "--rungs",
                                            ",".join(map(str, fl["rungs"])),
                                            "--bs", ",".join(map(str, fl["mixed_bs"])),
                                            "--ks", k0],
        {"k1_k2": sum(fl["rungs"]) * n_mixed, "grouped": len(fl["rungs"]) * n_mixed})
    rows = out["fleet_sweep_mixed"]["rows"]
    _keys([row for row in rows if not row["fused"]], FUSED_KEYS, "fleet_sweep --mixed-rungs")
    _keys([row for row in rows if row["fused"]], FUSED_KEYS | {"speedup"},
          "fleet_sweep --mixed-rungs (fused)")

    me = DRIVER_MESH
    out["mesh_sweep"] = _driver(
        torch, "mesh_sweep", width + ["--devices", ",".join(map(str, me["devices"])),
                                      "--steps", me["steps"], "--warmup", me["warmup"]],
        # the one-device row runs in this process; the ranks' launches are
        # their own processes'
        {"k1_k2": max(me["warmup"], 2) + me["steps"], "grouped": 0})
    _keys(out["mesh_sweep"]["rows"], MESH_KEYS, "mesh_sweep")
    out["mesh_sweep_check"] = _driver(
        torch, "mesh_sweep", width + ["--check", "--devices", "2", "--steps", me["check_steps"]],
        {"k1_k2": 0, "grouped": 0})
    _keys(out["mesh_sweep_check"]["rows"], MESH_CHECK_KEYS, "mesh_sweep --check")
    if not all(row["ok"] for row in out["mesh_sweep_check"]["rows"]):
        raise AssertionError("mesh_sweep --check: the mesh differs from one device")
    return out


def _drivers_phase(torch) -> tuple[dict, dict]:
    """Phase 27: the measurement drivers at the headline's width; returns
    its record and the launches per kernel."""
    DRIVERS_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = {"bench": _bench_child(torch), "bench_in_process": _bench_in_process(torch),
           "run_simulation": _run_simulation(torch)}
    out.update(_sweeps(torch))
    out["wall_s"] = time.perf_counter() - t0
    runs = {"bench": out["bench_in_process"]}
    runs.update({f"run_simulation_{m}": v for m, v in out["run_simulation"].items()})
    runs.update({k: v for k, v in out.items() if k not in ("bench", "bench_in_process",
                                                          "run_simulation", "wall_s")})
    launches = {kind: {name: r["launches"][kind] for name, r in runs.items()}
                for kind in ("k1_k2", "grouped", "threefry", "assembly")}
    # the classic World loops assemble through the kernel
    for name in ("bench", "run_simulation_classic"):
        if launches["assembly"][name] == 0:
            raise AssertionError(f"driver {name}: no assembly launch on the card")
    return out, launches


def main() -> None:
    global DUMP_DIR, PARENT, PARENT_LADDER
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card.")
    parser.add_argument(
        "--dump", metavar="DIR", type=Path,
        help="save the worst tiles of each real-state kernel check to DIR",
    )
    parser.add_argument(
        "--parent", metavar="DIR", type=Path,
        help="also run the integrator kernel of an earlier tree unpacked in DIR beside this one",
    )
    # the fresh processes of phases 22 and 26, started by the run itself
    parser.add_argument("--resume-child", metavar="JOBS", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--warm-child", metavar="OUT", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    DUMP_DIR = args.dump
    torch = _environment()
    if args.resume_child is not None:
        _resume_child(torch, args.resume_child)
        return
    if args.warm_child is not None:
        _warm_child(torch, args.warm_child)
        return
    if args.parent is not None:
        PARENT = _load_parent(args.parent.resolve(), "cuda_integrate", "integrate.cu")
        PARENT_LADDER = _load_parent(args.parent.resolve(), "cuda_bisect", "bisect.cu")
    _build()
    _lap("1 build")
    digests = _digests(torch)
    print(json.dumps({"digests": digests}))
    _lap("10 digests")
    sweep = _sweep(torch)
    print(json.dumps({"sweep": sweep}))
    _lap("8 sweep")
    ladder = _ladder(torch)
    print(json.dumps({"kernel_bisect": ladder}))
    _lap("11 ladder")
    threefry = _threefry(torch)
    print(json.dumps({"threefry": threefry}))
    _lap("14 threefry")

    world, spawn_s = _workload(torch)
    p, s = world.kinetics.max_proteins, 2 * world.n_molecules
    print(f"world: {world.n_cells} cells, capacity {world._capacity}, p {p}, s {s},"
          f" spawn {spawn_s:.3f} s")
    kernel = _kernel_check(torch, q=10240, p=p, s=s)
    kernel.update(_world_kernel_check(torch, world))
    kernel["max_abs_err"] = max(kernel["seeded_max_abs_err"], kernel["world_max_abs_err"])
    torch.cuda.reset_peak_memory_stats()
    work = _run_steps(torch, world)
    kernel["launches"] = work["launches"]
    kernel["sha256"] = digests["k1"]
    kernel["sweep"] = sweep
    kernel["ok"] = True
    work["spawn_s"] = spawn_s
    work["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"workload": work}))
    _lap("2-5 classic")
    restored = {"string": _persistence(torch, world)}
    print(json.dumps({"persistence": {"string": restored["string"]}}))
    print(json.dumps({"api": {"string": _api(torch, world)}}))
    _lap("19-20 string")
    del world

    token_world, token_spawn_s = _workload(torch, genome_backend="token")
    torch.cuda.reset_peak_memory_stats()
    token_work = _run_steps(torch, token_world)
    token_work["spawn_s"] = token_spawn_s
    token_work["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    token_work["string_steps_per_s"] = work["steps_per_s"]
    print(json.dumps({"token_workload": token_work}))
    _lap("15 token classic")
    restored["token"] = _persistence(torch, token_world)
    print(json.dumps({"persistence": {"token": restored["token"]}}))
    print(json.dumps({"api": {"token": _api(torch, token_world)}}))
    del token_world
    print(json.dumps({"persistence": {"det_restore": _det_restore(torch)}}))
    _lap("19-20 token, det restore")
    # K1 launches on the new paths: the restored worlds' steps
    kernel["restored_launches"] = {k: v["restored_launches"] for k, v in restored.items()}

    with _Taps() as taps:
        stepper = {}
        for k in (1, 4):
            stepper[f"K{k}"] = _stepper_run(torch, taps, k, capture=k == 1)
            if k == 1:
                stepper_inputs = taps.inputs
        stepper["token_K1"] = _stepper_run(torch, taps, 1, capture=False, genome_backend="token")
        print(json.dumps({"stepper": stepper}))
        _lap("6, 16 stepper")
        fleet = _fleet_run(torch, taps)
        fleet_inputs = taps.inputs
        fleet_token = _fleet_run(torch, taps, genome_backend="token")
        print(json.dumps({"fleet": {"string": fleet, "token": fleet_token}}))
        _lap("7, 17 fleet")
    print(json.dumps({"flags_per_window": taps.flags}))
    if taps.unexpected():
        raise AssertionError(f"flags other than dead_param_residue tripped: {taps.unexpected()}")

    # K2 on seeded inputs: 4 worlds as prefixes of stacks of the fleet's
    # capacity, at q 10240 and at the fleet's q = capacity
    cap = fleet_inputs[0].shape[1]
    X_stack, stack = _k2_stack(torch, cap, p, s)
    seeded = {f"q{q}": _k2_seeded(torch, X_stack, stack, q) for q in (10240, cap)}
    del X_stack, stack
    print(json.dumps({"k2_seeded": seeded}))
    real = {
        "stepper_K1": _k2_real_state(torch, stepper_inputs, "K2 on the stepper's state"),
        "fleet": _k2_real_state(torch, fleet_inputs, "K2 on the fleet's state"),
    }
    print(json.dumps({"k2_real_state": real}))
    _lap("9 K2 checks")
    main_shape = seeded[f"q{cap}"]
    k2 = {
        "name": "integrate_signals_batched",
        "route": "cuda",
        "source": "magicsoup_tpu_torch/csrc/integrate.cu",
        "replaces": "magicsoup_tpu/ops/pallas_integrate.py:186",
        # at the fleet's shape (B 4, q = capacity, world stride = capacity)
        "shape": main_shape["shape"],
        "launches": fleet["launches"],
        "stepper_launches": {key: v["launches"] for key, v in stepper.items()},
        "max_abs_err": max(
            [v["max_abs_err"] for v in seeded.values()]
            + [v["max_abs_err"] for v in real.values()]
        ),
        "seeded": seeded,
        "real_state": real,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "sha256": digests["k2"],
        "ok": True,
    }

    bench = _microbench(torch)
    print(json.dumps({"integrator_bench": bench}))
    _lap("12 microbench")
    genome_ops = _genome_ops()
    print(json.dumps({"genome_ops": genome_ops}))
    _lap("18 genome ops")
    det = _det_on_card(torch)
    print(json.dumps({"det_on_card": det}))
    _lap("13 det on card")
    differential = _differential(torch)
    print(json.dumps({"differential": differential}))
    _lap("21 differential")
    guard_phase, guard_launches = _guard_phase(torch)
    print(json.dumps({"guard": guard_phase}))
    _lap("22 guard")
    kernel["guard_launches"] = {"classic_with_recorder": guard_launches["k1_classic_with_recorder"]}
    k2["guard_launches"] = {k[3:]: v for k, v in guard_launches.items() if k.startswith("k2_")}
    fleet_phase, grouped = _fleet_phase(torch)
    print(json.dumps({"fused_fleet": fleet_phase}))
    _lap("23 fused fleet")
    k2["fleet_restore_launches"] = fleet_phase["fleet_checkpoint"]["restored_launches"]
    k2["mixed_fleet_per_rung_launches"] = fleet_phase["mixed_fleet"]["launches"]["rung"]
    serve, serve_launches = _serve_phase(torch, fleet["steps_per_s_aggregate"])
    print(json.dumps({"serve": serve}))
    _lap("24 serve")
    k2["serve_launches"] = serve_launches["k2"]
    grouped["serve_launches"] = serve_launches["grouped"]
    meshes = _mesh_phase(torch)
    print(json.dumps({"meshes": meshes}))
    _lap("25 meshes")
    head = meshes["headline"]["ranks"]
    kernel["mesh_launches"] = {"classic_per_rank": [r["classic"]["k1_k2"] for r in head]}
    k2["mesh_launches"] = {
        "stepper_per_rank": [r["stepper"]["k1_k2"] for r in head],
        "sharded_fleet_per_rank": [r["launches"] for r in meshes["sharded_fleet"]["fast"]],
    }

    analysis, analysis_launches = _analysis_phase(torch)
    print(json.dumps({"analysis": analysis}))
    _lap("26 analysis")
    kernel["analysis_launches"] = analysis_launches["k1"]
    k2["analysis_launches"] = analysis_launches["k2"]
    grouped["analysis_launches"] = analysis_launches["grouped"]

    drivers, driver_launches = _drivers_phase(torch)
    print(json.dumps({"drivers": drivers}))
    _lap("27 drivers")
    # the classic drivers launch K1, the stepper and fleet drivers K2
    classic_drivers = ("bench", "run_simulation_classic", "check", "profile_step")
    kernel["drivers_launches"] = {k: v for k, v in driver_launches["k1_k2"].items()
                                  if k in classic_drivers}
    k2["drivers_launches"] = {k: v for k, v in driver_launches["k1_k2"].items()
                              if k not in classic_drivers or k == "bench"}
    grouped["drivers_launches"] = {"fleet_sweep_mixed": driver_launches["grouped"]["fleet_sweep_mixed"]}

    assembly = _assembly(torch)
    print(json.dumps({"assembly": assembly}))
    _lap("28 assembly")

    from magicsoup_tpu_torch.performance import card_line

    card = card_line()
    per_path = {
        "token_classic": token_work["threefry_launches"],
        "classic": work["threefry_launches"],
        **{f"stepper_{key}": v["threefry_launches"] for key, v in stepper.items()},
        "fleet": fleet["threefry_launches"],
        "token_fleet": fleet_token["threefry_launches"],
        "guard_recorder_windows": guard_launches["threefry_recorder_windows"],
        "guard_resume_cases": guard_launches["threefry_resume_cases_parent"],
        "mixed_fleet": fleet_phase["mixed_fleet"]["threefry_launches"],
        "mesh_headline_per_rank": [r["classic"]["threefry"] + r["stepper"]["threefry"]
                                   for r in head],
        "mesh_det_gloo_rank0": sum(v["threefry"] for v in meshes["det_gloo"].values()),
        "analysis_windows": analysis_launches["threefry"],
        "drivers": driver_launches["threefry"],
    }
    print(json.dumps({"phase_seconds": _LAPS}))
    print(json.dumps({"run": {"wall_s": time.perf_counter() - RUN_T0}}))
    assembly_per_path = {
        "classic": work["assembly_launches"],
        "token_classic": token_work["assembly_launches"],
        "differential": {k: v["assembly"] for k, v in differential["launches"].items()
                         if "assembly" in v},
        "guard_classic_with_recorder": guard_launches["assembly_classic_with_recorder"],
        "mesh_headline_classic_per_rank": [r["classic"]["assembly"] for r in head],
        "mesh_det_gloo_rank0": {k: v["assembly"] for k, v in meshes["det_gloo"].items()},
        "mesh_det_nccl": {k: meshes["nccl"][k]["assembly"] for k in meshes["det_gloo"]},
        "analysis_windows": analysis_launches["assembly"],
        "drivers": driver_launches["assembly"],
    }
    if sum(assembly_per_path["mesh_headline_classic_per_rank"]) == 0:
        raise AssertionError("meshes (c): no assembly launch in the ranks' classic steps")
    print(json.dumps({"kernels": [kernel, k2, grouped, _k3_entry(ladder),
                                  _threefry_entry(threefry, per_path),
                                  _assembly_entry(assembly, assembly_per_path)]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
