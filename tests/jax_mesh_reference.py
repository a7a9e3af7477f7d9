"""
The JAX package's runs on its two-device CPU mesh that the port's mesh
tests hold themselves to, computed in a process of their own:

    python tests/jax_mesh_reference.py '[["halo", {"det": true}], ...]'

prints one JSON line with each job's result, in order.  A process of its
own, with no persistent compilation cache: the test process shares one
cache directory with other test processes, among them multi-process JAX
runs whose multi-device programs it cannot tell apart from these, and a
mesh program loaded from it ran with the wrong record layout or stalled
in its collectives until XLA aborted the process.  The child also raises
XLA's CPU collective terminate timeout (a setting a test process whose
JAX backend already exists cannot take) and, past
:data:`STALL_SECONDS`, prints every thread's stack and exits.  Tests
call :func:`jax_reference`.
"""
import json
import os
import random
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_FLAGS = (
    " --xla_force_host_platform_device_count=8"
    " --xla_cpu_collective_call_terminate_timeout_seconds=1800"
    " --xla_cpu_collective_timeout_seconds=1800"
)


#: seconds the child may take before it prints its threads' stacks and
#: exits
STALL_SECONDS = 600


def jax_reference(jobs: list) -> list:
    """Run ``jobs`` (``[name, kwargs]`` pairs) in a child; their results."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + _FLAGS)
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), json.dumps(jobs)],
        env=env,
        capture_output=True,
        text=True,
        timeout=STALL_SECONDS + 60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX reference run failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _setup():
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)


def halo(det: bool) -> list:
    """``tiled.halo_diffuse`` over two tiles of the mesh tests' map."""
    import jax
    import numpy as np

    from magicsoup_tpu.ops import diffusion
    from magicsoup_tpu.parallel import tiled

    rng = np.random.default_rng(0)
    mm = (rng.random((3, 24, 24)) * 10).astype(np.float32)
    kernels = diffusion.diffusion_kernels([0.1, 1.0, 0.3])
    mesh = tiled.make_mesh(2)
    out = tiled.halo_diffuse(
        jax.device_put(mm, tiled.map_sharding(mesh)), jax.numpy.asarray(kernels), mesh, det=det
    )
    return np.asarray(out).tolist()


def lifecycle(det: bool) -> str:
    """``tests/fast/test_parallel.py::_lifecycle`` on two tiles; its
    state digest."""
    import numpy as np

    import magicsoup_tpu as ms
    from magicsoup_tpu.check import differential
    from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu.parallel import tiled

    world = ms.World(chemistry=CHEMISTRY, map_size=64, seed=9, mesh=tiled.make_mesh(2))
    world.deterministic = det
    rng = random.Random(1)
    world.spawn_cells([ms.random_genome(s=500, rng=rng) for _ in range(64)])
    for _ in range(5):
        world.enzymatic_activity()
        cm = world.cell_molecules
        world.kill_cells(np.nonzero(cm[:, 2] < 0.2)[0].tolist())
        cm = world.cell_molecules
        world.divide_cells(np.nonzero(cm[:, 2] > 4.0)[0].tolist())
        world.mutate_cells(p=1e-4)
        world.recombinate_cells(p=1e-6)
        world.degrade_molecules()
        world.diffuse_molecules()
        world.increment_cell_lifetimes()
    return differential.state_digest(world)


def sharded_stepper(megastep: int, stepper_kw: dict) -> str:
    """``tests/fast/test_sharded_stepper.py``'s det run on two tiles,
    ``8 // megastep`` dispatches; its state digest."""
    import magicsoup_tpu as ms
    from magicsoup_tpu.check import differential
    from magicsoup_tpu.parallel import tiled

    mols = [
        ms.Molecule("shs-a", 10e3),
        ms.Molecule("shs-atp", 8e3, half_life=100_000),
        ms.Molecule("shs-c", 4e3, permeability=0.3),
    ]
    chem = ms.Chemistry(molecules=mols, reactions=[([mols[0]], [mols[1]]), ([mols[1]], [mols[2]])])
    world = ms.World(chemistry=chem, map_size=32, seed=7, mesh=tiled.make_mesh(2))
    world.deterministic = True
    rng = random.Random(7)
    world.spawn_cells([ms.random_genome(s=300, rng=rng) for _ in range(50)])
    st = ms.PipelinedStepper(world, **dict(stepper_kw, megastep=megastep))
    for _ in range(8 // megastep):
        st.step()
    st.flush()
    return differential.state_digest(world)


def mesh_path(path: str, seed: int, n_cells: int) -> list:
    """The JAX harness's ``mesh2`` / ``token_mesh2`` in det mode."""
    from magicsoup_tpu.check import differential

    os.environ["MAGICSOUP_TPU_DETERMINISTIC"] = "1"
    return differential.run_path(path, seed=seed, n_cells=n_cells)


def main() -> None:
    import faulthandler

    faulthandler.dump_traceback_later(STALL_SECONDS, exit=True)
    _setup()
    jobs = json.loads(sys.argv[1])
    print(json.dumps([globals()[name](**kw) for name, kw in jobs]))


if __name__ == "__main__":
    main()
