"""
The port's multi-process entry (``magicsoup_tpu_torch.parallel.multihost``),
the counterpart of ``tests/fast/test_multihost.py``: two coordinated CPU
processes join one gloo process group through ``multihost.initialize``
(TCP on the loopback, every wait bounded) and build the global mesh:

- the halo diffusion equals one process: bit for bit in deterministic
  mode (the port's and the JAX package's ``diffuse``), within rtol 1e-5
  in fast mode;
- the documented workflow (a mesh-placed World, the same script on every
  process, seed-driven lockstep through a full lifecycle step) lands on
  the state of the same seeded run in one process, bit for bit in
  deterministic mode, and on the JAX package's;
- without arguments ``initialize`` reads the environment ``torchrun``
  sets.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import os  # noqa: E402
import random  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = str(Path(__file__).resolve().parents[1])
TESTS = str(Path(__file__).resolve().parent)

_CHILD = r"""
import os, random, sys
import numpy as np
import torch

torch.set_num_threads(1)
proc_id, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from magicsoup_tpu_torch.parallel import multihost
from torch_mesh_runs import halo_diffusion
from magicsoup_tpu_torch.ops import diffusion as _diff

multihost.initialize(f"127.0.0.1:{port}", 2, proc_id, timeout=60)
mesh = multihost.global_mesh(device="cpu")
assert (mesh.size, mesh.rank, mesh.backend) == (2, proc_id, "gloo")
rng = np.random.default_rng(0)
mm = (rng.random((3, 24, 24)) * 10).astype(np.float32)  # identical on both
kernels = _diff.diffusion_kernels([0.1, 1.0, 0.3])
out = halo_diffusion(mesh, mm, kernels, det=False)
out_det = halo_diffusion(mesh, mm, kernels, det=True)

# the documented workflow: a mesh-placed World, the same script on every
# process, seed-driven lockstep through a full lifecycle step
import magicsoup_tpu_torch as mt
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY

world = mt.World(chemistry=CHEMISTRY, map_size=16, seed=7, mesh=mesh)
world.deterministic = True
wrng = random.Random(7)
world.spawn_cells([mt.random_genome(s=300, rng=wrng) for _ in range(12)])
world.enzymatic_activity()
cm = world.cell_molecules
world.kill_cells(np.nonzero(cm[:, 2] < 0.05)[0].tolist())
cm = world.cell_molecules
world.divide_cells(np.nonzero(cm[:, 2] > 3.0)[0].tolist())
world.mutate_cells(p=1e-3)
world.recombinate_cells(p=1e-5)
world.degrade_and_diffuse_molecules()
mm_w = world.molecule_map.numpy()
cm_w = world.cell_molecules.copy()
meta = f"{world.n_cells} {','.join(world.cell_genomes)[:64]}"
if proc_id == 0:
    np.save(os.path.join(outdir, "out.npy"), out)
    np.save(os.path.join(outdir, "out_det.npy"), out_det)
    np.save(os.path.join(outdir, "world_mm.npy"), mm_w)
    np.save(os.path.join(outdir, "world_cm.npy"), cm_w)
    with open(os.path.join(outdir, "world_meta.txt"), "w") as fh:
        fh.write(meta)
"""

_ENV_CHILD = r"""
import torch
from magicsoup_tpu_torch.parallel import multihost

multihost.initialize(timeout=60)
mesh = multihost.global_mesh(device="cpu")
got = mesh.all_gather(torch.tensor([float(mesh.rank)]), 0)
assert got.tolist() == [0.0, 1.0], got
assert multihost.choose_backend(2) == "gloo"
print("ok", mesh.rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(args_for, env_for=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, TESTS]))
    procs = [
        subprocess.Popen(
            args_for(i),
            env=dict(env, **(env_for(i) if env_for else {})),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {i} failed:\n{out[-3000:]}"
    return outs


def test_two_process_halo_diffusion_matches_single_process(tmp_path):
    import torch

    import magicsoup_tpu as ms
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu.check import differential as jdiff
    from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM
    from magicsoup_tpu.ops import diffusion as jdiff_ops
    from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY
    from magicsoup_tpu_torch.ops import diffusion as tdiff

    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    port = str(_free_port())
    _run(lambda i: [sys.executable, str(script), str(i), port, str(tmp_path)])

    rng = np.random.default_rng(0)
    mm = (rng.random((3, 24, 24)) * 10).astype(np.float32)
    kernels = tdiff.diffusion_kernels([0.1, 1.0, 0.3])
    ref = tdiff.diffuse(torch.from_numpy(mm), torch.from_numpy(kernels)).numpy()
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), ref, rtol=1e-5)
    # deterministic mode: bit-identical across process counts, and to
    # the JAX package's single-device diffusion
    ref_det = tdiff.diffuse(torch.from_numpy(mm), torch.from_numpy(kernels), det=True).numpy()
    got_det = np.load(tmp_path / "out_det.npy")
    assert got_det.tobytes() == ref_det.tobytes()
    jref = np.asarray(
        jdiff_ops.diffuse(jax.numpy.asarray(mm), jax.numpy.asarray(kernels), det=True)
    )
    assert got_det.tobytes() == jref.tobytes()

    # the two-process lifecycle against the same seeded run in one
    # process, with no mesh: the port's and the JAX package's
    def lifecycle(world, random_genome):
        world.deterministic = True
        wrng = random.Random(7)
        world.spawn_cells([random_genome(s=300, rng=wrng) for _ in range(12)])
        world.enzymatic_activity()
        cm = np.asarray(world.cell_molecules)
        world.kill_cells(np.nonzero(cm[:, 2] < 0.05)[0].tolist())
        cm = np.asarray(world.cell_molecules)
        world.divide_cells(np.nonzero(cm[:, 2] > 3.0)[0].tolist())
        world.mutate_cells(p=1e-3)
        world.recombinate_cells(p=1e-5)
        world.degrade_and_diffuse_molecules()
        return world

    tw = lifecycle(mt.World(chemistry=CHEMISTRY, map_size=16, seed=7, device="cpu"), mt.random_genome)
    got_mm = np.load(tmp_path / "world_mm.npy")
    assert got_mm.tobytes() == tw.molecule_map.numpy().tobytes()
    assert np.load(tmp_path / "world_cm.npy").tobytes() == tw.cell_molecules.tobytes()
    meta = (tmp_path / "world_meta.txt").read_text()
    assert meta == f"{tw.n_cells} {','.join(tw.cell_genomes)[:64]}"
    jw = lifecycle(ms.World(chemistry=JCHEM, map_size=16, seed=7), ms.random_genome)
    assert got_mm.tobytes() == np.asarray(jw.molecule_map).tobytes()
    from magicsoup_tpu_torch.check import differential as tdiffer

    assert tdiffer.state_digest(tw) == jdiff.state_digest(jw)


def test_initialize_reads_the_torchrun_environment(tmp_path):
    script = tmp_path / "env_child.py"
    script.write_text(_ENV_CHILD)
    port = str(_free_port())
    outs = _run(
        lambda i: [sys.executable, str(script)],
        lambda i: dict(
            MASTER_ADDR="127.0.0.1",
            MASTER_PORT=port,
            WORLD_SIZE="2",
            RANK=str(i),
            LOCAL_RANK=str(i),
            LOCAL_WORLD_SIZE="2",
        ),
    )
    assert [o.strip().splitlines()[-1] for o in outs] == ["ok 0", "ok 1"]
