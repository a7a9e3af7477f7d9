"""
Deterministic kill-and-resume of the port's pipelined stepper through a
fresh process, on the CPU, bit for bit:

- for string and token worlds at ``megastep`` 1 and 4, ``[K dispatches,
  save_run, K dispatches]`` in one process equals ``[K dispatches,
  save_run]`` here, then ``restore_run`` / ``PipelinedStepper`` /
  ``restore_stepper`` and K dispatches in a fresh process that imports
  neither JAX nor the JAX package: the world's tensors, genomes,
  counters, every random stream, the device key and the stepper's
  schedule, all byte-equal (no tolerance);
- the ``state_digest`` at the resumed run's end equals the JAX stepper's
  over the same uninterrupted, checkpointed run (its own ``save_run`` at
  the same boundary), so the port resumes onto the reference trajectory;
- a recorder attached before the kill and again after the restart keeps
  one valid JSONL stream (step indices continue);
- ``restore_stepper`` refuses a config mismatch, and a snapshot carries
  no JAX object and pickles an attached recorder detached.

One subprocess runs every restore, to bound the time.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import os  # noqa: E402
import pickle  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402
from magicsoup_tpu import guard as jguard  # noqa: E402
from magicsoup_tpu.check.differential import state_digest as jdigest  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu_torch import guard  # noqa: E402
from magicsoup_tpu_torch import telemetry as ttel  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KW = dict(
    mol_name="ATP",
    kill_below=1.0,
    divide_above=3.0,
    divide_cost=1.0,
    target_cells=40,
    genome_size=300,
    lag=2,
    max_divisions=64,
    spawn_block=16,
    push_block=16,
    p_mutation=1e-3,
    p_recombination=1e-4,
)
# (genome backend, megastep, dispatches on each side of the checkpoint);
# token K 4 checkpoints after 3 dispatches, because after 2 the JAX
# stepper's flush fails on a refresh of a blanked dead row (ROADMAP C6,
# pinned with the port's repair in tests/test_torch_stepper.py)
CASES = [("string", 1, 4), ("string", 4, 2), ("token", 1, 4), ("token", 4, 3)]


def _ids(case):
    return f"{case[0]}-k{case[1]}"


def _world(lib, chem, seed: int, backend: str, **kw):
    w = lib.World(chemistry=chem, map_size=16, seed=seed, genome_backend=backend, **kw)
    rng = random.Random(seed)
    w.spawn_cells([lib.random_genome(s=300, rng=rng) for _ in range(20)])
    w._ensure_capacity(100)
    return w


# the fingerprint both processes take; kept as source so that the fresh
# process runs it without importing this module (which imports JAX)
_FINGERPRINT = '''
import numpy as np
from magicsoup_tpu_torch import guard
from magicsoup_tpu_torch.check import audit_world
from magicsoup_tpu_torch.check.differential import state_digest as tdigest


def fingerprint(world, st) -> dict:
    """Every piece of resume-relevant state, as plain host data (flushes
    the stepper through ``snapshot_run``)."""
    snap = guard.snapshot_run(world, st)
    n = world.n_cells
    aux = snap["stepper"]
    return {
        "n_cells": n,
        "genomes": list(world.cell_genomes),
        "labels": list(world.cell_labels),
        "mm": world.molecule_map.numpy().tobytes(),
        "cm": np.asarray(world.cell_molecules)[:n].tobytes(),
        "params": [t[:n].numpy().tobytes() for t in world.kinetics.params],
        "positions": np.asarray(world.cell_positions).tobytes(),
        "lifetimes": np.asarray(world.cell_lifetimes).tobytes(),
        "divisions": np.asarray(world.cell_divisions).tobytes(),
        "world_rng": snap["world_rng_state"],
        "world_nprng": repr(snap["world_nprng_state"]),
        "key": np.asarray(aux["key"]).tobytes(),
        "stepper_rng": repr(aux["rng_state"]),
        "spawn_queue": aux["spawn_queue"],
        "growth_hist": aux["growth_hist"],
        "change_seq": aux["change_seq"],
        "dispatched_seq": aux["dispatched_seq"],
        "stats": {k: v for k, v in aux["stats"].items() if not k.endswith("_ms")},
        "state_digest": tdigest(world),
        # the audit's findings (the dead-row parameter residue of ROADMAP
        # C3 shows at some flushes, in the JAX package too): the same on
        # both sides
        "audit": sorted(str(v) for v in audit_world(world)),
    }
'''
exec(_FINGERPRINT)


# the fresh process: restores each case's checkpoint onto the CPU and
# continues; it imports the port only
_CHILD = textwrap.dedent(
    """
    import pickle, sys
    from pathlib import Path
    sys.path.insert(0, sys.argv[1])
    import magicsoup_tpu_torch as mt
    from magicsoup_tpu_torch import guard
    jobs = pickle.loads(Path(sys.argv[2]).read_bytes())
    exec(jobs.pop("_fingerprint"))
    out = {}
    for name, job in jobs.items():
        world, aux, meta = guard.restore_run(guard.CheckpointManager(job["dir"]), device="cpu")
        if job.get("telemetry"):
            world.telemetry.attach(job["telemetry"])
        st = mt.PipelinedStepper(world, **job["kwargs"])
        guard.restore_stepper(st, aux)
        for _ in range(job["dispatches"]):
            st.step()
        out[name] = {"fp": fingerprint(world, st), "meta": meta}
        world.telemetry.detach()
    out["_jax_loaded"] = "jax" in sys.modules or "magicsoup_tpu" in sys.modules
    Path(sys.argv[3]).write_bytes(pickle.dumps(out))
    """
)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Run every case's reference and victim here, and every restore in
    one fresh process; returns ``{case: (reference, resumed, jax digest,
    jsonl path)}``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    root = tmp_path_factory.mktemp("resume")
    jobs, refs = {}, {}
    try:
        for backend, k, n in CASES:
            name = f"{backend}-k{k}"
            kwargs = dict(KW, megastep=k)
            # reference: checkpoints at the same boundary (a pipelined
            # checkpoint is a flush), then continues uninterrupted
            wa = _world(mt, TCHEM, 3, backend, device="cpu")
            sa = mt.PipelinedStepper(wa, **kwargs)
            for _ in range(n):
                sa.step()
            guard.save_run(guard.CheckpointManager(root / name / "ref"), wa, sa, step=n)
            for _ in range(n):
                sa.step()
            ref = fingerprint(wa, sa)
            # victim: the same n dispatches, a checkpoint, then it "dies"
            tpath = root / name / "run.jsonl"
            wb = _world(mt, TCHEM, 3, backend, device="cpu", telemetry=tpath)
            sb = mt.PipelinedStepper(wb, **kwargs)
            for _ in range(n):
                sb.step()
            guard.save_run(guard.CheckpointManager(root / name / "ckpt"), wb, sb)
            wb.telemetry.detach()
            del wb, sb
            # the JAX stepper over the same checkpointed run
            jw = _world(ms, JCHEM, 3, backend)
            js = ms.PipelinedStepper(jw, **kwargs)
            for _ in range(n):
                js.step()
            jguard.save_run(jguard.CheckpointManager(root / name / "jax"), jw, js, step=n)
            for _ in range(n):
                js.step()
            js.flush()
            refs[name] = (ref, jdigest(jw), tpath)
            jobs[name] = dict(
                dir=str(root / name / "ckpt"), kwargs=kwargs, dispatches=n, telemetry=str(tpath)
            )
        (root / "jobs.pkl").write_bytes(pickle.dumps(dict(jobs, _fingerprint=_FINGERPRINT)))
        env = dict(os.environ, MAGICSOUP_TPU_DETERMINISTIC="1", PYTHONPATH=str(REPO))
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, str(REPO), str(root / "jobs.pkl"), str(root / "out.pkl")],
            env=env,
            capture_output=True,
            text=True,
            timeout=600,
        )
        assert proc.returncode == 0, proc.stderr[-4000:]
        out = pickle.loads((root / "out.pkl").read_bytes())
    finally:
        mp.undo()
    assert out.pop("_jax_loaded") is False  # the restore needs no JAX
    return {name: (refs[name][0], out[name], refs[name][1], refs[name][2]) for name in refs}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_det_kill_resume_in_a_fresh_process_is_bit_equal(resumed, case):
    ref, got, _, _ = resumed[f"{case[0]}-k{case[1]}"]
    assert got["meta"]["step"] == case[2] * case[1]
    fp = got["fp"]
    assert fp.keys() == ref.keys()
    for key in ref:
        assert fp[key] == ref[key], f"{key} differs after the resume"
    assert ref["n_cells"] > 0 and ref["stats"]["divisions"] > 0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_resumed_state_digest_equals_the_jax_stepper(resumed, case):
    ref, got, jax_digest, _ = resumed[f"{case[0]}-k{case[1]}"]
    assert got["fp"]["state_digest"] == ref["state_digest"] == jax_digest


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_recorder_stream_continues_across_the_restart(resumed, case):
    *_, path = resumed[f"{case[0]}-k{case[1]}"]
    rows = ttel.read_jsonl(path)
    assert ttel.validate_rows(rows) == []
    steps = [r["step"] for r in rows if r["type"] == "step"]
    n = case[1] * case[2]
    assert steps == list(range(1, 2 * n + 1))
    assert sum(r["type"] == "meta" for r in rows) == 2  # one per attach


def test_restore_stepper_refuses_a_config_mismatch(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    w = _world(mt, TCHEM, 5, "string", device="cpu")
    st = mt.PipelinedStepper(w, **dict(KW, megastep=2))
    st.step()
    mgr = guard.CheckpointManager(tmp_path)
    guard.save_run(mgr, w, st)
    w2, aux, _ = guard.restore_run(mgr, device="cpu")
    other = mt.PipelinedStepper(w2, **dict(KW, megastep=4))
    with pytest.raises(guard.CheckpointError, match="megastep") as e:
        guard.restore_stepper(other, aux)
    assert e.value.check == "config"
    # the stepper config names the same knobs as the JAX package's
    jw = _world(ms, JCHEM, 5, "string")
    assert set(guard.stepper_config(st)) == set(
        jguard.stepper_config(ms.PipelinedStepper(jw, **dict(KW, megastep=2)))
    )


def test_snapshot_survives_pickle_of_attached_telemetry(tmp_path):
    w = _world(mt, TCHEM, 5, "string", device="cpu", telemetry=tmp_path / "t.jsonl")
    st = mt.PipelinedStepper(w, **KW)
    st.step()
    mgr = guard.CheckpointManager(tmp_path / "ckpt")
    guard.save_run(mgr, w, st, step=1)
    w2, aux, meta = guard.restore_run(mgr, device="cpu")
    assert meta["step"] == 1 and aux["config"]["megastep"] == 1
    assert not w2.telemetry.attached
    w2.telemetry.flush(sync=True)  # idempotent while detached
    w.telemetry.flush(sync=True)
    w.telemetry.detach()
    payload = guard.read_checkpoint(mgr.latest())[0]
    assert payload["format"] == guard.resume.RUN_FORMAT
    assert isinstance(payload["stepper"]["key"], np.ndarray)
    assert payload["stepper"]["key"].dtype == np.int64 and payload["stepper"]["key"].shape == (1, 2)
