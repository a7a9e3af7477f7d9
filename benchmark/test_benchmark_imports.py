"""Neither a run nor the reference loads JAX or the JAX package; the
reference loads nothing of the program either.  Module names are
compared whole at the top level: the program's name begins with the JAX
package's."""
import json
import subprocess
import sys

from benchmark import run

RUN_CODE = """
import json, os
os.environ["MAGICSOUP_TPU_TORCH_INTEGRATOR"] = "cuda"
from benchmark import run, readings, trace, roofline
from benchmark.conftest import tiny_cell
manifest, cell, workload, config = tiny_cell("wl-10k-128.classic")
run.run_cell(manifest, cell, workload, config, seed=3, seconds=0.2, trace=False, device="cpu")
for m in manifest["per_layer"]:
    run.metric_reader(m["name"])
import sys
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_CODE = """
import json, sys
from benchmark.reference import judge, kinetics, genetics, physics
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    env = {k: v for k, v in __import__("os").environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(RUN_CODE)
    assert "magicsoup_tpu_torch" in names
    assert not names & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE_CODE)
    assert not names & (set(run.FORBIDDEN) | {"magicsoup_tpu_torch", "benchmark.drivers"})
    assert "torch" in names


def test_forbidden_names_are_whole(monkeypatch):
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "magicsoup_tpu_torchlike.sub", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.fake", sys)
    assert set(run.forbidden_modules()) == before | {"jax"}
