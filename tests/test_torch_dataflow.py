"""
The port's interprocedural dataflow layer
(:mod:`magicsoup_tpu_torch.analysis.dataflow`), the counterpart of
tests/fast/test_dataflow.py: the taint fixpoint over torch producers
(returns, tuple unpacking, attribute round-trips, container escape, the
fetch-cache idiom), torch's host metadata, the GL019-GL022 scoping and
waivers, the chaos probe/registry drift proofs against the port's
``guard.chaos.FAULT_POINTS``, the D2H inventory of the ``--json`` report,
and the callgraph extensions the fixpoint rides on.

Pure stdlib analysis: no torch tensor, no device.
"""
import contextlib
import io
import json
import os
import tempfile
from pathlib import Path

import pytest

from magicsoup_tpu_torch.analysis import analyze
from magicsoup_tpu_torch.analysis import engine as lint_engine
from magicsoup_tpu_torch.analysis import sarif
from magicsoup_tpu_torch.analysis.rules import RULE_INFO

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_data" / "graftlint"


def _ctx_for(tmp_path, src: str, name: str = "mod.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    return lint_engine.build_context([p])


def _key(ctx, qualname: str):
    return next(k for k in ctx.graph.functions if k[1] == qualname)


# ------------------------------------------------- taint propagation
def test_return_taint_flows_through_calls(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "import torch\n"
        "def producer(x):\n"
        "    return torch.exp(x)\n"
        "def relay(x):\n"
        "    y = producer(x)\n"
        "    return y\n"
        "def host_only():\n"
        "    return [1, 2, 3]\n",
    )
    df = ctx.dataflow
    assert _key(ctx, "producer") in df.returns_device
    assert _key(ctx, "relay") in df.returns_device  # interprocedural
    assert _key(ctx, "host_only") not in df.returns_device


def test_tuple_unpack_is_per_element(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "import torch\n"
        "def pair(x):\n"
        "    return torch.exp(x), 7\n"
        "def take_device(x):\n"
        "    d, n = pair(x)\n"
        "    return d\n"
        "def take_host(x):\n"
        "    d, n = pair(x)\n"
        "    return n\n",
    )
    df = ctx.dataflow
    assert _key(ctx, "take_device") in df.returns_device
    assert _key(ctx, "take_host") not in df.returns_device


def test_attribute_taint_round_trip(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "import torch\n"
        "class Holder:\n"
        "    def fill(self, dev):\n"
        "        self._buf = torch.zeros(4, device=dev)\n"
        "    def read(self):\n"
        "        return self._buf\n",
    )
    df = ctx.dataflow
    assert _key(ctx, "Holder.read") in df.returns_device
    assert any(a[1:] == ("Holder", "_buf") for a in df.attr_device)


def test_container_escape_taints_list(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "import torch\n"
        "def collect(dev):\n"
        "    out = []\n"
        "    for i in range(3):\n"
        "        out.append(torch.ones(2, device=dev))\n"
        "    return out\n",
    )
    assert _key(ctx, "collect") in ctx.dataflow.returns_device


def test_fetch_cache_idiom_stays_host(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "import torch\n"
        "from magicsoup_tpu_torch.util import fetch_host\n"
        "class Cache:\n"
        "    def refresh(self, dev: torch.Tensor):\n"
        "        self._pair = (dev, fetch_host(dev))\n"
        "        return self._pair[1]\n",
    )
    assert _key(ctx, "Cache.refresh") not in ctx.dataflow.returns_device


def test_host_scalar_annotation_certifies_return(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "import torch\n"
        "def token(x):\n"
        "    return (1, torch.exp(x))\n"
        "def unchanged(a, b) -> bool:\n"
        "    t = token(a)\n"
        "    return a is t or b is t\n"
        "def leaky(a, b):\n"
        "    return token(a)\n",
    )
    df = ctx.dataflow
    assert _key(ctx, "unchanged") not in df.returns_device
    assert _key(ctx, "leaky") in df.returns_device


def test_torch_host_metadata_and_host_factories_are_host(tmp_path):
    # the torch reading of the lattice: metadata reads, a factory without
    # device= (a CPU tensor), a pinned buffer, torch.from_numpy and the
    # conversions are host; as_tensor keeps its argument's place
    ctx = _ctx_for(
        tmp_path,
        "import torch\n"
        "def meta(x: torch.Tensor):\n"
        "    return (x.shape, x.dtype, x.device, x.is_cuda, x.numel(), x.dim(),\n"
        "            x.stride(), x.data_ptr(), x.is_contiguous())\n"
        "def cpu_factory(n):\n"
        "    return torch.zeros(n)\n"
        "def pinned(x: torch.Tensor):\n"
        "    return torch.empty(x.shape, pin_memory=True)\n"
        "def from_host(a):\n"
        "    return torch.from_numpy(a)\n"
        "def converted(x: torch.Tensor):\n"
        "    return x.cpu()\n"
        "def kept(x: torch.Tensor):\n"
        "    return torch.as_tensor(x)\n"
        "def placed(x: torch.Tensor, n):\n"
        "    return torch.zeros(n, device=x.device)\n",
    )
    df = ctx.dataflow
    for host in ("meta", "cpu_factory", "pinned", "from_host", "converted"):
        assert _key(ctx, host) not in df.returns_device, host
    for dev in ("kept", "placed"):
        assert _key(ctx, dev) in df.returns_device, dev


def test_items_keys_and_enumerate_bind_host_keys(tmp_path):
    # iterating a dict of tensors: the key is host, the value device
    ctx = _ctx_for(
        tmp_path,
        "import torch\n"
        "def names(params: torch.Tensor):\n"
        "    out = []\n"
        "    for name, t in params._asdict().items():\n"
        "        out.append(name)\n"
        "    return out\n"
        "def values(params: torch.Tensor):\n"
        "    out = []\n"
        "    for name, t in params._asdict().items():\n"
        "        out.append(t)\n"
        "    return out\n"
        "def idxs(xs: torch.Tensor):\n"
        "    return [i for i, x in enumerate(xs)]\n",
    )
    df = ctx.dataflow
    assert _key(ctx, "names") not in df.returns_device
    assert _key(ctx, "values") in df.returns_device
    assert _key(ctx, "idxs") not in df.returns_device


# ----------------------------------------------- scoping and waivers
def test_gl019_waivable_like_the_other_rules(tmp_path):
    src = (FIXTURES / "gl019_implicit_sync.py").read_text()
    waived = src.replace(
        "# GL019: `if` on a device value that flowed in through a call",
        "# graftlint: disable=GL019 fixture",
    )
    assert waived != src
    p = tmp_path / "gl019_waived.py"
    p.write_text(waived)
    assert analyze([p]) == []


def test_gl019_scoped_to_hot_functions(tmp_path):
    src = (FIXTURES / "gl019_implicit_sync.py").read_text()
    cold = src.replace("# graftlint: hot\n", "")
    assert cold != src
    p = tmp_path / "gl019_cold.py"
    p.write_text(cold)
    assert analyze([p], rules=["GL019"]) == []


def test_gl019_mask_indexing_and_fstring_through_a_call(tmp_path):
    p = tmp_path / "gl019_forms.py"
    p.write_text(
        "import torch\n"
        "def _alive(state):\n"
        "    return torch.sum(state, 1)\n"
        "# graftlint: hot\n"
        "def hot(state, rows):\n"
        "    a = _alive(state)\n"
        "    live = rows[a > 0]\n"
        "    msg = f'{a}'\n"
        "    return live, msg, len(a)\n"
    )
    findings = analyze([p], rules=["GL019"])
    assert [(f.rule, f.line) for f in findings] == [("GL019", 7), ("GL019", 8)]


def test_gl020_exempts_the_boundary_module(tmp_path):
    src = (FIXTURES / "gl020_fetch_bypass.py").read_text()
    p = tmp_path / "util.py"
    p.write_text(src)
    assert analyze([p], rules=["GL020"]) == []


def test_gl021_scoped_to_guarded_subsystems(tmp_path):
    src = (FIXTURES / "gl021_unprobed_boundary.py").read_text()
    unscoped = src.replace(
        "from magicsoup_tpu_torch.guard import chaos\n", "chaos = None\n"
    ).replace("chaos.site", "(lambda _s: None)")
    p = tmp_path / "gl021_unscoped.py"
    p.write_text(unscoped)
    assert analyze([p], rules=["GL021"]) == []


def test_gl022_scoped_to_certified_entries(tmp_path):
    src = (FIXTURES / "gl022_untyped_escape.py").read_text()
    renamed = src.replace("MiniWarden", "MiniKeeper")
    assert renamed != src
    p = tmp_path / "gl022_unscoped.py"
    p.write_text(renamed)
    assert analyze([p], rules=["GL022"]) == []


# ------------------------------------------- chaos coverage (GL021)
def test_gl021_probe_deletion_is_caught():
    src = (FIXTURES / "gl021_unprobed_boundary.py").read_text()
    mutated = "\n".join(
        "#" + line
        if ("chaos.site(" in line or "if fault" in line or "raise fault" in line)
        else line
        for line in src.splitlines()
    )
    assert mutated != src
    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "gl021_mutated.py"
        p.write_text(mutated)
        findings = analyze([p], rules=["GL021"])
    probed_except = next(
        i
        for i, line in enumerate(src.splitlines(), start=1)
        if "injectable: the probe above raises into it" in line
    )
    assert len(findings) == 2  # the original finding PLUS the mutation
    assert probed_except in {f.line for f in findings}


def test_gl021_registry_drift_both_directions(tmp_path):
    (tmp_path / "guard").mkdir()
    (tmp_path / "guard" / "chaos.py").write_text(
        "FAULT_POINTS = {\n"
        '    "io.write": ("magicsoup_tpu_torch.guard.io", "write_it"),\n'
        '    "ghost.site": ("magicsoup_tpu_torch.guard.io", "no_such_probe"),\n'
        "}\n"
    )
    (tmp_path / "guard" / "io.py").write_text(
        "from magicsoup_tpu_torch.guard import chaos\n"
        "def write_it(path):\n"
        '    fault = chaos.site("io.write")\n'
        "    if fault is not None:\n"
        "        raise fault.as_oserror()\n"
        "def rogue(path):\n"
        '    fault = chaos.site("unregistered.site")\n'
        "    if fault is not None:\n"
        "        raise fault.as_oserror()\n"
    )
    msgs = [f.message for f in analyze([tmp_path / "guard"], rules=["GL021"])]
    assert any("'unregistered.site'" in m and "missing from" in m for m in msgs)
    assert any("'ghost.site'" in m and "no matching probe" in m for m in msgs)
    assert not any("'io.write'" in m for m in msgs)


def test_fault_points_registry_matches_runtime():
    # every chaos site of the port is probed where its registry row says
    from magicsoup_tpu_torch.guard import chaos

    rows = chaos.fault_points()
    assert sorted(r["site"] for r in rows) == sorted(chaos.SITES)
    for r in rows:
        assert r["kinds"] == list(chaos.SITES[r["site"]])
        assert r["module"].startswith("magicsoup_tpu_torch.")
        assert r["callable"]
    assert sorted(chaos.FAULT_POINTS) == sorted(chaos.SITES)


# ------------------------------------------------- D2H certification
@pytest.fixture(scope="module")
def cli_tree_report(tmp_path_factory):
    """ONE full-tree `--check --json --sarif` CLI run shared by the
    report-schema and inventory tests."""
    from magicsoup_tpu_torch.analysis import cli

    sarif_path = tmp_path_factory.mktemp("sarif") / "out.sarif"
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(ROOT)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--check", "--json", "--sarif", str(sarif_path)])
    finally:
        os.chdir(old)
    return rc, json.loads(buf.getvalue()), sarif_path


def test_d2h_inventory_pins_the_sanctioned_crossings(cli_tree_report):
    _, report, _ = cli_tree_report
    rows = report["d2h"]
    seen = {(r["file"], r["function"], r["kind"]) for r in rows}
    for expected in [
        ("magicsoup_tpu_torch/world.py", "World._host_molecule_map", "fetch_host"),
        ("magicsoup_tpu_torch/world.py", "World._host_cell_molecules", "fetch_host"),
        ("magicsoup_tpu_torch/world.py", "World.cell_molecule_column", "fetch_host"),
        ("magicsoup_tpu_torch/guard/resume.py", "snapshot_run", "fetch_host"),
    ]:
        assert expected in seen, expected
    # every crossing the analysis can prove is routed through the boundary,
    # but the host-side checks of the kernel ladder and the benchmarks,
    # which compare a kernel's output with its plain version
    loose = {r["file"] for r in rows if not r["sanctioned"]}
    assert loose <= {
        "magicsoup_tpu_torch/ops/cuda_bisect.py",
        "magicsoup_tpu_torch/performance/kernel_bisect.py",
    }, loose
    assert rows == sorted(rows, key=lambda r: (r["file"], r["line"], r["kind"]))


def test_cli_json_reports_d2h_and_fixpoint(cli_tree_report):
    rc, report, sarif_path = cli_tree_report
    assert rc == 0, report
    assert report["schema"] == "graftlint/1"
    for code in ("GL019", "GL020", "GL021", "GL022"):
        assert report["counts"][code] == 0  # enabled by default, clean
    assert report["dataflow_iterations"] >= 1
    assert set(report["timings"]) == {"parse", "callgraph", "threadmodel", "dataflow", "rules"}
    log = json.loads(sarif_path.read_text())
    assert log["version"] == "2.1.0"
    driver = log["runs"][0]["tool"]["driver"]
    assert driver["name"] == "graftlint"
    assert {r["id"] for r in driver["rules"]} == set(RULE_INFO)
    assert log["runs"][0]["results"] == []  # clean tree


def test_sarif_maps_findings_with_locations():
    findings = analyze([FIXTURES / "gl019_implicit_sync.py"])
    assert len(findings) == 1
    log = sarif.to_sarif(findings, RULE_INFO)
    (result,) = log["runs"][0]["results"]
    assert result["ruleId"] == "GL019"
    loc = result["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("gl019_implicit_sync.py")
    assert loc["region"]["startLine"] == findings[0].line
    assert "fix-it:" in result["message"]["text"]


# --------------------------------------------- callgraph extensions
def test_callgraph_resolves_self_attribute_aliases(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "class Saver:\n"
        "    def save(self):\n"
        "        return 1\n"
        "class Owner:\n"
        "    def __init__(self):\n"
        "        self._mgr = Saver()\n"
        "    def run(self):\n"
        "        return self._mgr.save()\n",
    )
    run, save = _key(ctx, "Owner.run"), _key(ctx, "Saver.save")
    assert save in ctx.graph.functions[run].calls
    assert run in ctx.graph.callers()[save]


def test_callgraph_resolves_annotated_parameters(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "class Manager:\n"
        "    def save(self):\n"
        "        return 1\n"
        "def drive(manager: Manager):\n"
        "    return manager.save()\n",
    )
    assert _key(ctx, "Manager.save") in ctx.graph.functions[_key(ctx, "drive")].calls


def test_callgraph_conflicting_alias_pins_drop(tmp_path):
    ctx = _ctx_for(
        tmp_path,
        "class A:\n"
        "    def go(self):\n"
        "        return 1\n"
        "class B:\n"
        "    def go(self):\n"
        "        return 2\n"
        "class Owner:\n"
        "    def __init__(self, flag):\n"
        "        self._x = A()\n"
        "        if flag:\n"
        "            self._x = B()\n"
        "    def run(self):\n"
        "        return self._x.go()\n",
    )
    calls = ctx.graph.functions[_key(ctx, "Owner.run")].calls
    assert _key(ctx, "A.go") not in calls
    assert _key(ctx, "B.go") not in calls


def test_hot_seeds_are_the_jax_packages():
    from magicsoup_tpu_torch.analysis.callgraph import HOT_SEEDS

    assert HOT_SEEDS["stepper.py"] == ("PipelinedStepper.step", "PipelinedStepper.drain")
    assert "World.enzymatic_activity" in HOT_SEEDS["world.py"]
    assert len(HOT_SEEDS["world.py"]) == 13
