"""
The port's graftlint (:mod:`magicsoup_tpu_torch.analysis`), the
counterpart of tests/fast/test_graftlint.py's static half:

- every kept rule has a one-violation torch fixture under
  ``tests/torch_data/graftlint/`` that must be detected at the marked
  line; ``clean.py`` and ``suppressed.py`` give nothing;
- waivers silence each rule; the scoped rules go silent outside their
  scope; the sanctioned forms (planner loop, routed clock, registry call)
  lint clean;
- the rules whose detection does not depend on the array library give
  the JAX analyzer's ``(rule, line)`` set on the JAX fixtures;
- the port's tree lints clean with the empty baseline, a ``.item()``
  injected into a copy of the port's stepper is caught, and the CLI keeps
  the ``graftlint/1`` report, SARIF 2.1.0 and the kept rule table.

Everything here is stdlib AST analysis: no torch tensor, no device.  The
runtime half is tests/test_torch_hot_path_guard.py.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

from magicsoup_tpu.analysis import analyze as janalyze  # noqa: E402
from magicsoup_tpu_torch.analysis import analyze  # noqa: E402
from magicsoup_tpu_torch.analysis import cli  # noqa: E402
from magicsoup_tpu_torch.analysis import engine as lint_engine  # noqa: E402
from magicsoup_tpu_torch.analysis.rules import RULE_INFO  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_data" / "graftlint"
JAX_FIXTURES = ROOT / "tests" / "fast" / "data" / "graftlint"
PKG = Path(lint_engine.default_target())
KEPT = [
    "GL001", "GL003", "GL004", "GL005", "GL007", "GL009", "GL010", "GL012",
    "GL013", "GL014", "GL015", "GL016", "GL017", "GL018", "GL019", "GL020",
    "GL021", "GL022", "GL023", "GL024", "GL025", "GL026",
]
DROPPED = ["GL002", "GL006", "GL008", "GL011"]
#: rules whose detection does not depend on the array library
NEUTRAL = [
    "GL004", "GL010", "GL013", "GL014", "GL015", "GL016", "GL017", "GL018",
    "GL021", "GL022", "GL025",
]


def marked_lines(path: Path, code: str) -> list[int]:
    """1-based lines of the fixture's `# GLxxx:` violation markers."""
    return [
        i
        for i, line in enumerate(path.read_text().splitlines(), start=1)
        if f"# {code}:" in line
    ]


def _variant(tmp_path, fixture: str, old: str, new: str, name: str) -> Path:
    src = (FIXTURES / fixture).read_text()
    changed = src.replace(old, new)
    assert changed != src, (fixture, old)
    p = tmp_path / name
    p.write_text(changed)
    return p


# ------------------------------------------------------------- static
@pytest.mark.parametrize(
    "fixture, code",
    [
        ("gl001_hot.py", "GL001"),
        ("gl001_forms.py", "GL001"),
        ("gl003_dtype.py", "GL003"),
        ("gl004_nondet.py", "GL004"),
        ("gl005_transfer.py", "GL005"),
        ("gl007_tolist_loop.py", "GL007"),
        ("gl009_unplaced.py", "GL009"),
        ("gl010_unsafe_save.py", "GL010"),
        ("gl012_shared_key.py", "GL012"),
        ("gl013_swallowed_guard.py", "GL013"),
        ("gl014_blocking_serve.py", "GL014"),
        ("gl015_cross_thread.py", "GL015"),
        ("gl016_lock_order.py", "GL016"),
        ("gl017_queue_bypass.py", "GL017"),
        ("gl018_raw_io.py", "GL018"),
        ("gl019_implicit_sync.py", "GL019"),
        ("gl020_fetch_bypass.py", "GL020"),
        ("gl021_unprobed_boundary.py", "GL021"),
        ("gl022_untyped_escape.py", "GL022"),
        ("gl023_host_genome.py", "GL023"),
        ("gl024_group_loop.py", "GL024"),
        ("gl025_bare_clock.py", "GL025"),
        ("gl026_backend_bypass.py", "GL026"),
    ],
)
def test_rule_detects_fixture_violation(fixture, code):
    path = FIXTURES / fixture
    findings = analyze([path])
    want = marked_lines(path, code)
    assert want
    assert [f.rule for f in findings] == [code] * len(want)
    assert [f.line for f in findings] == want
    for f in findings:
        assert f.name == RULE_INFO[code][0]
        assert f.fixit  # every finding carries an actionable fix-it
        assert f"{f.path}:{f.line}" in f.format()


def test_every_kept_rule_has_a_fixture():
    covered = {p.name[:5].upper() for p in FIXTURES.glob("gl*.py")}
    assert sorted(covered) == KEPT == sorted(RULE_INFO)


def test_suppression_comment_silences_finding():
    # same violation as gl004_nondet.py, annotated inline -> no findings
    assert analyze([FIXTURES / "suppressed.py"]) == []


def test_clean_fixture_has_no_findings():
    # host metadata (shape, device, numel, stride, is_contiguous, len) in
    # a hot function and a placed factory are not syncs
    assert analyze([FIXTURES / "clean.py"]) == []


@pytest.mark.parametrize(
    "fixture, marker",
    [
        ("gl007_tolist_loop.py", "# GL007: per-item conversion"),
        ("gl009_unplaced.py", "# GL009: lands on the CPU"),
        ("gl010_unsafe_save.py", "# GL010: non-atomic state persistence"),
        ("gl012_shared_key.py", "# GL012: shared across worlds"),
        ("gl013_swallowed_guard.py", "# GL013: swallows the typed guard errors"),
        ("gl014_blocking_serve.py", "# GL014: unbounded wait wedges the loop"),
        ("gl015_cross_thread.py", "# GL015: races record()"),
        ("gl016_lock_order.py", "# GL016: inverts credit()'s order"),
        ("gl017_queue_bypass.py", "# GL017: bypasses the queue"),
        ("gl018_raw_io.py", "# GL018: raw write bypasses guard.io"),
        ("gl023_host_genome.py", "# GL023: host genome list load in hot path"),
        ("gl024_group_loop.py", "# GL024: one launch + fetch per rung group"),
        ("gl025_bare_clock.py", "# GL025: clock reading hoarded in local state"),
        ("gl026_backend_bypass.py", "# GL026: direct kernel call in hot path"),
    ],
)
def test_rule_waivable_like_the_other_rules(tmp_path, fixture, marker):
    code = marker.split()[1].rstrip(":")
    p = _variant(tmp_path, fixture, marker, f"# graftlint: disable={code} fixture",
                 f"{code.lower()}_waived.py")
    assert analyze([p]) == []


@pytest.mark.parametrize(
    "fixture, code, scope_line, replacement",
    [
        ("gl009_unplaced.py", "GL009",
         "import torch  # noqa: F401  (marks the module device-placed)",
         "torch = None"),
        ("gl012_shared_key.py", "GL012",
         "from magicsoup_tpu_torch import fleet  # noqa: F401  (marks the module fleet-scoped)",
         ""),
        ("gl013_swallowed_guard.py", "GL013",
         "from magicsoup_tpu_torch.guard.errors import CheckpointError"
         "  # noqa: F401  (marks the module guard-scoped)",
         "CheckpointError = RuntimeError"),
        ("gl014_blocking_serve.py", "GL014",
         "from magicsoup_tpu_torch import serve  # noqa: F401  (marks the module serve-scoped)",
         ""),
        ("gl017_queue_bypass.py", "GL017",
         "from magicsoup_tpu_torch import serve  # noqa: F401  (marks the module serve-scoped)",
         ""),
        ("gl018_raw_io.py", "GL018",
         "from magicsoup_tpu_torch.guard.io import atomic_write_bytes"
         "  # noqa: F401  (marks the module guard-scoped)",
         "def atomic_write_bytes(path, data):\n    pass"),
        ("gl023_host_genome.py", "GL023",
         "from magicsoup_tpu_torch import stepper  # noqa: F401  (marks the module stepper-scoped)",
         ""),
        ("gl024_group_loop.py", "GL024",
         "from magicsoup_tpu_torch.fleet import batch  # noqa: F401  (marks the module fleet-scoped)",
         ""),
        ("gl025_bare_clock.py", "GL025",
         "from magicsoup_tpu_torch import stepper  # noqa: F401  (marks the module stepper-scoped)",
         ""),
        ("gl026_backend_bypass.py", "GL026",
         "from magicsoup_tpu_torch import stepper  # noqa: F401  (marks the module stepper-scoped)",
         ""),
    ],
)
def test_rule_scoped(tmp_path, fixture, code, scope_line, replacement):
    # the SAME violation is silent once the module leaves the rule's scope
    p = _variant(tmp_path, fixture, scope_line, replacement, f"{code.lower()}_unscoped.py")
    assert analyze([p], rules=[code]) == []


def test_gl001_host_metadata_and_narrowed_scalars_are_not_syncs(tmp_path):
    # the false-positive shapes of ops/cuda_integrate.py::_check: torch's
    # host metadata of an annotated tensor, and the scalar branch of an
    # isinstance-guarded tensor-or-scalar helper
    p = tmp_path / "meta.py"
    p.write_text(
        "import torch\n"
        "# graftlint: hot\n"
        "def check(X: torch.Tensor, params, v):\n"
        "    for name, t in params._asdict().items():\n"
        "        if t.device != X.device or t.dtype != X.dtype:\n"
        "            raise ValueError(f'{name} is on {t.device}, X on {X.device}')\n"
        "        if not t[0].is_contiguous() or t.stride(0) % t[0, 0].numel():\n"
        "            raise ValueError(f'{name} must hold whole rows')\n"
        "    if X.is_cuda and X.dim() == 3 and X.data_ptr():\n"
        "        pass\n"
        "    return v.clamp(0, 1) if isinstance(v, torch.Tensor) else min(max(int(v), 0), 1)\n"
    )
    assert analyze([p]) == []


def test_gl001_factory_places_follow_device(tmp_path):
    # a factory without device= is a CPU tensor (no CUDA sync), a pinned
    # staging buffer is host, as_tensor keeps its argument's place
    p = tmp_path / "places.py"
    p.write_text(
        "import torch\n"
        "# graftlint: hot\n"
        "def stage(x: torch.Tensor, rows: list):\n"
        "    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)\n"
        "    host.copy_(x, non_blocking=True)\n"
        "    a = host.numpy()\n"
        "    b = torch.as_tensor(rows, device='cpu').tolist()\n"
        "    c = torch.as_tensor(x).tolist()  # GL001: keeps x's device\n"
        "    return a, b, c\n"
    )
    findings = analyze([p], rules=["GL001"])
    assert [(f.rule, f.line) for f in findings] == [("GL001", 8)]


def test_gl024_planner_routed_loop_is_sanctioned(tmp_path):
    # the scheduler's own dispatch loop iterates the fusion PLANNER's
    # partition — that is the sanctioned route, not a violation
    p = tmp_path / "gl024_planner.py"
    p.write_text(
        "from magicsoup_tpu_torch.fleet import batch  # noqa: F401\n"
        "\n"
        "\n"
        "def step(self, groups, inputs):\n"
        "    for group_set in self._plan_fusion(groups):\n"
        "        batch.fused_step_program(group_set, inputs)\n"
    )
    assert analyze([p], rules=["GL024"]) == []


def test_gl025_routing_call_exempts_function(tmp_path):
    p = _variant(tmp_path, "gl025_bare_clock.py", "    return out",
                 "    rec.note('step', world.last_step_s)\n    return out", "gl025_routed.py")
    assert analyze([p], rules=["GL025"]) == []


def test_gl026_registry_routed_call_is_sanctioned(tmp_path):
    # the fix the rule asks for (the registry, which itself names the
    # kernels) lints clean, grouped entry included
    src = (FIXTURES / "gl026_backend_bypass.py").read_text()
    routed = src.replace(
        "from magicsoup_tpu_torch.ops.cuda_integrate import integrate_signals_cuda",
        "from magicsoup_tpu_torch.ops import backends as _backends",
    ).replace(
        "    X1 = integrate_signals_cuda(X, params)  # GL026: direct kernel call in hot path",
        '    X1 = _backends.integrate("cuda", X, params)\n'
        '    _backends.integrate_grouped(["cuda"], [X], [params])',
    )
    assert routed != src
    p = tmp_path / "gl026_routed.py"
    p.write_text(routed)
    assert analyze([p], rules=["GL026"]) == []


def test_gl013_reraise_and_specific_catch_pass(tmp_path):
    p = tmp_path / "gl013_forms.py"
    p.write_text(
        "from magicsoup_tpu_torch import guard  # noqa: F401\n"
        "def bad(fn):\n"
        "    try:\n"
        "        return fn()\n"
        "    except:  # noqa: E722\n"
        "        return None\n"
        "def good(fn, log):\n"
        "    try:\n"
        "        return fn()\n"
        "    except BaseException:\n"
        "        log()\n"
        "        raise\n"
    )
    findings = analyze([p], rules=["GL013"])
    assert [(f.rule, f.line) for f in findings] == [("GL013", 5)]


def test_gl014_sleep_and_bare_result_forms(tmp_path):
    p = tmp_path / "gl014_forms.py"
    p.write_text(
        "import time\n"
        "from magicsoup_tpu_torch import serve  # noqa: F401\n"
        "def loop_sleep(stop):\n"
        "    while not stop.is_set():\n"
        "        time.sleep(0.1)\n"
        "def loop_result(stop, futures):\n"
        "    while futures:\n"
        "        futures.pop().result()\n"
        "def loop_bounded(stop, futures):\n"
        "    while futures:\n"
        "        futures.pop().result(timeout=30.0)\n"
        "def one_shot(fut):\n"
        "    return fut.result()\n"
    )
    findings = analyze([p], rules=["GL014"])
    assert [(f.rule, f.line) for f in findings] == [("GL014", 5), ("GL014", 8)]


def test_gl018_replace_and_mode_forms(tmp_path):
    p = tmp_path / "gl018_forms.py"
    p.write_text(
        "import os\n"
        "from magicsoup_tpu_torch import guard  # noqa: F401\n"
        "def hand_rolled(tmp, dst, data):\n"
        "    with open(tmp, 'xb') as fh:\n"
        "        fh.write(data)\n"
        "    os.replace(tmp, dst)\n"
        "def in_place(path):\n"
        "    with open(path, 'r+b') as fh:\n"
        "        fh.write(b'x')\n"
        "def read_only(path):\n"
        "    with open(path, 'rb') as fh:\n"
        "        return fh.read()\n"
        "def append(path):\n"
        "    with open(path, mode='a') as fh:\n"
        "        fh.write('row')\n"
    )
    findings = analyze([p], rules=["GL018"])
    assert [(f.rule, f.line) for f in findings] == [("GL018", 4), ("GL018", 6), ("GL018", 8)]


def test_gl015_locked_and_single_threaded_stay_clean(tmp_path):
    src = (FIXTURES / "gl015_cross_thread.py").read_text()
    p = tmp_path / "gl015_negatives.py"
    p.write_text("import threading\n" + src[src.index("class LockedSampler"):])
    assert analyze([p], rules=["GL015"]) == []


def test_gl003_double_and_string_forms(tmp_path):
    p = tmp_path / "gl003_forms.py"
    p.write_text(
        "import numpy as np\n"
        "import torch\n"
        "def widen(x, y):\n"
        "    a = x.double()\n"
        "    b = np.zeros(3, dtype='float64')\n"
        "    c = np.float64(1.0)\n"
        "    d = torch.zeros(3, dtype=torch.float32)\n"
        "    return a, b, c, d\n"
    )
    findings = analyze([p], rules=["GL003"])
    assert [(f.rule, f.line) for f in findings] == [("GL003", 4), ("GL003", 5), ("GL003", 6)]
    det = tmp_path / "detmath.py"
    det.write_text(p.read_text())
    assert analyze([det], rules=["GL003"]) == []


def test_gl004_torch_global_generator(tmp_path):
    p = tmp_path / "gl004_torch.py"
    p.write_text(
        "import torch\n"
        "def draw(n, gen):\n"
        "    a = torch.rand(n)\n"
        "    b = torch.randint(0, 4, (n,), generator=gen)\n"
        "    torch.manual_seed(0)\n"
        "    return a, b\n"
    )
    findings = analyze([p], rules=["GL004"])
    assert [(f.rule, f.line) for f in findings] == [("GL004", 3), ("GL004", 5)]


def test_waiver_on_def_line_covers_decorator_line_findings(tmp_path):
    # findings on decorated defs anchor to the DECORATOR line; a waiver on
    # the def line covers the whole header
    p = tmp_path / "decorated_waiver.py"
    p.write_text(
        "import functools\n"
        "import time\n"
        "\n"
        "@functools.lru_cache(maxsize=None)\n"
        "def stamp():  # graftlint: disable=GL004 fixture\n"
        "    return time.time()\n"
    )
    src = lint_engine.SourceFile(p, "decorated_waiver.py")
    assert src.suppressed(4, "GL004")  # decorator line
    assert src.suppressed(5, "GL004")  # def line
    assert not src.suppressed(6, "GL004")


def test_owner_declaration_shared_across_decorated_header(tmp_path):
    p = tmp_path / "decorated_owner.py"
    p.write_text(
        "def deco(fn):\n"
        "    return fn\n"
        "\n"
        "@deco\n"
        "def run():  # graftlint: owner=sampler-loop\n"
        "    pass\n"
    )
    src = lint_engine.SourceFile(p, "decorated_owner.py")
    assert src.owners.get(4) == "sampler-loop"
    assert src.owners.get(5) == "sampler-loop"


def test_gl010_write_form_detected(tmp_path):
    p = tmp_path / "gl010_write_form.py"
    p.write_text(
        "import pickle\n"
        "def save(obj, path, atomic_write_bytes):\n"
        "    with open(path, 'wb') as fh:\n"
        "        fh.write(pickle.dumps(obj))\n"
        "    atomic_write_bytes(path, pickle.dumps(obj))\n"
    )
    findings = analyze([p], rules=["GL010"])
    assert [(f.rule, f.line) for f in findings] == [("GL010", 4)]


def test_rules_filter_restricts_rule_set():
    findings = analyze([FIXTURES], rules=["GL004"])
    assert findings and all(f.rule == "GL004" for f in findings)
    assert all("suppressed" not in f.path for f in findings)


# ------------------------------------- library-neutral rules vs JAX's
@pytest.fixture(scope="module")
def neutral_runs():
    """Both analyzers over the JAX fixtures, restricted to the rules
    whose detection does not depend on the array library."""
    port = analyze([JAX_FIXTURES], rules=NEUTRAL)
    ref = janalyze([JAX_FIXTURES], rules=NEUTRAL)
    return port, ref


@pytest.mark.parametrize("code", NEUTRAL)
def test_neutral_rule_matches_the_jax_analyzer(neutral_runs, code):
    port, ref = neutral_runs
    got = {(f.path, f.line) for f in port if f.rule == code}
    want = {(f.path, f.line) for f in ref if f.rule == code}
    assert want, code  # the JAX fixture fires this rule
    assert got == want


# --------------------------------------------------------- the tree
@pytest.fixture(scope="module")
def tree_run():
    """ONE timed whole-tree analysis shared by the clean-tree gate and
    the wall-budget test."""
    import time

    timings: dict = {}
    t0 = time.monotonic()
    ctx = lint_engine.build_context([PKG], timings=timings)
    findings = lint_engine.analyze([PKG], ctx=ctx, timings=timings)
    return ctx, findings, timings, time.monotonic() - t0


def test_library_tree_lints_clean(tree_run):
    # THE gate: the shipped baseline is empty, so any finding in the port
    # is a regression (or needs an inline waiver that gives its reason)
    _, findings, _, _ = tree_run
    assert findings == [], "\n".join(f.format() for f in findings)


def test_full_tree_analysis_under_wall_budget(tree_run):
    from magicsoup_tpu_torch.analysis.dataflow import _FIXPOINT_CAP

    ctx, _, timings, elapsed = tree_run
    assert elapsed < 30.0, f"graftlint tree run took {elapsed:.1f}s"
    assert set(timings) == {"parse", "callgraph", "threadmodel", "dataflow", "rules"}
    assert all(v >= 0.0 for v in timings.values())
    assert 1 <= ctx.dataflow.iterations < _FIXPOINT_CAP


def test_hot_marks_cover_the_jax_trees_counterparts(tree_run):
    # the JAX tree's `# graftlint: hot` functions are marked in the port
    ctx, _, _, _ = tree_run
    marked = {rec.qualname for rec in ctx.graph.functions.values() if rec.hot_marked}
    assert {
        "World._update_cell_params", "World._update_cell_params_tokens",
        "World._update_cell_params_rows", "World._apply_phenotype_entries",
        "PhenotypeCache.lookup", "PhenotypeCache.lookup_tokens",
        "PhenotypeCache.dense_rows", "Kinetics.set_cell_params_flat",
        "Kinetics.set_cell_params_cached", "Kinetics.scatter_dense",
        "FleetScheduler._dispatch_group", "FleetScheduler._dispatch_fused",
    } <= marked


def test_baseline_tolerates_counted_findings():
    findings = analyze([FIXTURES / "gl004_nondet.py"])
    assert len(findings) == 1
    key = findings[0].key
    assert lint_engine.apply_baseline(findings, {key: 1}) == []
    assert lint_engine.apply_baseline(findings, {key: 0}) == findings
    assert lint_engine.load_baseline() == {}  # empty by policy


def test_item_injection_into_stepper_fails_lint(tmp_path):
    # a deliberate .item() in the step dispatch of a copy of the port's
    # stepper is flagged as GL001 (hot seeds are keyed by basename)
    src = (PKG / "stepper.py").read_text()
    marker = "    def step(self) -> None:"
    assert marker in src
    lines = src.splitlines(keepends=True)
    at = next(i for i, line in enumerate(lines) if line.startswith(marker))
    lines.insert(at + 1, "        _ = self._alive.sum().item()\n")
    bad = tmp_path / "stepper.py"
    bad.write_text("".join(lines))
    gl001 = [f for f in analyze([bad]) if f.rule == "GL001"]
    assert [(f.line, "item" in f.message) for f in gl001] == [(at + 2, True)]
    good = tmp_path / "control" / "stepper.py"
    good.parent.mkdir()
    good.write_text(src)
    assert analyze([good]) == []


def test_analysis_package_imports_neither_torch_nor_jax():
    import ast

    for path in sorted((PKG / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("torch", "jax", "magicsoup_tpu"), (path, n)


# ---------------------------------------------------------------- CLI
def _cli(*argv) -> tuple[int, str]:
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(ROOT)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
    finally:
        os.chdir(old)
    return rc, buf.getvalue()


def test_cli_check_flags_fixtures_with_code_and_location():
    rc, out = _cli("--check", str(FIXTURES))
    assert rc == 1
    for code in KEPT:
        assert code in out
    for fixture, code in [("gl001_hot.py", "GL001"), ("gl004_nondet.py", "GL004")]:
        (line,) = marked_lines(FIXTURES / fixture, code)
        assert f"{fixture}:{line}:" in out


def test_cli_check_exits_zero_on_the_port_tree():
    # the gate as a user runs it, in a fresh process
    res = subprocess.run(
        [sys.executable, "-m", "magicsoup_tpu_torch.analysis", "--check"],
        capture_output=True, text=True, cwd=ROOT,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 finding(s)" in res.stdout


def test_cli_json_output_is_machine_readable():
    rc, out = _cli("--json", str(FIXTURES / "gl003_dtype.py"))
    assert rc == 0
    report = json.loads(out)
    assert report["schema"] == "graftlint/1"
    assert sorted(report["counts"]) == KEPT  # zeros included
    assert report["counts"]["GL003"] == 1
    assert all(report["counts"][c] == 0 for c in KEPT if c != "GL003")
    assert (report["fresh"], report["baselined"], report["files"]) == (1, 0, 1)
    (row,) = report["findings"]
    assert row["rule"] == "GL003" and row["fixit"]
    assert row["line"] == marked_lines(FIXTURES / "gl003_dtype.py", "GL003")[0]


def test_cli_sarif_writes_a_valid_log(tmp_path):
    out = tmp_path / "out.sarif"
    rc, _ = _cli("--sarif", str(out), str(FIXTURES / "gl005_transfer.py"))
    assert rc == 0
    log = json.loads(out.read_text())
    assert log["version"] == "2.1.0" and "sarif-schema-2.1.0" in log["$schema"]
    driver = log["runs"][0]["tool"]["driver"]
    assert driver["name"] == "graftlint"
    assert sorted(r["id"] for r in driver["rules"]) == KEPT
    (result,) = log["runs"][0]["results"]
    assert result["ruleId"] == "GL005"
    assert result["locations"][0]["physicalLocation"]["region"]["startLine"] == 7


def test_cli_list_rules_lists_exactly_the_kept_rules():
    rc, out = _cli("--list-rules")
    assert rc == 0
    listed = [line.split()[0] for line in out.splitlines() if line.strip()]
    assert listed == list(RULE_INFO) and sorted(listed) == KEPT


@pytest.mark.parametrize("code", DROPPED + ["GL999"])
def test_cli_refuses_dropped_and_unknown_rules(code):
    with pytest.raises(SystemExit) as err:
        _cli("--rules", code, str(FIXTURES))
    assert err.value.code != 0 and code in str(err.value.code)


def test_readme_names_each_dropped_rule():
    text = (ROOT / "README.md").read_text()
    section = text[text.index("### The port's graftlint"):]
    for code in DROPPED:
        assert f"| {code} |" in section, code
