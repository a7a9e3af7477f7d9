"""
The port's measurement drivers (``magicsoup_tpu_torch/performance/``:
``bench``, ``run_simulation``, ``check``, ``profile_step``,
``megastep_sweep``, ``fleet_sweep``, ``mesh_sweep``) against the JAX
scripts they port (``bench.py``, ``performance/*.py``), on the CPU:

- ``bench``: ``baseline_s_per_step``, ``CONFIGS``, the fallbacks, the
  config precedence and the metric names equal ``bench.py``'s (its
  failure line gives its metric name), over the four presets and the
  ``--det`` / ``--pallas`` suffixes; a tiny run prints the classic line
  then the headline line, with ``bench.py``'s keys plus ``"device"``;
  without a card it prints the ``"error"`` line and exits 1;
- ``run_simulation`` in det mode at 30 cells on 16², 6 steps: the same
  final cell count and the same ``Cells/total`` and ``Molecules/*``
  series as the JAX ``run_simulation.main`` (whose run directory goes to
  a temporary one);
- ``check``, ``profile_step``, ``megastep_sweep`` and ``fleet_sweep``
  (with ``--mixed-rungs``): at a tiny size, rows with the JAX script's
  keys (read from its source) plus ``"device"``, and ``check``'s ops in
  its order, its ``result_row`` equal;
- ``mesh_sweep --check --devices 2 --device cpu`` exits 0.

The JAX scripts are loaded with ``importlib`` under their own names, as
``tests/fast/test_bench_parsing.py`` loads them; nothing of them is edited.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import argparse  # noqa: E402
import ast  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu_torch.performance import bench  # noqa: E402
from magicsoup_tpu_torch.performance import check as pcheck  # noqa: E402
from magicsoup_tpu_torch.performance import fleet_sweep  # noqa: E402
from magicsoup_tpu_torch.performance import megastep_sweep  # noqa: E402
from magicsoup_tpu_torch.performance import mesh_sweep  # noqa: E402
from magicsoup_tpu_torch.performance import profile_step  # noqa: E402
from magicsoup_tpu_torch.performance import run_simulation  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


jbench = _load("_jax_bench_script", "bench.py")
jcheck = _load("_jax_check_script", "performance/check.py")


def _function(rel: str, name: str) -> ast.FunctionDef:
    tree = ast.parse((ROOT / rel).read_text())
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _row_keys(rel: str, func: str = "main") -> list[set]:
    """The string keys of each dict literal with a ``"metric"`` or
    ``"device"`` key in ``func`` of a JAX script: its output rows (its
    accelerator-lock error line left out: the port has no such lock)."""
    rows = []
    for node in ast.walk(_function(rel, func)):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if keys & {"metric", "device"} and "error" not in keys:
                rows.append(keys)
    return rows


def _constants(rel: str, func: str) -> set:
    return {n.value for n in ast.walk(_function(rel, func)) if isinstance(n, ast.Constant)}


def _json_rows(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# ------------------------------------------------------------------ bench


@pytest.mark.parametrize("n_cells", [1_000, 2_500, 10_000, 40_000, 123_456])
def test_baseline_equals_bench_py(n_cells):
    assert bench.baseline_s_per_step(n_cells) == jbench.baseline_s_per_step(n_cells)
    assert bench.BASELINE_S_PER_STEP == jbench.BASELINE_S_PER_STEP


def test_presets_equal_bench_py():
    assert bench.CONFIGS == jbench.CONFIGS
    assert bench.ARG_FALLBACKS == jbench._ARG_FALLBACKS
    assert bench.CHEMISTRIES == jbench._CHEMISTRIES


PRESETS = [None, "headline", "40k", "diffusion", "rich"]
EXPLICIT = [[], ["--n-cells", "80"], ["--map-size", "64", "--chemistry", "wood_ljungdahl"],
            ["--n-cells", "10000", "--chemistry", "co2_fixing"]]


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("explicit", EXPLICIT, ids=["none", "cells", "map+chem", "cells+chem"])
def test_config_precedence_equals_bench_py(preset, explicit):
    argv = (["--config", preset] if preset else []) + explicit
    mine = bench.build_parser().parse_args(argv)
    bench.apply_config(mine)
    ref = jbench._build_parser().parse_args(argv)
    jbench._apply_config(ref)
    for key in ("n_cells", "map_size", "chemistry", "genome_size", "warmup", "steps", "seed",
                "lag", "megastep"):
        assert getattr(mine, key) == getattr(ref, key), key


def _jax_fail_line(argv, monkeypatch, capsys) -> dict:
    """``bench.py``'s structured failure line for ``argv`` (its
    accelerator lock made to fail, so nothing is measured)."""
    def no_lock(*args, **kwargs):
        raise TimeoutError("held")

    monkeypatch.setattr(jbench, "_acquire_accel_lock", no_lock)
    monkeypatch.setattr(signal, "signal", lambda *args: None)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with pytest.raises(SystemExit) as exc:
        jbench.main()
    assert exc.value.code == 1
    (line,) = _json_rows(capsys.readouterr().out)
    return line


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("mode", [[], ["--det"], ["--pallas"]], ids=["fast", "det", "pallas"])
def test_metric_names_equal_bench_py(preset, mode, monkeypatch, capsys):
    argv = (["--config", preset] if preset else []) + mode
    ref = _jax_fail_line(argv, monkeypatch, capsys)
    args = bench.build_parser().parse_args(argv)
    bench.apply_config(args)
    assert bench.metric_name(args) == ref["metric"]
    mine = json.loads(bench.fail_line(args, "boom"))
    assert set(mine) == set(ref)
    assert (mine["value"], mine["unit"], mine["vs_baseline"]) == (ref["value"], ref["unit"],
                                                                   ref["vs_baseline"])


def _bench_keys() -> tuple[set, set]:
    """bench.py's classic and headline keys: its ``emit`` base, the
    pipelined fields, and ``driver``."""
    dicts = [{k.value for k in node.keys if isinstance(k, ast.Constant)}
             for node in ast.walk(_function("bench.py", "_child_main"))
             if isinstance(node, ast.Dict)]
    base = next(k for k in dicts if "metric" in k)
    fields = next(k for k in dicts if "classic_steps_per_s" in k)
    assert "driver" in _constants("bench.py", "_child_main")
    return base | {"driver"}, base | fields | {"driver"}


def test_bench_cpu_run_prints_classic_then_headline(capsys):
    argv = ["--device", "cpu", "--n-cells", "40", "--map-size", "16", "--warmup", "1",
            "--steps", "2"]
    assert bench.main(argv) == 0
    captured = capsys.readouterr()
    classic, head = _json_rows(captured.out)
    classic_keys, head_keys = _bench_keys()
    assert set(classic) == classic_keys | {"device"}
    assert set(head) == head_keys | {"device"}
    assert classic["metric"] == head["metric"] + " [classic]"
    assert classic["driver"] == "classic" and classic["device"] == head["device"] == "cpu"
    assert head["value"] == max(head["classic_steps_per_s"], head["pipelined_steps_per_s"])
    assert head["driver"] == ("pipelined" if head["pipelined_steps_per_s"]
                              >= head["classic_steps_per_s"] else "classic")
    assert head["vs_baseline"] == round(head["value"] * bench.baseline_s_per_step(40), 4)
    assert head["megastep"] == 1 and head["pipeline_stats"]["steps"] > 0
    assert "[trace] steps=" in captured.err


def test_bench_without_card_prints_the_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--n-cells", "40", "--map-size", "16"]) == 1
    (line,) = _json_rows(capsys.readouterr().out)
    assert line["value"] == 0.0 and "no CUDA device" in line["error"]
    assert line["metric"] == "sim steps/sec (40 cells, 16x16 map, wood-ljungdahl run_simulation workload)"


@pytest.mark.parametrize("module", [bench, pcheck, profile_step, megastep_sweep, fleet_sweep,
                                    mesh_sweep, run_simulation])
def test_no_driver_falls_back_to_the_cpu(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if module is bench:
        assert module.main([]) == 1
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main([])


# --------------------------------------------------------- run_simulation


class _Scalars:
    """A stand-in for the run scripts' TensorBoard writer: keeps the
    scalars in memory."""

    written: list = []

    def __init__(self, logdir):
        Path(logdir).mkdir(parents=True, exist_ok=True)
        self.rows = []
        type(self).written.append(self.rows)

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def close(self):
        pass


def _series(rows, prefix: str) -> dict:
    return {(tag, step): value for tag, value, step in rows if tag.startswith(prefix)}


def test_run_simulation_equals_the_jax_harness(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MAGICSOUP_TPU_DETERMINISTIC", "1")
    monkeypatch.syspath_prepend(str(ROOT / "performance"))
    jrs = _load("_jax_run_simulation_script", "performance/run_simulation.py")
    monkeypatch.setattr(jrs, "_THIS_DIR", tmp_path / "jax")
    monkeypatch.setattr(jrs, "_Writer", _Scalars)
    monkeypatch.setattr(run_simulation, "_Writer", _Scalars)
    _Scalars.written = []
    size = dict(map_size=16, n_cells=30, n_steps=6, init_genome_size=500, init_molmap="randn",
                log_every=5, seed=42)
    jrs.main(argparse.Namespace(pipelined=False, **size))
    ref_out = capsys.readouterr().out
    assert run_simulation.main(["--device", "cpu", "--map-size", "16", "--n-cells", "30",
                                "--n-steps", "6", "--logdir", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    ref_rows, rows = _Scalars.written
    final = [line for line in out.splitlines() if "final n_cells=" in line]
    assert final == [line for line in ref_out.splitlines() if "final n_cells=" in line]
    assert _series(rows, "Cells/total") == _series(ref_rows, "Cells/total")
    assert len(_series(rows, "Cells/total")) == 6
    assert _series(rows, "Molecules/") == _series(ref_rows, "Molecules/")
    assert {t for t, _, _ in rows if t.startswith("Time[s]/")} == {
        t for t, _, _ in ref_rows if t.startswith("Time[s]/")}
    # the state at step 0 and one final verified checkpoint
    assert (tmp_path / "port" / "step=0" / "cell_molecules.npy").exists()
    assert len(list((tmp_path / "port" / "checkpoints").glob("*.msck"))) == 1


# ------------------------------------------------------------ the sweeps


def test_check_rows_equal_the_jax_scripts(capsys):
    assert pcheck.result_row("spawn_cells", [0.5, 0.25], 100, 200, "cpu") == jcheck.result_row(
        "spawn_cells", [0.5, 0.25], 100, 200, "cpu")
    assert pcheck.main(["--device", "cpu", "--n", "24", "--s", "120", "--r", "1", "--json"]) == 0
    rows = _json_rows(capsys.readouterr().out)
    jax_ops = [c.args[0].value for c in ast.walk(_function("performance/check.py", "main"))
               if isinstance(c, ast.Call) and getattr(c.func, "id", None) == "emit"]
    assert [r["op"] for r in rows] == jax_ops == list(pcheck.OPS)
    ref = set(jcheck.result_row("x", [1.0], 1, 1, "cpu"))
    for row in rows:
        assert set(row) == ref | {"device"}
        assert row["backend"] == "cpu" and row["unit"] == "s" and row["repeats"] == 1


def test_profile_step_rows_equal_the_jax_scripts(tmp_path, capsys):
    argv = ["--device", "cpu", "--n-cells", "24", "--map-size", "16", "--warmup", "1",
            "--steps", "2", "--telemetry", str(tmp_path / "t.jsonl")]
    assert profile_step.main(argv) == 0
    out = capsys.readouterr().out
    (row,) = _json_rows(out)
    (keys,) = _row_keys("performance/profile_step.py")
    assert set(row) == keys and row["device"] == "cpu"
    phases = [line.split()[0] for line in out.splitlines()[1:]]
    assert {"activity", "kill", "replicate", "recombinateGenomes", "mutateGenomes",
            "wrapUp"} <= set(phases)
    dispatch = [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert sum(r.get("type") == "dispatch" for r in dispatch) == 2


def test_megastep_sweep_rows_equal_the_jax_scripts(capsys):
    argv = ["--device", "cpu", "--ks", "1,2", "--n-cells", "24", "--map-size", "16",
            "--genome-size", "200", "--steps", "2", "--warmup", "1"]
    assert megastep_sweep.main(argv) == 0
    rows = _json_rows(capsys.readouterr().out)
    (keys,) = _row_keys("performance/megastep_sweep.py")
    assert [r["megastep"] for r in rows] == [1, 2]
    for row in rows:
        assert set(row) == keys | {"device"} and row["backend"] == "cpu"


@pytest.mark.parametrize("mixed", [False, True], ids=["fleet", "mixed-rungs"])
def test_fleet_sweep_rows_equal_the_jax_scripts(mixed, capsys):
    argv = ["--device", "cpu", "--n-cells", "16", "--map-size", "16", "--genome-size", "150",
            "--steps", "2", "--warmup", "1"]
    argv += ["--mixed-rungs", "--rungs", "2", "--bs", "2", "--ks", "1"] if mixed else [
        "--bs", "1,2", "--ks", "1,2"]
    assert fleet_sweep.main(argv) == 0
    rows = _json_rows(capsys.readouterr().out)
    per_rung, plain = sorted(_row_keys("performance/fleet_sweep.py"), key=lambda k: "rungs" in k,
                             reverse=True)
    if mixed:
        assert [r["fused"] for r in rows] == [False, True]
        assert "speedup" in _constants("performance/fleet_sweep.py", "main")
        assert set(rows[0]) == per_rung | {"device"}
        assert set(rows[1]) == per_rung | {"speedup", "device"}
        # speedup comes from the unrounded rates, the values are rounded to
        # 4 places: the ratio of the printed values is within their rounding
        fused, rung = rows[1]["value"], rows[0]["value"]
        slack = 5e-5 * (1 / rung + fused / rung**2) + 5e-5
        assert abs(rows[1]["speedup"] - fused / rung) <= slack
    else:
        assert [(r["megastep"], r["fleet_size"]) for r in rows] == [(1, 1), (1, 2), (2, 1),
                                                                     (2, 2)]
        for row in rows:
            assert set(row) == plain | {"device"} and row["groups"] == 1


def test_mesh_sweep_check_passes_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--check", "--devices", "2", "--n-cells", "24", "--map-size",
            "16", "--genome-size", "200", "--steps", "3"]
    assert mesh_sweep.main(argv) == 0
    (row,) = _json_rows(capsys.readouterr().out)
    (keys,) = _row_keys("performance/mesh_sweep.py", "_bit_identity_check")
    assert set(row) == keys | {"cards", "device"}
    assert row["ok"] is True and row["n_devices"] == 2 and row["cards"] == 0
