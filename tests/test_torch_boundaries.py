"""
The port's seams, checked on its source (stdlib AST, no torch tensor):

- host->device copies go through ``util.to_device``, the one seam
  (pinned, never blocking the host): no other module of
  ``magicsoup_tpu_torch/`` spells ``from_numpy(...).to(...)`` or
  ``.pin_memory().to(...)``, and no module calls or defines a second,
  blocking upload (``to_device_blocking``);
- each kernel's wrapper under ``ops/`` owns its launch plan and its
  counters: outside ``ops/`` and ``performance/`` (the microbenchmarks,
  which check their own launch counts) no module calls ``launch_plan``,
  ``route_bytes`` or ``smem_limit``, or reads a wrapper's module-level
  launch count.
"""
import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parents[1] / "magicsoup_tpu_torch"

#: the wrappers' module-level launch counts (``launches = 0`` in ops/cuda_*.py)
LAUNCH_COUNTS = frozenset(
    node.targets[0].id
    for path in sorted((PACKAGE / "ops").glob("cuda_*.py"))
    for node in ast.parse(path.read_text()).body
    if isinstance(node, ast.Assign)
    and len(node.targets) == 1
    and isinstance(node.targets[0], ast.Name)
    and node.targets[0].id.endswith("launches")
)


def _leaf(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _copy_to(node: ast.AST, inner: str) -> bool:
    """``<...>.<inner>(...).to(...)``: a ``.to`` call on the result of a
    call named ``inner``."""
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "to"
        and isinstance(node.func.value, ast.Call)
        and _leaf(node.func.value.func) == inner
    )


def _blocking_upload(node: ast.AST) -> bool:
    """A call, definition, import or attribute named ``to_device_blocking``."""
    if isinstance(node, ast.Call):
        return _leaf(node.func) == "to_device_blocking"
    if isinstance(node, ast.FunctionDef):
        return node.name == "to_device_blocking"
    if isinstance(node, ast.ImportFrom):
        return any(alias.name == "to_device_blocking" for alias in node.names)
    return isinstance(node, ast.Attribute) and node.attr == "to_device_blocking"


def _plan_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _leaf(node.func) in (
        "launch_plan", "route_bytes", "smem_limit"
    )


def _launch_count_read(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        return node.attr in LAUNCH_COUNTS
    if isinstance(node, ast.ImportFrom):
        return any(alias.name in LAUNCH_COUNTS for alias in node.names)
    return False


#: (what is found, the modules allowed to do it)
SEAMS = {
    "from_numpy-to": (lambda n: _copy_to(n, "from_numpy"), ("util.py",)),
    "pin_memory-to": (lambda n: _copy_to(n, "pin_memory"), ("util.py",)),
    "blocking-upload": (_blocking_upload, ()),
    "launch-plan": (_plan_call, ("ops/", "performance/")),
    "launch-count": (_launch_count_read, ("ops/", "performance/")),
}


@pytest.mark.parametrize("seam", sorted(SEAMS))
def test_only_the_seam_crosses_it(seam):
    found, allowed = SEAMS[seam]
    assert LAUNCH_COUNTS >= {"launches", "grouped_launches"}
    hits = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE).as_posix()
        if rel.startswith(allowed):
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        hits += [f"{rel}:{n.lineno}" for n in ast.walk(tree) if found(n)]
    assert hits == [], f"{seam} outside {allowed}: {hits}"
