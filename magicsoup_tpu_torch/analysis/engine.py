"""
graftlint rule engine: file parsing, suppression comments, the baseline,
and the analyze() entry point the CLI and tests share.  Counterpart of
:mod:`magicsoup_tpu.analysis.engine`, with the same comment grammar and
finding model.

Pure stdlib (ast + tokenize): the static half runs without importing
torch or the library under analysis.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path

# codes only — free-text rationale after the code list is encouraged
SUPPRESS_RE = re.compile(
    r"graftlint:\s*disable=((?:[A-Za-z]+\d*)(?:\s*,\s*[A-Za-z]+\d*)*)"
)
HOT_RE = re.compile(r"graftlint:\s*hot\b")
# thread-ownership declaration for the graftrace concurrency rules:
# `# graftlint: owner=scheduler-loop` on a `def` declares the function a
# role entry point; on an attribute assignment it declares the
# attribute's sanctioned single writer (see analysis/concurrency.py)
OWNER_RE = re.compile(r"graftlint:\s*owner=([A-Za-z0-9_\-]+)")


@dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str  # "GL001"
    name: str  # "host-sync-in-hot-path"
    message: str
    fixit: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"({self.name}) {self.message}\n    fix-it: {self.fixit}"
        )

    @property
    def key(self) -> str:
        """Baseline key: stable across line-number drift."""
        return f"{self.path}::{self.rule}"


class SourceFile:
    """One parsed module: AST + suppression/hot comment maps."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = path.read_text()
        self.tree = ast.parse(self.text, filename=str(path))
        self.module = self.rel[:-3].replace("/", ".")
        self.suppressions: dict[int, set[str]] = {}
        self.hot_marks: set[int] = set()
        self.owners: dict[int, str] = {}
        self._parents: dict[ast.AST, ast.AST] | None = None
        lines = self.text.splitlines()
        for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if m:
                codes = {
                    c.strip().upper()
                    for c in m.group(1).split(",")
                    if c.strip()
                }
                line = tok.start[0]
                self.suppressions.setdefault(line, set()).update(codes)
                # a comment-only line suppresses the line BELOW it too
                # (trailing comments don't fit next to long expressions)
                if lines[line - 1].lstrip().startswith("#"):
                    self.suppressions.setdefault(line + 1, set()).update(codes)
            m = OWNER_RE.search(tok.string)
            if m:
                line = tok.start[0]
                self.owners[line] = m.group(1)
                if lines[line - 1].lstrip().startswith("#"):
                    self.owners.setdefault(line + 1, m.group(1))
            if HOT_RE.search(tok.string):
                self.hot_marks.add(tok.start[0])
        self._share_across_decorated_headers()

    def _share_across_decorated_headers(self) -> None:
        """Findings on decorated defs are reported at the decorator line;
        waivers and owner= declarations written on the `def` line must
        still match.  Union both maps across each decorated definition's
        header lines (every decorator line plus the def line)."""
        for node in ast.walk(self.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if not node.decorator_list:
                continue
            header = {d.lineno for d in node.decorator_list} | {node.lineno}
            codes: set[str] = set()
            for ln in header:
                codes |= self.suppressions.get(ln, set())
            if codes:
                for ln in header:
                    self.suppressions.setdefault(ln, set()).update(codes)
            owner = next(
                (self.owners[ln] for ln in sorted(header) if ln in self.owners),
                None,
            )
            if owner is not None:
                for ln in header:
                    self.owners.setdefault(ln, owner)

    def suppressed(self, line: int, rule: str) -> bool:
        codes = self.suppressions.get(line, ())
        return rule in codes or "ALL" in codes

    def parents(self) -> dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents


@dataclass
class Context:
    """Everything a rule checker gets to see."""

    files: list[SourceFile]
    graph: object  # callgraph.CallGraph
    hot: set  # set[FuncKey]
    model: object | None = None  # concurrency.ThreadModel
    dataflow: object | None = None  # dataflow.DataflowModel


def default_target() -> Path:
    """The library source dir (the `magicsoup_tpu_torch` package itself)."""
    return Path(__file__).resolve().parents[1]


def iter_python_files(paths) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    return out


def load_files(paths, exclude_analysis: bool = True) -> list[SourceFile]:
    files = []
    seen = set()
    for path in iter_python_files(paths):
        resolved = path.resolve()
        if resolved in seen:
            continue
        seen.add(resolved)
        if exclude_analysis and "analysis" in resolved.parts:
            continue  # the linter does not lint itself
        rel = os.path.relpath(resolved)
        files.append(SourceFile(resolved, rel))
    return files


def build_context(paths, timings: dict | None = None) -> Context:
    """Parse `paths` and build every shared model (call graph, thread
    roles, device dataflow).  `timings`, when given, is filled with
    per-pass wall seconds — the CLI's `--check` telemetry."""
    import time

    from magicsoup_tpu_torch.analysis.callgraph import CallGraph
    from magicsoup_tpu_torch.analysis.concurrency import ThreadModel
    from magicsoup_tpu_torch.analysis.dataflow import DataflowModel

    marks = timings if timings is not None else {}
    t0 = time.perf_counter()
    files = load_files(paths)
    t1 = time.perf_counter()
    marks["parse"] = t1 - t0
    graph = CallGraph(files)
    t2 = time.perf_counter()
    marks["callgraph"] = t2 - t1
    model = ThreadModel(files, graph)
    t3 = time.perf_counter()
    marks["threadmodel"] = t3 - t2
    dataflow = DataflowModel(files, graph)
    marks["dataflow"] = time.perf_counter() - t3
    return Context(
        files=files,
        graph=graph,
        hot=graph.hot_functions(),
        model=model,
        dataflow=dataflow,
    )


def analyze(
    paths,
    rules: list[str] | None = None,
    ctx: Context | None = None,
    timings: dict | None = None,
) -> list[Finding]:
    """Run the (optionally filtered) rule set over `paths`.

    Returns suppression-filtered findings sorted by location.  Baseline
    subtraction is separate (see apply_baseline) so callers can report
    both totals.
    """
    import time

    from magicsoup_tpu_torch.analysis import rules as rules_mod

    if ctx is None:
        ctx = build_context(paths, timings=timings)

    t0 = time.perf_counter()
    by_rel = {f.rel: f for f in ctx.files}
    findings: list[Finding] = []
    for code, checker in rules_mod.checkers(rules).items():
        for finding in checker(ctx):
            src = by_rel.get(finding.path)
            if src is not None and src.suppressed(finding.line, finding.rule):
                continue
            findings.append(finding)
    if timings is not None:
        timings["rules"] = time.perf_counter() - t0
    return sorted(set(findings))


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Path | None = None) -> dict[str, int]:
    """Baseline: map of `path::RULE` -> tolerated finding count.  The
    shipped baseline is EMPTY by policy — pre-existing findings are fixed
    or annotated inline where the next reader sees them; the file exists
    so a downstream fork can stage a large cleanup incrementally."""
    path = path or default_baseline_path()
    if not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text() or "{}")
    # "_"-prefixed keys are policy/comment entries, not budgets
    return {
        str(k): int(v) for k, v in data.items() if not str(k).startswith("_")
    }


def apply_baseline(
    findings: list[Finding], baseline: dict[str, int]
) -> list[Finding]:
    """Drop up to the baselined count of findings per `path::RULE` key."""
    budget = dict(baseline)
    fresh = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
        else:
            fresh.append(f)
    return fresh
