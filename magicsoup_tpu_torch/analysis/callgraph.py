"""
Best-effort AST call graph over the linted file set, for hot-path
reachability (rule GL001 needs "functions reachable from the step
dispatches", not just the dispatches themselves).

Resolution is intentionally conservative — an edge is only recorded when
the callee can be pinned to a function in the linted set:

- bare names defined in the same module;
- ``self.meth(...)`` / ``cls.meth(...)`` within the defining class;
- ``from pkg.mod import fn`` then ``fn(...)``;
- ``import pkg.mod as m`` / ``from pkg import mod`` then ``m.fn(...)``;
- ``self._mgr = Ctor(...)`` then ``self._mgr.meth(...)`` — the
  attribute alias is pinned to ``Ctor`` when the constructor resolves
  to a linted class (and dropped again if any other assignment
  disagrees);
- ``x = Ctor(...)`` then ``x.meth(...)`` within one function, and
  ``def f(mgr: Ctor)`` then ``mgr.meth(...)`` through the parameter
  annotation.

Anything dynamic (callbacks, dict dispatch, attribute chains through
objects) is dropped rather than guessed: a too-eager graph would mark
half the library hot and drown real findings in noise.  Nested ``def``s
are folded into their enclosing function — a helper closed over by a hot
function is hot by construction.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

# The step dispatches the simulation loop actually drives, keyed by file
# basename so the same seeds work on a checkout, an installed tree, or a
# test fixture copy.  Extra roots can be marked in source with a
# `# graftlint: hot` comment on (or directly above) the `def` line.
HOT_SEEDS: dict[str, tuple[str, ...]] = {
    "stepper.py": (
        "PipelinedStepper.step",
        "PipelinedStepper.drain",
    ),
    "world.py": (
        "World.step_many",
        "World.spawn_cells",
        "World.add_cells",
        "World.divide_cells",
        "World.update_cells",
        "World.kill_cells",
        "World.move_cells",
        "World.reposition_cells",
        "World.enzymatic_activity",
        "World.diffuse_molecules",
        "World.degrade_molecules",
        "World.mutate_cells",
        "World.recombinate_cells",
    ),
}

FuncKey = tuple[str, str]  # (file rel path, dotted qualname)


@dataclass
class FunctionRecord:
    """One module- or class-level function, with nested defs folded in."""

    file: object  # engine.SourceFile (duck-typed: .rel, .tree, ...)
    qualname: str
    node: ast.AST
    hot_marked: bool = False
    calls: set[FuncKey] = field(default_factory=set)
    # return-value expressions (for the dataflow engine's summaries)
    returns: list = field(default_factory=list)
    # local name -> (rel, class) pinned via annotation or constructor
    local_types: dict = field(default_factory=dict)


class CallGraph:
    def __init__(self, files: list):
        self.files = list(files)
        self.functions: dict[FuncKey, FunctionRecord] = {}
        self.classes: set[tuple[str, str]] = set()  # (rel, dotted class)
        self._by_module: dict[str, object] = {}
        self._imports: dict[str, dict[str, tuple[str, str | None]]] = {}
        # (rel, cls, attr) -> (class rel, class name); None = conflicting
        self._attr_class: dict[tuple[str, str, str], tuple[str, str] | None] = {}
        self._callers: dict[FuncKey, set[FuncKey]] | None = None
        for f in self.files:
            self._by_module[f.module] = f
            self._index_file(f)
        for rec in self.functions.values():
            self._collect_attr_aliases(rec)
        for rec in self.functions.values():
            self._extract_calls(rec)

    # ------------------------------------------------------------- index
    def _index_file(self, f) -> None:
        imports: dict[str, tuple[str, str | None]] = {}
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    imports[alias] = (a.name, None)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    imports[a.asname or a.name] = (node.module, a.name)
        self._imports[f.rel] = imports

        def visit(body, prefix: str) -> None:
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    first = node.decorator_list[0].lineno if node.decorator_list else node.lineno
                    marked = any(
                        ln in f.hot_marks
                        for ln in range(first - 1, node.lineno + 1)
                    )
                    q = prefix + node.name
                    self.functions[(f.rel, q)] = FunctionRecord(
                        file=f, qualname=q, node=node, hot_marked=marked
                    )
                elif isinstance(node, ast.ClassDef):
                    self.classes.add((f.rel, prefix + node.name))
                    visit(node.body, prefix + node.name + ".")

        visit(f.tree.body, "")

    # ----------------------------------------------------------- aliases
    def _collect_attr_aliases(self, rec: FunctionRecord) -> None:
        """Record ``self.X = Ctor(...)`` attribute→class pins for one
        method.  Conflicting pins (two assignments, different classes)
        collapse to None so resolution stays conservative."""
        if "." not in rec.qualname:
            return
        cls = rec.qualname.rsplit(".", 1)[0]
        for node in ast.walk(rec.node):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            pairs = []
            for tgt in targets:
                if (
                    isinstance(tgt, ast.Tuple)
                    and isinstance(node.value, ast.Tuple)
                    and len(tgt.elts) == len(node.value.elts)
                ):
                    pairs.extend(zip(tgt.elts, node.value.elts))
                elif node.value is not None:
                    pairs.append((tgt, node.value))
            for tgt, value in pairs:
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    continue
                pinned = None
                if isinstance(value, ast.Call):
                    pinned = self.resolve_class(rec.file, value.func)
                key = (rec.file.rel, cls, tgt.attr)
                if key in self._attr_class and self._attr_class[key] != pinned:
                    self._attr_class[key] = None
                else:
                    self._attr_class[key] = pinned

    # ------------------------------------------------------------- edges
    def _extract_calls(self, rec: FunctionRecord) -> None:
        cls = rec.qualname.rsplit(".", 1)[0] if "." in rec.qualname else None
        rec.local_types = self._local_types(rec)
        for node in ast.walk(rec.node):
            if isinstance(node, ast.Call):
                tgt = self.resolve(rec.file, cls, node.func, rec.local_types)
                if tgt is not None:
                    rec.calls.add(tgt)
                rec.calls.update(self._getattr_dispatch(rec.file, cls, node))
            elif isinstance(node, ast.Return) and node.value is not None:
                rec.returns.append(node.value)

    def _local_types(self, rec: FunctionRecord) -> dict:
        """Pin local names to linted classes: parameter annotations and
        ``x = Ctor(...)`` assignments.  Reassignment to anything else
        drops the pin."""
        types: dict[str, tuple[str, str] | None] = {}
        node = rec.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            for a in (
                list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
            ):
                if a.annotation is not None:
                    pinned = self._annotation_class(rec.file, a.annotation)
                    if pinned is not None:
                        types[a.arg] = pinned
        for sub in ast.walk(node):
            if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                continue
            targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            for tgt in targets:
                if not isinstance(tgt, ast.Name):
                    continue
                pinned = None
                if isinstance(sub.value, ast.Call):
                    pinned = self.resolve_class(rec.file, sub.value.func)
                if tgt.id in types and types[tgt.id] != pinned:
                    types[tgt.id] = None
                else:
                    types[tgt.id] = pinned
        return {k: v for k, v in types.items() if v is not None}

    def _annotation_class(self, f, ann: ast.expr) -> tuple[str, str] | None:
        """Resolve a parameter annotation to a linted class.  Handles
        ``Cls``, ``"Cls"`` strings, and ``Cls | None`` unions."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return self._annotation_class(f, ann.left) or self._annotation_class(
                f, ann.right
            )
        if isinstance(ann, (ast.Name, ast.Attribute)):
            return self.resolve_class(f, ann)
        return None

    def resolve_class(self, f, expr: ast.expr) -> tuple[str, str] | None:
        """Resolve a class-reference expression to a linted (rel, name)."""
        imports = self._imports.get(f.rel, {})
        if isinstance(expr, ast.Name):
            if (f.rel, expr.id) in self.classes:
                return (f.rel, expr.id)
            if expr.id in imports:
                mod, name = imports[expr.id]
                if name is not None:
                    return self._module_class(mod, name)
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            base = expr.value.id
            if base in imports:
                mod, name = imports[base]
                target = mod if name is None else f"{mod}.{name}"
                return self._module_class(target, expr.attr)
        return None

    def _module_class(self, module: str, name: str) -> tuple[str, str] | None:
        tf = self._by_module.get(module)
        if tf is None:
            for m, file in self._by_module.items():
                if module.endswith("." + m) or m.endswith("." + module):
                    tf = file
                    break
        if tf is None:
            return None
        key = (tf.rel, name)
        return key if key in self.classes else None

    def _getattr_dispatch(self, f, cls: str | None, call: ast.Call) -> set[FuncKey]:
        """Edges for ``getattr(self, f"_cmd_{name}")``-style dispatch.

        A constant prefix in the f-string pins the callee set to every
        same-class method sharing that prefix — without this, dynamically
        dispatched handlers have no static callers and the concurrency
        model would misclassify them as unreachable/ambient.
        """
        if not (isinstance(call.func, ast.Name) and call.func.id == "getattr"):
            return set()
        if len(call.args) < 2 or cls is None:
            return set()
        obj, name_expr = call.args[0], call.args[1]
        if not (isinstance(obj, ast.Name) and obj.id in ("self", "cls")):
            return set()
        if not (
            isinstance(name_expr, ast.JoinedStr)
            and name_expr.values
            and isinstance(name_expr.values[0], ast.Constant)
            and isinstance(name_expr.values[0].value, str)
        ):
            return set()
        prefix = f"{cls}." + name_expr.values[0].value
        return {
            key
            for key in self.functions
            if key[0] == f.rel and key[1].startswith(prefix)
        }

    def resolve_ref(self, f, cls: str | None, expr: ast.expr) -> FuncKey | None:
        """Resolve a function *reference* (not a call) to a linted function.

        Handles the forms thread/finalizer registration actually uses:
        ``self._run`` / bare names / imported names, plus
        ``functools.partial(fn, ...)`` which unwraps to its first
        positional argument.
        """
        if isinstance(expr, ast.Call):
            callee = expr.func
            is_partial = (
                isinstance(callee, ast.Name) and callee.id == "partial"
            ) or (
                isinstance(callee, ast.Attribute)
                and callee.attr == "partial"
                and isinstance(callee.value, ast.Name)
                and callee.value.id == "functools"
            )
            if is_partial and expr.args:
                return self.resolve_ref(f, cls, expr.args[0])
            return None
        return self.resolve(f, cls, expr)

    def resolve(
        self,
        f,
        cls: str | None,
        func: ast.expr,
        local_types: dict | None = None,
    ) -> FuncKey | None:
        """Resolve a call target expression to a linted function, or None."""
        imports = self._imports.get(f.rel, {})
        if isinstance(func, ast.Name):
            if (f.rel, func.id) in self.functions:
                return (f.rel, func.id)
            if func.id in imports:
                mod, name = imports[func.id]
                if name is not None:
                    return self._module_func(mod, name)
            return None
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            base = func.value.id
            if base in ("self", "cls") and cls:
                key = (f.rel, f"{cls}.{func.attr}")
                return key if key in self.functions else None
            if base in imports:
                mod, name = imports[base]
                target = mod if name is None else f"{mod}.{name}"
                return self._module_func(target, func.attr)
            if local_types and base in local_types:
                crel, cname = local_types[base]
                key = (crel, f"{cname}.{func.attr}")
                return key if key in self.functions else None
            return None
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Attribute)
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "self"
            and cls
        ):
            # ``self._mgr.save(...)`` through a pinned attribute alias
            pinned = self._attr_class.get((f.rel, cls, func.value.attr))
            if pinned is not None:
                crel, cname = pinned
                key = (crel, f"{cname}.{func.attr}")
                return key if key in self.functions else None
        return None

    def _module_func(self, module: str, name: str) -> FuncKey | None:
        tf = self._by_module.get(module)
        if tf is None:
            # linting a subtree (or a fixture dir) yields shorter dotted
            # module names than the import strings — match by suffix
            for m, file in self._by_module.items():
                if module.endswith("." + m) or m.endswith("." + module):
                    tf = file
                    break
        if tf is None:
            return None
        key = (tf.rel, name)
        return key if key in self.functions else None

    # ------------------------------------------------------------ callers
    def callers(self) -> dict[FuncKey, set[FuncKey]]:
        """Reverse edge map (callee -> direct callers), computed once."""
        if self._callers is None:
            rev: dict[FuncKey, set[FuncKey]] = {}
            for key, rec in self.functions.items():
                for callee in rec.calls:
                    rev.setdefault(callee, set()).add(key)
            self._callers = rev
        return self._callers

    # --------------------------------------------------------------- hot
    def hot_functions(self) -> set[FuncKey]:
        """Transitive closure of the step-dispatch seeds + hot marks."""
        seeds = [
            key
            for key, rec in self.functions.items()
            if rec.hot_marked
            or rec.qualname in HOT_SEEDS.get(rec.file.rel.rsplit("/", 1)[-1], ())
        ]
        seen = set(seeds)
        stack = list(seeds)
        while stack:
            for callee in self.functions[stack.pop()].calls:
                if callee not in seen:
                    seen.add(callee)
                    stack.append(callee)
        return seen
