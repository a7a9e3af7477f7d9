"""
graftflow: interprocedural host<->device dataflow analysis of the PyTorch
port.  Counterpart of :mod:`magicsoup_tpu.analysis.dataflow`.

The shallow taint pass in rules.py answers "is this name device-resident"
for straight-line code inside ONE function.  This module answers it for
the whole linted tree: a DEVICE taint seeded at every ``torch.*`` call that
makes a tensor (and every parameter annotated ``Tensor`` / ``DeviceState``
/ ``CellParams``) is propagated through call arguments, return values,
``self.X`` attribute stores and loads, and container packing, to a
fixpoint over the call graph.  Fetching through the sanctioned boundary
(``util.fetch_host``) un-taints, and torch's host metadata (``.shape``,
``.dtype``, ``.device``, ``.numel()``, ``.stride()``...) is host.

The lattice is two-point (HOST < DEVICE) with one refinement: a tuple or
list literal remembers PER-ELEMENT taint, so the library's fetch-cache
idiom — ``self._cache = (device_tensor, fetch_host(device_tensor))`` then
``return self._cache[1]`` — resolves to HOST at the constant-index load
instead of smearing the whole container DEVICE.

Resolution stays conservative the same way callgraph.py is: an unresolved
call contributes nothing (HOST), so every DEVICE verdict is backed by an
actual producer the analyzer can point at.  That under-approximation is
what keeps the four rules built on top — GL019/GL020/GL021/GL022 —
zero-noise enough to run in the default ``--check`` gate with the
empty-by-policy baseline.

Rules (registered in rules.py like the concurrency set):

- **GL019 implicit-host-sync** — interprocedural upgrade of GL001: a
  device value reaching ``bool()/int()/float()``, ``.cpu()/.numpy()/
  .tolist()``, ``np.*``, an ``if``/``while``/``assert`` condition,
  boolean-mask indexing or an f-string in a hot function through a flow
  the shallow pass cannot see (call returns, attribute round trips,
  containers).
- **GL020 fetch-boundary-bypass** — interprocedural upgrade of GL005: a
  D2H conversion outside ``util.fetch_host`` on a value only deep
  dataflow proves device-resident.  fetch_host counts fetches and bytes;
  a bypass silently corrupts the counters telemetry, accounting, and the
  serve ledger bill from.
- **GL021 unprobed-robustness-boundary** — a retry loop, ``except
  OSError``, or guard.io write call in a guard/fleet/serve-scoped module
  with no chaos fault point on its call path, plus drift checks against
  the machine-readable ``guard.chaos.FAULT_POINTS`` registry.
- **GL022 untyped-error-escape** — a ``raise`` of bare
  ``Exception``/``OSError``/``ValueError`` that can propagate out of a
  serve handler, warden hook, or checkpoint entry point; policy layers
  dispatch on the typed guard errors.

Pure stdlib (ast only) — same constraint as the rest of analysis/.
"""
from __future__ import annotations

import ast

from magicsoup_tpu_torch.analysis.engine import Context, Finding

RULE_INFO = {
    "GL019": (
        "implicit-host-sync",
        "a device value reaching bool()/int()/float()/.cpu()/.tolist()/"
        "np.* conversion, an `if` condition, boolean-mask indexing, or "
        "an f-string in a hot-path "
        "function through an interprocedural flow (call returns, "
        "attribute round trips, container packing) the shallow GL001 "
        "pass cannot see — each one blocks the step loop on a hidden "
        "device->host sync",
    ),
    "GL020": (
        "fetch-boundary-bypass",
        "a device->host conversion outside util.fetch_host on a value "
        "only interprocedural dataflow proves device-resident — "
        "fetch_host counts fetches and bytes, so a bypass silently "
        "corrupts the counters that telemetry, accounting, and the "
        "serve ledger all bill from",
    ),
    "GL021": (
        "unprobed-robustness-boundary",
        "a retry loop, `except OSError`, or guard.io write call in a "
        "guard/fleet/serve-scoped module with no chaos fault point "
        "on its call path — the chaos campaign can never exercise that "
        "recovery path, so its first real execution is a production "
        "incident; includes drift between probes and the "
        "guard.chaos.FAULT_POINTS registry",
    ),
    "GL022": (
        "untyped-error-escape",
        "a `raise` of bare Exception/OSError/ValueError that can "
        "propagate out of a serve handler, warden hook, or checkpoint "
        "entry point — the policy layers dispatch on the typed guard "
        "errors (CheckpointError, GuardConfigError, ServeError...); an "
        "untyped escape turns a policy decision into a stack trace",
    ),
}

#: conversion call names that force a blocking D2H sync on a device value
#: (``len()`` reads a tensor's shape: host metadata, no sync)
_SYNC_BUILTINS = {"bool", "int", "float"}
#: exception names GL022 refuses to let escape a certified entry point
_UNTYPED_RAISES = {"Exception", "BaseException", "OSError", "IOError", "ValueError"}
#: guard.io write entry points (each carries the io.write fault point)
_GUARD_IO_WRITES = {"atomic_write_bytes", "atomic_write_text"}

_FIXPOINT_CAP = 50  # safety valve; the tree converges in a handful


def _flat_targets(tgt: ast.expr) -> list[ast.expr]:
    if isinstance(tgt, (ast.Tuple, ast.List)):
        out = []
        for e in tgt.elts:
            out.extend(_flat_targets(e))
        return out
    if isinstance(tgt, ast.Starred):
        return _flat_targets(tgt.value)
    return [tgt]


_HOST_RETURN_ANNS = {"bool", "int", "float", "str", "bytes", "None"}


def _host_annotated(node) -> bool:
    """Whether a def carries an explicit host-scalar return annotation
    (`-> bool` etc.) — an author-certified host boundary."""
    ann = getattr(node, "returns", None)
    if isinstance(ann, ast.Name):
        return ann.id in _HOST_RETURN_ANNS
    if isinstance(ann, ast.Constant):
        return ann.value is None or str(ann.value) in _HOST_RETURN_ANNS
    return False


class DataflowModel:
    """Fixpoint device-taint facts over one CallGraph.

    After construction:

    - ``returns_device``: FuncKeys whose return value is device-resident
    - ``param_device``: FuncKey -> parameter names that receive device
      values (from annotations or any resolved call site)
    - ``attr_device``: (rel, class, attr) triples stored device values
    - ``iterations``: fixpoint sweeps until convergence (CLI telemetry;
      test_graftlint.py budgets it so propagation can't go quadratic)
    """

    def __init__(self, files: list, graph):
        from magicsoup_tpu_torch.analysis import rules as R

        self._R = R
        self.files = files
        self.graph = graph
        self.iterations = 0
        self.returns_device: set = set()
        self.returns_elems: dict = {}  # FuncKey -> [bool per tuple elt]
        self.param_device: dict = {}
        self.attr_device: set = set()
        self._attr_elems: dict = {}  # (rel, cls, attr) -> [bool per elt]
        self._env: dict = {}  # FuncKey -> final tainted local names
        self._env_elems: dict = {}  # FuncKey -> {name: [bool per elt]}
        self._seed_params()
        self._fixpoint()

    # ------------------------------------------------------------ seeds
    def _seed_params(self) -> None:
        for key, rec in self.graph.functions.items():
            args = getattr(rec.node, "args", None)
            if args is None:
                continue
            seeds = set()
            for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
                if a.annotation is not None and self._R.DEVICE_ANN.search(
                    ast.unparse(a.annotation)
                ):
                    seeds.add(a.arg)
            if seeds:
                self.param_device[key] = seeds

    # --------------------------------------------------------- fixpoint
    def _fixpoint(self) -> None:
        changed = True
        while changed and self.iterations < _FIXPOINT_CAP:
            self.iterations += 1
            changed = False
            for key, rec in self.graph.functions.items():
                changed |= self._process(key, rec)

    def _process(self, key, rec) -> bool:
        cls = key[1].rsplit(".", 1)[0] if "." in key[1] else None
        env: set[str] = set(self.param_device.get(key, ()))
        elems: dict[str, list[bool]] = {}
        changed = False
        # two local passes: enough for straight-line propagation inside
        # one body; cross-function flow is the global fixpoint's job
        for _ in range(2):
            for node in ast.walk(rec.node):
                if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    changed |= self._assign(key, rec, cls, env, elems, node)
                elif isinstance(node, ast.For):
                    # iterating a device array yields device rows
                    env.update(self._iter_targets(rec, cls, env, elems, node))
                elif isinstance(node, ast.Call):
                    # container mutation: lst.append(device) taints lst
                    fn = node.func
                    if (
                        isinstance(fn, ast.Attribute)
                        and fn.attr in ("append", "extend", "add", "insert")
                        and isinstance(fn.value, ast.Name)
                        and any(
                            self._expr(rec, cls, env, elems, a) for a in node.args
                        )
                    ):
                        env.add(fn.value.id)
        # return summary (with per-element precision for tuple returns,
        # so unpacking a mixed device/host result doesn't smear taint
        # onto every target).  An explicit host-scalar return annotation
        # certifies the return host regardless of what the body touches
        # (e.g. identity predicates over tuples that carry device slots).
        if (
            key not in self.returns_device
            and not _host_annotated(rec.node)
            and any(self._expr(rec, cls, env, elems, r) for r in rec.returns)
        ):
            self.returns_device.add(key)
            changed = True
        ret_elems = None
        for r in rec.returns:
            desc = self._elems_of(rec, cls, env, elems, r)
            if desc is None:
                ret_elems = None
                break
            ret_elems = (
                desc if ret_elems is None else self._merge_elems(ret_elems, desc)
            )
        if ret_elems is not None:
            merged = self._merge_elems(self.returns_elems.get(key), ret_elems)
            if merged != self.returns_elems.get(key):
                self.returns_elems[key] = merged
                changed = True
        # call-argument -> callee-parameter propagation
        for node in ast.walk(rec.node):
            if isinstance(node, ast.Call):
                changed |= self._propagate_call(key, rec, cls, env, elems, node)
        self._env[key] = env
        self._env_elems[key] = elems
        return changed

    def _assign(self, key, rec, cls, env, elems, node) -> bool:
        changed = False
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        value = node.value
        if value is None:
            return False
        pairs: list[tuple[ast.expr, ast.expr]] = []
        for tgt in targets:
            if (
                isinstance(tgt, (ast.Tuple, ast.List))
                and isinstance(value, ast.Tuple)
                and len(_flat_targets(tgt)) == len(value.elts)
            ):
                pairs.extend(zip(_flat_targets(tgt), value.elts))
            else:
                pairs.append((tgt, value))
        for tgt, val in pairs:
            dev = self._expr(rec, cls, env, elems, val)
            fetched = isinstance(val, ast.Call) and self._R._is_host_fetch(val.func)
            val_elems = self._elems_of(rec, cls, env, elems, val)
            if isinstance(tgt, (ast.Tuple, ast.List)):
                flat = _flat_targets(tgt)
                if val_elems is not None and len(val_elems) == len(flat):
                    # per-element unpack of a known tuple shape
                    for t, tdev in zip(flat, val_elems):
                        if isinstance(t, ast.Name) and tdev:
                            env.add(t.id)
                else:
                    # unpacking an opaque value: every target inherits
                    # the whole value's taint
                    for t in flat:
                        if isinstance(t, ast.Name):
                            if fetched:
                                env.discard(t.id)
                            elif dev:
                                env.add(t.id)
            elif isinstance(tgt, ast.Name):
                if fetched:
                    env.discard(tgt.id)
                    elems.pop(tgt.id, None)
                elif dev:
                    env.add(tgt.id)
                if val_elems is not None:
                    elems[tgt.id] = self._merge_elems(
                        elems.get(tgt.id), val_elems
                    )
            elif (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
                and cls
            ):
                akey = (rec.file.rel, cls, tgt.attr)
                if dev and not fetched and akey not in self.attr_device:
                    self.attr_device.add(akey)
                    changed = True
                if val_elems is not None:
                    merged = self._merge_elems(
                        self._attr_elems.get(akey), val_elems
                    )
                    if merged != self._attr_elems.get(akey):
                        self._attr_elems[akey] = merged
                        changed = True
            elif isinstance(tgt, ast.Subscript):
                base = tgt.value
                if isinstance(base, ast.Name) and dev:
                    env.add(base.id)
        return changed

    def _iter_targets(self, rec, cls, env, elems, loop) -> list[str]:
        """The loop target names a ``for`` (or comprehension) over a
        device value binds to device values: every target, but for the
        key of ``.items()``, the whole of ``.keys()`` and the index of
        ``enumerate(...)``, which are host."""
        it, target = loop.iter, loop.target
        pair = isinstance(target, ast.Tuple) and len(target.elts) == 2
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute):
            if it.func.attr == "keys":
                return []
            if it.func.attr == "items" and pair:
                target = target.elts[1]
        elif (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id == "enumerate"
            and it.args
            and pair
        ):
            it, target = it.args[0], target.elts[1]
        if not self._expr(rec, cls, env, elems, it):
            return []
        return [t.id for t in _flat_targets(target) if isinstance(t, ast.Name)]

    @staticmethod
    def _merge_elems(old, new):
        if old is None:
            return list(new)
        if len(old) != len(new):
            # shape conflict: collapse to a single smeared element
            return [any(old) or any(new)]
        return [a or b for a, b in zip(old, new)]

    def _elems_of(self, rec, cls, env, elems, e):
        """Per-element taint descriptor for tuple/list values, or None."""
        if isinstance(e, (ast.Tuple, ast.List)):
            return [self._expr(rec, cls, env, elems, v) for v in e.elts]
        if isinstance(e, ast.Name):
            got = elems.get(e.id)
            return list(got) if got is not None else None
        if (
            isinstance(e, ast.Attribute)
            and isinstance(e.value, ast.Name)
            and e.value.id == "self"
            and cls
        ):
            got = self._attr_elems.get((rec.file.rel, cls, e.attr))
            return list(got) if got is not None else None
        if isinstance(e, ast.Call):
            tgt = self.graph.resolve(rec.file, cls, e.func, rec.local_types)
            if tgt is not None:
                got = self.returns_elems.get(tgt)
                return list(got) if got is not None else None
        return None

    def _propagate_call(self, key, rec, cls, env, elems, node) -> bool:
        tgt = self.graph.resolve(rec.file, cls, node.func, rec.local_types)
        if tgt is None:
            return False
        tgt_rec = self.graph.functions.get(tgt)
        args_obj = getattr(tgt_rec.node, "args", None)
        if args_obj is None:
            return False
        params = [
            a.arg
            for a in [*args_obj.posonlyargs, *args_obj.args, *args_obj.kwonlyargs]
        ]
        # bound-method call: the explicit args start after self/cls
        offset = (
            1
            if "." in tgt[1]
            and isinstance(node.func, ast.Attribute)
            and params
            and params[0] in ("self", "cls")
            else 0
        )
        changed = False
        got = self.param_device.setdefault(tgt, set())
        for i, a in enumerate(node.args):
            if isinstance(a, ast.Starred):
                continue
            pi = i + offset
            if pi < len(params) and self._expr(rec, cls, env, elems, a):
                if params[pi] not in got:
                    got.add(params[pi])
                    changed = True
        for kw in node.keywords:
            if kw.arg and kw.arg in params and self._expr(
                rec, cls, env, elems, kw.value
            ):
                if kw.arg not in got:
                    got.add(kw.arg)
                    changed = True
        if not got:
            self.param_device.pop(tgt, None)
        return changed

    # -------------------------------------------------------- evaluator
    def _expr(self, rec, cls, env, elems, e) -> bool:
        """Deep `is this expression device-resident` under the current
        global facts.  Superset of rules.expr_is_device: adds resolved
        call returns, attribute-store taint, and per-element containers.
        """
        R = self._R
        if isinstance(e, ast.Name):
            return e.id in env
        if isinstance(e, ast.Attribute):
            if e.attr in R.HOST_META_ATTRS:
                return False
            if e.attr in R.DEVICE_ATTRS:
                return True
            if (
                isinstance(e.value, ast.Name)
                and e.value.id == "self"
                and cls
                and (rec.file.rel, cls, e.attr) in self.attr_device
            ):
                return True
            return self._expr(rec, cls, env, elems, e.value)
        if isinstance(e, ast.Call):
            if R._is_host_fetch(e.func):
                return False
            verdict = R.torch_call_device(
                e, lambda a: self._expr(rec, cls, env, elems, a)
            )
            if verdict is not None:
                return verdict
            tgt = self.graph.resolve(rec.file, cls, e.func, rec.local_types)
            if tgt is not None:
                return tgt in self.returns_device
            if (
                isinstance(e.func, ast.Attribute)
                and e.func.attr not in R.HOST_RESULT_METHODS
            ):
                return self._expr(rec, cls, env, elems, e.func.value)
            return False
        if isinstance(e, ast.Subscript):
            if isinstance(e.slice, ast.Constant) and isinstance(
                e.slice.value, int
            ):
                desc = self._elems_of(rec, cls, env, elems, e.value)
                if desc is not None:
                    i = e.slice.value
                    if -len(desc) <= i < len(desc):
                        return desc[i]
                    return any(desc)
            return self._expr(rec, cls, env, elems, e.value)
        if isinstance(e, ast.BinOp):
            return self._expr(rec, cls, env, elems, e.left) or self._expr(
                rec, cls, env, elems, e.right
            )
        if isinstance(e, ast.UnaryOp):
            return self._expr(rec, cls, env, elems, e.operand)
        if isinstance(e, ast.Compare):
            # identity and membership tests return Python bools, not
            # device scalars (`x is None`, `key in cache`)
            if all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in e.ops
            ):
                return False
            return self._expr(rec, cls, env, elems, e.left) or any(
                self._expr(rec, cls, env, elems, c) for c in e.comparators
            )
        if isinstance(e, ast.BoolOp):
            return any(self._expr(rec, cls, env, elems, v) for v in e.values)
        if isinstance(e, ast.IfExp):
            return self._expr(rec, cls, env, elems, e.body) or self._expr(
                rec, cls, env, elems, e.orelse
            )
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self._expr(rec, cls, env, elems, v) for v in e.elts)
        if isinstance(e, ast.Dict):
            return any(
                self._expr(rec, cls, env, elems, v)
                for v in e.values
                if v is not None
            )
        if isinstance(e, ast.Starred):
            return self._expr(rec, cls, env, elems, e.value)
        if isinstance(e, ast.NamedExpr):
            return self._expr(rec, cls, env, elems, e.value)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            inner = set(env)
            for gen in e.generators:
                inner.update(self._iter_targets(rec, cls, inner, elems, gen))
            return self._expr(rec, cls, inner, elems, e.elt)
        if isinstance(e, ast.DictComp):
            return self._expr(rec, cls, env, elems, e.value)
        return False

    # --------------------------------------------------------- queries
    def expr_device(self, key, e: ast.expr) -> bool:
        """Checker entry: deep taint verdict for `e` inside function `key`."""
        rec = self.graph.functions[key]
        cls = key[1].rsplit(".", 1)[0] if "." in key[1] else None
        return self._expr(
            rec, cls, self._env.get(key, set()), self._env_elems.get(key, {}), e
        )

    def d2h_inventory(self) -> list[dict]:
        """Every device->host crossing the analysis can prove: sanctioned
        fetch_host calls plus any conversion on a deep-tainted value: the
        sync-point certificate the ``--json`` report carries."""
        R = self._R
        out = []
        for key in sorted(self.graph.functions):
            rec = self.graph.functions[key]
            cls = key[1].rsplit(".", 1)[0] if "." in key[1] else None
            if key[1].rsplit(".", 1)[-1] in R.HOST_FETCHERS:
                continue  # the boundary's own implementation
            env = self._env.get(key, set())
            elems = self._env_elems.get(key, {})
            narrowed = R.tensor_narrowing(rec.node)
            for node in ast.walk(rec.node):
                if not isinstance(node, ast.Call):
                    continue
                hosts = narrowed.get(id(node), set())
                env_here = env - hosts if hosts else env
                fn = node.func
                leaf = (
                    fn.attr
                    if isinstance(fn, ast.Attribute)
                    else fn.id
                    if isinstance(fn, ast.Name)
                    else None
                )
                kind = None
                sanctioned = False
                if leaf in R.HOST_FETCHERS:
                    kind, sanctioned = "fetch_host", True
                elif leaf in ("item", "tolist", "cpu", "numpy") and isinstance(
                    fn, ast.Attribute
                ) and self._expr(rec, cls, env_here, elems, fn.value):
                    kind = f".{leaf}()"
                elif (
                    leaf in ("asarray", "array")
                    and R._root_name(fn) in R.NUMPY_ROOTS
                    and node.args
                    and self._expr(rec, cls, env_here, elems, node.args[0])
                ):
                    kind = f"np.{leaf}"
                elif (
                    isinstance(fn, ast.Name)
                    and leaf in _SYNC_BUILTINS
                    and node.args
                    and self._expr(rec, cls, env_here, elems, node.args[0])
                ):
                    kind = f"{leaf}()"
                if kind is not None:
                    out.append(
                        {
                            "file": rec.file.rel,
                            "line": node.lineno,
                            "function": rec.qualname,
                            "kind": kind,
                            "sanctioned": sanctioned,
                        }
                    )
        return sorted(
            out, key=lambda d: (d["file"], d["line"], d["kind"])
        )


# ------------------------------------------------------------------ GL019
def _finding(code: str, f, node, message: str, fixit: str) -> Finding:
    return Finding(
        path=f.rel,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0) + 1,
        rule=code,
        name=RULE_INFO[code][0],
        message=message,
        fixit=fixit,
    )


def check_gl019(ctx: Context):
    """Hot functions only — same scope as GL001, deeper taint.  To stay
    an *upgrade* (one finding per defect, not two), forms GL001 already
    covers are reported only when the shallow pass misses them."""
    from magicsoup_tpu_torch.analysis import rules as R

    model = ctx.dataflow
    fix = (
        "keep the value on device, or certify the crossing: fetch ONCE "
        "through magicsoup_tpu_torch.util.fetch_host outside the step loop"
    )
    for key in sorted(ctx.hot):
        rec = ctx.graph.functions[key]
        f = rec.file
        if rec.qualname.rsplit(".", 1)[-1] in R.HOST_FETCHERS:
            continue
        shallow = R.device_tainted_names(rec.node)

        def deep_only(e) -> bool:
            return model.expr_device(key, e) and not R.expr_is_device(
                e, shallow
            )

        for node, what in R.sync_sites(rec.node, deep_only):
            yield _finding(
                "GL019",
                f,
                node,
                f"{what} in hot function `{rec.qualname}` on a value "
                "interprocedural dataflow proves device-resident (it flows "
                "in through a call or attribute the shallow pass cannot "
                "see) — a hidden blocking sync",
                fix,
            )
        for node in ast.walk(rec.node):
            if isinstance(node, ast.FormattedValue) and model.expr_device(
                key, node.value
            ):
                yield _finding(
                    "GL019",
                    f,
                    node,
                    f"f-string interpolation of a device value in hot "
                    f"function `{rec.qualname}` — str() materializes the "
                    "buffer on host",
                    fix,
                )


# ------------------------------------------------------------------ GL020
def check_gl020(ctx: Context):
    """Whole tree minus util.py (where fetch_host lives) and minus hot
    functions (GL001/GL019's domain).  Conversions GL005 already flags
    on shallow taint are reported only when just the deep pass sees
    them."""
    from magicsoup_tpu_torch.analysis import rules as R

    model = ctx.dataflow
    fix = (
        "route the crossing through magicsoup_tpu_torch.util.fetch_host — it "
        "is the audited boundary AND the metering point (fetch/bytes "
        "counters feed telemetry, accounting, and the serve ledger)"
    )
    for key in sorted(ctx.graph.functions):
        if key in ctx.hot:
            continue
        rec = ctx.graph.functions[key]
        f = rec.file
        if f.rel.rsplit("/", 1)[-1] == "util.py":
            continue
        if rec.qualname.rsplit(".", 1)[-1] in R.HOST_FETCHERS:
            continue
        shallow = R.device_tainted_names(rec.node)

        def deep_only(e) -> bool:
            return model.expr_device(key, e) and not R.expr_is_device(
                e, shallow
            )

        for node in ast.walk(rec.node):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("item", "tolist", "cpu", "numpy")
                and deep_only(fn.value)
            ):
                yield _finding(
                    "GL020",
                    f,
                    node,
                    f"`.{fn.attr}()` in `{rec.qualname}` converts a "
                    "device value outside util.fetch_host — the transfer "
                    "is unmetered and unaudited",
                    fix,
                )
            elif (
                isinstance(fn, ast.Name)
                and fn.id in ("int", "float", "bool")
                and node.args
                and deep_only(node.args[0])
            ):
                yield _finding(
                    "GL020",
                    f,
                    node,
                    f"`{fn.id}()` in `{rec.qualname}` syncs a device "
                    "value outside the sanctioned fetch boundary",
                    fix,
                )
            elif (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("asarray", "array")
                and R._root_name(fn) in R.NUMPY_ROOTS
                and node.args
                and deep_only(node.args[0])
            ):
                yield _finding(
                    "GL020",
                    f,
                    node,
                    f"`np.{fn.attr}()` in `{rec.qualname}` is an implicit "
                    "unmetered device->host transfer (interprocedural "
                    "taint)",
                    fix,
                )


# ------------------------------------------------------------------ GL021
def _probe_sites(rec) -> list[tuple[str | None, ast.Call]]:
    """chaos probes inside one function: ``chaos.site("x")`` /
    ``_chaos.site(...)`` / ``_chaos_probe(...)`` calls, plus constant
    ``chaos_site=`` keywords and parameter defaults (the guard.io
    pattern, where the probing callable receives its site name)."""
    out: list[tuple[str | None, ast.Call]] = []
    for node in ast.walk(rec.node):
        if isinstance(node, ast.Call):
            fn = node.func
            leaf = (
                fn.attr
                if isinstance(fn, ast.Attribute)
                else fn.id
                if isinstance(fn, ast.Name)
                else None
            )
            is_probe = leaf == "_chaos_probe" or (
                leaf == "site"
                and isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id in ("chaos", "_chaos")
            )
            if is_probe:
                name = None
                if node.args and isinstance(node.args[0], ast.Constant):
                    name = node.args[0].value
                out.append((name, node))
                continue
            for kw in node.keywords:
                if (
                    kw.arg == "chaos_site"
                    and isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, str)
                ):
                    out.append((kw.value.value, node))
    args = getattr(rec.node, "args", None)
    if args is not None:
        names = [*args.posonlyargs, *args.args, *args.kwonlyargs]
        defaults = list(args.defaults)
        # align defaults to the tail of positional params
        pos = [*args.posonlyargs, *args.args]
        for a, d in zip(pos[len(pos) - len(defaults) :], defaults):
            if (
                a.arg == "chaos_site"
                and isinstance(d, ast.Constant)
                and isinstance(d.value, str)
            ):
                out.append((d.value, rec.node))
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if (
                a.arg == "chaos_site"
                and isinstance(d, ast.Constant)
                and isinstance(d.value, str)
            ):
                out.append((d.value, rec.node))
        del names
    return out


def _retries_in_handler(handler: ast.ExceptHandler) -> bool:
    """True when the handler re-attempts the failed operation — a
    `continue`, a backoff sleep/delay, or an attempt counter.  This is
    what separates a RETRY loop (chaos-injectable recovery) from a
    drain/cleanup loop that merely tolerates per-item failures."""
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Continue):
            return True
        if isinstance(sub, ast.AugAssign):
            tgt = sub.target
            name = tgt.id if isinstance(tgt, ast.Name) else (
                tgt.attr if isinstance(tgt, ast.Attribute) else ""
            )
            if "attempt" in name or "retr" in name:
                return True
        if isinstance(sub, ast.Call):
            fn = sub.func
            leaf = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if leaf in ("sleep", "delay", "backoff"):
                return True
    return False


_FAULT_CLASSES = {"OSError", "IOError", "Exception", "BaseException"}


def _catches_fault_class(handler: ast.ExceptHandler) -> bool:
    """Whether the handler can see an injected I/O fault at all — a
    `queue.Empty`/`KeyError` drain loop retries, but never on a fault
    the chaos plane could raise, so it is not a chaos boundary."""
    if handler.type is None:
        return True  # bare except catches everything
    names = (
        handler.type.elts
        if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    leaves = {
        n.id if isinstance(n, ast.Name) else (
            n.attr if isinstance(n, ast.Attribute) else None
        )
        for n in names
    }
    return bool(leaves & _FAULT_CLASSES)


def _boundaries(rec) -> list[tuple[str, ast.AST]]:
    """Robustness boundaries inside one function body."""
    out: list[tuple[str, ast.AST]] = []
    for node in ast.walk(rec.node):
        if isinstance(node, (ast.For, ast.While)):
            if any(
                isinstance(sub, ast.Try)
                and any(
                    _retries_in_handler(h) and _catches_fault_class(h)
                    for h in sub.handlers
                )
                for sub in ast.walk(node)
            ):
                out.append(("retry loop", node))
        elif isinstance(node, ast.ExceptHandler) and node.type is not None:
            names = (
                [n for n in node.type.elts]
                if isinstance(node.type, ast.Tuple)
                else [node.type]
            )
            leaves = {
                n.id if isinstance(n, ast.Name) else (
                    n.attr if isinstance(n, ast.Attribute) else None
                )
                for n in names
            }
            # a handler DEDICATED to disk faults is recovery code; an
            # OSError folded into a defensive multi-type tuple (cleanup
            # tolerance) is not a chaos-injectable boundary
            if leaves and leaves <= {"OSError", "IOError"}:
                out.append(("`except OSError`", node))
        elif isinstance(node, ast.Call):
            fn = node.func
            leaf = (
                fn.attr
                if isinstance(fn, ast.Attribute)
                else fn.id
                if isinstance(fn, ast.Name)
                else None
            )
            if leaf in _GUARD_IO_WRITES:
                out.append((f"guard.io `{leaf}` write", node))
    return out


def _parse_registry(chaos_file):
    """(FAULT_POINTS literal, its lineno) from guard/chaos.py's AST —
    the static half of the fault_points() contract."""
    for node in chaos_file.tree.body:
        targets = (
            node.targets
            if isinstance(node, ast.Assign)
            else [node.target]
            if isinstance(node, ast.AnnAssign)
            else []
        )
        if not any(
            isinstance(t, ast.Name) and t.id == "FAULT_POINTS" for t in targets
        ):
            continue
        value = node.value
        if not isinstance(value, ast.Dict):
            continue
        reg = {}
        for k, v in zip(value.keys, value.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                continue
            if (
                isinstance(v, ast.Tuple)
                and len(v.elts) == 2
                and all(isinstance(e, ast.Constant) for e in v.elts)
            ):
                reg[k.value] = (v.elts[0].value, v.elts[1].value)
        return reg, node.lineno
    return None, None


def check_gl021(ctx: Context):
    """Chaos coverage as a static proof.  A robustness boundary is
    covered when a chaos probe exists in its own function, in a
    transitive callee (the probed primitive it drives), or in a
    transitive caller (the probed driver that owns its retry).  Plus
    registry drift: every constant probe site must appear in
    guard.chaos.FAULT_POINTS with the module/callable that really
    probes it, and vice versa."""
    from magicsoup_tpu_torch.analysis import rules as R

    graph = ctx.graph
    probe_funcs: set = set()
    probes_by_site: dict[str, list] = {}
    for key, rec in graph.functions.items():
        sites = _probe_sites(rec)
        if sites:
            probe_funcs.add(key)
            for name, node in sites:
                if name is not None:
                    probes_by_site.setdefault(name, []).append((key, node))
    # covered = can REACH a probe (reverse closure over callers) or is
    # DRIVEN by probed code (forward closure over calls)
    covered = set(probe_funcs)
    stack = list(probe_funcs)
    callers = graph.callers()
    while stack:
        for c in callers.get(stack.pop(), ()):
            if c not in covered:
                covered.add(c)
                stack.append(c)
    forward = set(probe_funcs)
    stack = list(probe_funcs)
    while stack:
        for c in graph.functions[stack.pop()].calls:
            if c not in forward:
                forward.add(c)
                stack.append(c)
    covered |= forward

    fix = (
        "register a guard.chaos fault point on this path (probe with "
        "`chaos.site(...)` or route the write through guard.io), and "
        "add it to guard.chaos.FAULT_POINTS so the campaign matrix "
        "exercises the failure"
    )
    for key in sorted(graph.functions):
        rec = graph.functions[key]
        f = rec.file
        base = f.rel.rsplit("/", 1)[-1]
        if f.rel.endswith("guard/chaos.py") or base == "chaos.py":
            continue  # the fault plane itself
        if not (
            R._is_guard_scoped(f) or R._is_fleet_scoped(f) or R._is_serve_scoped(f)
        ):
            continue
        if key in covered:
            continue
        for what, node in _boundaries(rec):
            if what.startswith("guard.io") and not any(
                c[1].rsplit(".", 1)[-1] in _GUARD_IO_WRITES
                for c in rec.calls
            ):
                # the guard.io callee did not resolve into this graph
                # (partial-tree run): its in-body probe cannot be seen,
                # so its absence cannot be proven either
                continue
            yield _finding(
                "GL021",
                f,
                node,
                f"{what} in `{rec.qualname}` has no chaos fault "
                "point on its call path — the chaos campaign cannot "
                "exercise this recovery code",
                fix,
            )

    chaos_file = next(
        (f for f in ctx.files if f.rel.endswith("guard/chaos.py")), None
    )
    if chaos_file is None:
        return
    registry, reg_line = _parse_registry(chaos_file)
    if registry is None:
        yield _finding(
            "GL021",
            chaos_file,
            chaos_file.tree,
            "guard/chaos.py has no parseable FAULT_POINTS literal — "
            "GL021 cannot certify probe/registry agreement",
            "declare FAULT_POINTS: dict[str, tuple[str, str]] mapping "
            "each site to its probing (module, callable)",
        )
        return
    for site, entries in sorted(probes_by_site.items()):
        if site in registry:
            continue
        key, node = entries[0]
        yield _finding(
            "GL021",
            graph.functions[key].file,
            node,
            f"probe site {site!r} in `{graph.functions[key].qualname}` "
            "is missing from guard.chaos.FAULT_POINTS — analyzer and "
            "runtime plane disagree about what is probed",
            f"add {site!r} to FAULT_POINTS (and SITES) in guard/chaos.py",
        )
    anchor = ast.Module(body=[], type_ignores=[])
    anchor.lineno, anchor.col_offset = reg_line, 0
    for site, (mod, qual) in sorted(registry.items()):
        hits = probes_by_site.get(site, ())
        for pkg in ("magicsoup_tpu_torch.", "magicsoup_tpu."):
            if mod.startswith(pkg):
                mod_tail = mod[len(pkg):]
                break
        else:
            mod_tail = mod
        ok = any(
            graph.functions[k].qualname == qual
            and graph.functions[k].file.module.endswith(mod_tail)
            for k, _ in hits
        )
        if not ok:
            yield _finding(
                "GL021",
                chaos_file,
                anchor,
                f"FAULT_POINTS entry {site!r} -> {mod}.{qual} has no "
                "matching probe in the tree — the registry drifted from "
                "the code",
                "fix the registry entry (or restore the probe) so "
                "fault_points() and the AST agree",
            )


# ------------------------------------------------------------------ GL022
def _entry_points(ctx: Context) -> dict:
    """Certified entry families -> {FuncKey: human label}."""
    from magicsoup_tpu_torch.analysis import concurrency as C
    from magicsoup_tpu_torch.analysis import rules as R

    entries: dict = {}
    for key, rec in ctx.graph.functions.items():
        qual = rec.qualname
        leaf = qual.rsplit(".", 1)[-1]
        cls = qual.rsplit(".", 1)[0] if "." in qual else None
        if ctx.model is not None and "http-handler" in ctx.model.role_of(key):
            entries.setdefault(key, f"serve handler `{qual}`")
        if leaf.startswith("_cmd_") and R._is_serve_scoped(rec.file):
            entries.setdefault(key, f"serve command `{qual}`")
        if (
            cls
            and "Warden" in cls
            and not leaf.startswith("_")
            and leaf not in C.INIT_NAMES
        ):
            entries.setdefault(key, f"warden hook `{qual}`")
        if (
            rec.file.rel.rsplit("/", 1)[-1] in ("checkpoint.py", "resume.py")
            and "guard" in rec.file.rel.split("/")
            and not leaf.startswith("_")
            and leaf not in C.INIT_NAMES
        ):
            entries.setdefault(key, f"checkpoint entry `{qual}`")
    return entries


_CATCHES = {
    "Exception": {"Exception", "OSError", "IOError", "ValueError"},
    "BaseException": {
        "Exception",
        "BaseException",
        "OSError",
        "IOError",
        "ValueError",
    },
    "OSError": {"OSError", "IOError"},
    "IOError": {"OSError", "IOError"},
    "ValueError": {"ValueError"},
}


def _caught_locally(f, rec, raise_node, exc_name: str) -> bool:
    """True when an enclosing try in the SAME function catches the
    raised type (interprocedural catches are the entry's job — a typed
    error would survive them by design)."""
    parents = f.parents()
    cur = parents.get(raise_node)
    prev = raise_node
    while cur is not None and cur is not rec.node:
        if isinstance(cur, ast.Try) and prev in cur.body:
            for h in cur.handlers:
                names = (
                    [n for n in h.type.elts]
                    if isinstance(h.type, ast.Tuple)
                    else [h.type]
                ) if h.type is not None else []
                for n in names:
                    leaf = (
                        n.attr
                        if isinstance(n, ast.Attribute)
                        else n.id
                        if isinstance(n, ast.Name)
                        else None
                    )
                    if leaf and exc_name in _CATCHES.get(leaf, {leaf}):
                        return True
        prev, cur = cur, parents.get(cur)
    return False


def check_gl022(ctx: Context):
    """Typed-error certification for the three policy surfaces: serve
    handlers, warden hooks, and checkpoint entry points.  Anything
    their call closures can raise must be a typed error (GuardError
    family, ServeError, ...) so the layer above can dispatch on it —
    builtin Exception/OSError/ValueError raises are flagged at the
    raise site, named with the entry they escape from."""
    from magicsoup_tpu_torch.analysis import concurrency as C

    entries = _entry_points(ctx)
    origin: dict = dict(entries)
    stack = list(entries)
    while stack:
        key = stack.pop()
        for callee in ctx.graph.functions[key].calls:
            if callee not in origin:
                origin[callee] = origin[key]
                stack.append(callee)
    fix = (
        "raise a typed error instead (guard.errors.GuardConfigError / "
        "CheckpointError / serve.api.ServeError ...) — or catch and "
        "wrap at the boundary; waive a deliberate builtin with "
        "`# graftlint: disable=GL022`"
    )
    for key in sorted(origin):
        rec = ctx.graph.functions[key]
        if rec.qualname.rsplit(".", 1)[-1] in C.INIT_NAMES:
            continue  # constructor validation is the caller's contract
        f = rec.file
        for node in ast.walk(rec.node):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            target = exc.func if isinstance(exc, ast.Call) else exc
            leaf = (
                target.attr
                if isinstance(target, ast.Attribute)
                else target.id
                if isinstance(target, ast.Name)
                else None
            )
            if leaf not in _UNTYPED_RAISES:
                continue
            if _caught_locally(f, rec, node, leaf):
                continue
            yield _finding(
                "GL022",
                f,
                node,
                f"`raise {leaf}` in `{rec.qualname}` can escape "
                f"{origin[key]} untyped — the policy layer above "
                "dispatches on the typed guard errors and will only see "
                "a stack trace",
                fix,
            )
