"""
The graftlint rule set of the PyTorch/CUDA port.  Each checker takes an
engine.Context and yields Findings; registration at the bottom.
Counterpart of :mod:`magicsoup_tpu.analysis.rules`: the same codes, names
and comment grammar, read for torch tensors.

| code  | name                 | protects                                   |
|-------|----------------------|--------------------------------------------|
| GL001 | host-sync-in-hot-path| step-loop latency (no blocking D2H syncs)  |
| GL003 | dtype-discipline     | the float32 contract (f64 only in detmath) |
| GL004 | nondeterminism       | seeded reproducibility                     |
| GL005 | blocking-transfer    | the single audited D2H boundary            |
| GL007 | tolist-in-hot-loop   | batch host conversion (no per-item tolist) |
| GL009 | missing-device       | explicit placement (no hot-path tensor     |
|       |                      | factory that lands on the CPU)             |
| GL010 | non-atomic-save      | crash-safe state persistence (guard.io)    |
| GL012 | shared-prng-key      | per-world randomness in fleet modules (no  |
|       |                      | one threefry key across the world axis)    |
| GL013 | swallowed-guard-error| typed guard errors reach their policy layer|
| GL014 | blocking-call-in-    | serve-loop liveness (no unbounded sleeps / |
|       | serve-loop           | waits inside serve-scoped scheduler loops) |
| GL015 | cross-thread-write   | single-writer discipline                   |
| GL016 | lock-order-inversion | deadlock freedom                           |
| GL017 | queue-bypass         | the serve command-queue contract           |
| GL018 | raw-io-in-guard-path | the guard.io write boundary                |
| GL019 | implicit-host-sync   | step-loop latency across call boundaries   |
| GL020 | fetch-boundary-bypass| the metered util.fetch_host boundary       |
| GL021 | unprobed-robustness- | chaos coverage as a static proof           |
|       | boundary             |                                            |
| GL022 | untyped-error-escape | typed errors at certified entries          |
| GL023 | host-genome-in-hot-  | device-resident genomes                    |
|       | path                 |                                            |
| GL024 | per-group-dispatch-  | the fused-dispatch contract                |
|       | loop                 |                                            |
| GL025 | bare-clock-in-hot-   | the telemetry measurement plane            |
|       | path                 |                                            |
| GL026 | integrator-backend-  | the integrator backend plane (no direct    |
|       | bypass               | kernel or body call in a hot function)     |

The JAX package's GL002 (recompile-hazard), GL006 (missing-donation),
GL008 (host-callback-in-jit) and GL011 (traced-assert) have no torch
reading: eager PyTorch has no jit wrapper to rebuild, no buffer donation,
no compiled host callback and no trace in which an ``assert`` vanishes (an
``assert`` on a tensor is a sync, which GL001/GL019 report).

GL015-GL017 are built on the thread-role model (analysis/concurrency.py,
with the runtime assertions in analysis/ownership.py).

The device-taint analysis in THIS module is a deliberately shallow
intra-procedural pass: a name is "device" when it is a parameter
annotated with a tensor type, is assigned from a ``torch.*`` call that
makes a tensor, or flows through arithmetic / indexing / method calls on
device values; torch's host metadata (``.shape``, ``.dtype``, ``.device``,
``.is_cuda``, ``.numel()``, ``.dim()``, ``.stride()``, ``.data_ptr()``,
``.is_contiguous()``...) is host, and fetching through the sanctioned
boundary (util.fetch_host) un-taints.  Shallow means under-approximate —
precision here buys a zero-noise default, which is what keeps the lint
gate tolerable.  GL019-GL022 layer the INTERPROCEDURAL taint fixpoint on
top (analysis/dataflow.py), deduped so each site is reported by exactly
one rule.
"""
from __future__ import annotations

import ast
import re

from magicsoup_tpu_torch.analysis import concurrency, dataflow
from magicsoup_tpu_torch.analysis.engine import Context, Finding

TORCH_ROOTS = {"torch"}
NUMPY_ROOTS = {"np", "numpy"}
# device-resident attributes of the library's own classes
DEVICE_ATTRS = {
    "_state",
    "_molecule_map",
    "_cell_molecules",
    "_positions_dev",
    "_mol_idx_dev",
    "_kill_below_dev",
    "_divide_above_dev",
    "_divide_cost_dev",
}
# metadata attributes that never touch device buffers
HOST_META_ATTRS = {
    "shape",
    "ndim",
    "dtype",
    "device",
    "is_cuda",
    "is_sparse",
    "layout",
    "nbytes",
    "itemsize",
    "requires_grad",
}
# tensor methods that read host metadata (no sync, no device result)
HOST_META_METHODS = {
    "numel",
    "nelement",
    "dim",
    "ndimension",
    "size",
    "stride",
    "storage_offset",
    "data_ptr",
    "is_contiguous",
    "is_pinned",
    "is_floating_point",
    "element_size",
    "get_device",
    "untyped_storage",
}
# tensor methods whose result lives on the host: the conversions (each a
# device->host sync on a CUDA tensor) and the metadata reads
HOST_RESULT_METHODS = {"item", "tolist", "cpu", "numpy"} | HOST_META_METHODS
# the sanctioned boundary: fetching through these returns HOST data
HOST_FETCHERS = {"fetch_host", "_fetch_host", "sanctioned_transfer"}
# torch.* calls that return host objects, not device tensors
TORCH_HOST_FNS = {
    "device",
    "is_tensor",
    "is_floating_point",
    "is_grad_enabled",
    "finfo",
    "iinfo",
    "get_default_dtype",
    "Size",
    "from_numpy",
    "manual_seed",
    "set_num_threads",
    "get_num_threads",
    "set_flush_denormal",
    "no_grad",
    "inference_mode",
    "set_grad_enabled",
    "Generator",
}
# torch submodules whose calls make no device tensor (device queries,
# process groups, profilers, build helpers)
TORCH_HOST_MODULES = (
    "torch.cuda.",
    "torch.distributed.",
    "torch.backends.",
    "torch.profiler.",
    "torch.utils.",
    "torch.autograd.",
)
# torch calls (or tensor methods) whose output size depends on the data:
# each blocks the host until the device has computed it
SYNC_OPS = {
    "nonzero",
    "argwhere",
    "masked_select",
    "unique",
    "unique_consecutive",
}
# torch constructors that make a NEW tensor and take `device=` (the
# *_like forms inherit their prototype's device and are exempt)
_PLACEMENT_CTORS = {
    "tensor",
    "as_tensor",
    "asarray",
    "zeros",
    "ones",
    "full",
    "empty",
    "arange",
    "linspace",
    "eye",
}
DEVICE_ANN = re.compile(r"\bTensor\b|\bDeviceState\b|\bCellParams\b")

RULE_INFO = {
    "GL001": (
        "host-sync-in-hot-path",
        "blocking device->host sync inside a function reachable from the "
        "step dispatches (`.item()`, `.cpu()`, `.numpy()`, `.tolist()`, "
        "`float()/int()/bool()` or `if` on a tensor, `torch.nonzero`, "
        "boolean-mask indexing)",
    ),
    "GL003": (
        "dtype-discipline",
        "float64 (`torch.float64`, `.double()`, `np.float64`) outside "
        "ops/detmath.py (the float32 contract)",
    ),
    "GL004": (
        "nondeterminism",
        "wall-clock or unseeded randomness in library code",
    ),
    "GL005": (
        "blocking-transfer",
        "device->host transfer outside the sanctioned util.fetch_host "
        "boundary",
    ),
    "GL007": (
        "tolist-in-hot-loop",
        "per-item `.tolist()` inside a loop in a hot-path function — "
        "each call crosses the C/Python boundary per element; convert "
        "the whole array ONCE before the loop and slice host lists",
    ),
    "GL009": (
        "missing-device",
        "hot-path tensor factory (`torch.zeros/ones/full/empty/arange/"
        "tensor/as_tensor/...`) without `device=` in a device-placed "
        "module — the tensor lands on the CPU, and the next op on a "
        "card either fails or copies it over, synchronizing, every "
        "step",
    ),
    "GL010": (
        "non-atomic-save",
        "state pickled straight into its destination file — a crash "
        "mid-write destroys BOTH the old snapshot and the new one; "
        "persistence must go through guard.io's "
        "write-temp->fsync->os.replace protocol",
    ),
    "GL012": (
        "shared-prng-key",
        "a threefry draw (`prng.uniform/randint/random_bits`) in a fleet "
        "module consuming a key that is not per-world — one unsplit key "
        "broadcast across the world axis gives every world of the batch "
        "the SAME random stream, silently correlating trajectories that "
        "are documented independent",
    ),
    "GL013": (
        "swallowed-guard-error",
        "broad `except Exception:`/`except BaseException:` without a "
        "re-raise in a guard/fleet-scoped module — the typed guard "
        "errors (CheckpointError, SentinelTripped, WatchdogTimeout) "
        "exist so the policy layer can react; a blanket handler that "
        "logs-and-continues turns a refused checkpoint or a tripped "
        "sentinel into silent corruption",
    ),
    "GL014": (
        "blocking-call-in-serve-loop",
        "an unbounded blocking call (`time.sleep`, `.result()` with no "
        "timeout, `.get()` with no timeout) inside a loop in a "
        "serve-scoped module — the serving loop is the single writer "
        "for every tenant, so one unbounded wait stalls all of them "
        "and turns a transient hiccup into a fleet-wide outage",
    ),
    "GL018": (
        "raw-io-in-guard-path",
        "a direct write-mode `open()` or `os.replace`/`os.rename` in a "
        "guard/fleet/serve-scoped module — raw file writes bypass "
        "guard.io's write-temp->fsync->replace protocol (so a crash "
        "tears the file) AND the chaos fault plane (so the chaos "
        "campaign cannot reach the failure path at all); append-mode "
        "streams are exempt",
    ),
    "GL023": (
        "host-genome-in-hot-path",
        "a host genome list access (`.cell_genomes` / `._genomes`) or a "
        "per-cell string mutation engine call inside a stepper-, "
        "fleet-, or serve-scoped hot function — genomes are "
        "device-resident packed token tensors; decoding them (or running "
        "the host string engine) on the hot path reintroduces the "
        "per-cell host work the token backend exists to delete",
    ),
    "GL024": (
        "per-group-dispatch-loop",
        "a device dispatch call inside a `for`-loop over rung groups / "
        "sibling groups in a fleet- or serve-scoped module — each "
        "iteration pays a full program launch (+ its own D2H fetch), "
        "which is exactly the R-dispatches-per-megastep cost the "
        "cross-rung fusion planner deletes; route the loop through "
        "FleetScheduler._plan_fusion (one batched program per fused "
        "set) or waive a deliberate per-group path",
    ),
    "GL025": (
        "bare-clock-in-hot-path",
        "a bare `time.time()` / `time.perf_counter()` / "
        "`time.monotonic()` reading inside a stepper-, fleet-, or "
        "serve-scoped hot function whose measurement never routes into "
        "the telemetry plane — timings taken on the hot path and kept "
        "in local state are invisible to the recorder spans, the "
        "metrics registry, and therefore to `/metrics`; "
        "route the reading through the recorder span API "
        "(TelemetryRecorder.note) or the metrics registry (observe / "
        "note_device_time), or waive a deliberate local timing",
    ),
    "GL026": (
        "integrator-backend-bypass",
        "a direct `integrate_signals_cuda` / "
        "`integrate_signals_cuda_grouped` / `integrate_signals` / "
        "`integrate_grouped` / `integrate_signals_tiled` call inside a "
        "stepper-, fleet-, or serve-scoped hot function — the "
        "integrator implementation is selected by the backend registry "
        "(ops.backends: capability flags, env/constructor resolution, "
        "the dispatch census), and a hot-path call that names a kernel "
        "or a torch body directly pins one implementation, skips the "
        "capability checks, and invisibly forks the selection logic the "
        "`World(integrator=...)` plane exists to centralize; route "
        "through ops.backends.integrate with the resolved backend name",
    ),
}
# the concurrency rules keep their metadata next to their model
# (analysis/concurrency.py) — merge so the CLI/docs see one table
RULE_INFO.update(concurrency.RULE_INFO)
# ...and the dataflow rules next to theirs (analysis/dataflow.py)
RULE_INFO.update(dataflow.RULE_INFO)


def _root_name(node: ast.expr) -> str | None:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _attr_chain(node: ast.expr) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_host_fetch(func: ast.expr) -> bool:
    if isinstance(func, ast.Name):
        return func.id in HOST_FETCHERS
    if isinstance(func, ast.Attribute):
        return func.attr in HOST_FETCHERS
    return False


def _finding(code: str, f, node: ast.AST, message: str, fixit: str) -> Finding:
    return Finding(
        path=f.rel,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0) + 1,
        rule=code,
        name=RULE_INFO[code][0],
        message=message,
        fixit=fixit,
    )


# --------------------------------------------------------------- taint
def _host_placed(call: ast.Call) -> bool:
    """A host placement spelled out on a call: ``device="cpu"`` (or
    ``torch.device("cpu")``) or ``pin_memory=True``."""
    for kw in call.keywords:
        v = kw.value
        if kw.arg == "pin_memory" and isinstance(v, ast.Constant) and v.value is True:
            return True
        if kw.arg != "device":
            continue
        if isinstance(v, ast.Call) and _attr_chain(v.func) == "torch.device" and v.args:
            v = v.args[0]
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
    return False


def torch_call_device(call: ast.Call, is_dev) -> bool | None:
    """Whether a ``torch.*`` call makes a device tensor; None when the call
    is not rooted at torch.  Host objects (devices, dtype info, process
    groups, profilers), ``torch.from_numpy`` (host memory by definition),
    a factory without ``device=`` (torch makes it on the CPU) and a host
    placement spelled out are host; ``torch.as_tensor`` / ``asarray``
    without ``device=`` keep their argument's place (``is_dev``)."""
    chain = _attr_chain(call.func)
    if chain.split(".", 1)[0] not in TORCH_ROOTS:
        return None
    if chain.startswith(TORCH_HOST_MODULES):
        return False
    leaf = chain.rsplit(".", 1)[-1]
    if leaf in TORCH_HOST_FNS or _host_placed(call):
        return False
    if leaf in _PLACEMENT_CTORS and not any(kw.arg == "device" for kw in call.keywords):
        if leaf in ("as_tensor", "asarray"):
            return bool(call.args) and is_dev(call.args[0])
        return False
    return True


def device_tainted_names(fn_node: ast.AST) -> set[str]:
    tainted: set[str] = set()
    args = getattr(fn_node, "args", None)
    if args is not None:
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            if a.annotation is not None and DEVICE_ANN.search(
                ast.unparse(a.annotation)
            ):
                tainted.add(a.arg)
    # two fixed passes: enough for straight-line propagation without a
    # full dataflow framework
    for _ in range(2):
        for node in ast.walk(fn_node):
            value = None
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            if value is None:
                continue
            names = [
                t.id
                for tgt in targets
                for t in (
                    tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
                )
                if isinstance(t, ast.Name)
            ]
            if isinstance(value, ast.Call) and _is_host_fetch(value.func):
                tainted.difference_update(names)
            elif expr_is_device(value, tainted):
                tainted.update(names)
    return tainted


def expr_is_device(e: ast.expr, tainted: set[str]) -> bool:
    if isinstance(e, ast.Name):
        return e.id in tainted
    if isinstance(e, ast.Attribute):
        if e.attr in HOST_META_ATTRS:
            return False
        if e.attr in DEVICE_ATTRS:
            return True
        return expr_is_device(e.value, tainted)
    if isinstance(e, ast.Call):
        if _is_host_fetch(e.func):
            return False
        verdict = torch_call_device(e, lambda a: expr_is_device(a, tainted))
        if verdict is not None:
            return verdict
        if isinstance(e.func, ast.Attribute) and e.func.attr not in HOST_RESULT_METHODS:
            # method call on a device value returns a device value
            return expr_is_device(e.func.value, tainted)
        return False
    if isinstance(e, ast.BinOp):
        return expr_is_device(e.left, tainted) or expr_is_device(e.right, tainted)
    if isinstance(e, ast.UnaryOp):
        return expr_is_device(e.operand, tainted)
    if isinstance(e, ast.Subscript):
        return expr_is_device(e.value, tainted)
    if isinstance(e, ast.Compare):
        # identity and membership tests read the reference, not the buffer
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
            return False
        return expr_is_device(e.left, tainted) or any(
            expr_is_device(c, tainted) for c in e.comparators
        )
    if isinstance(e, ast.BoolOp):
        return any(expr_is_device(v, tainted) for v in e.values)
    if isinstance(e, ast.IfExp):
        return expr_is_device(e.body, tainted) or expr_is_device(e.orelse, tainted)
    if isinstance(e, (ast.Tuple, ast.List)):
        return any(expr_is_device(v, tainted) for v in e.elts)
    return False


# ------------------------------------------------------ sync forms
#: torch calls whose result is a boolean mask of their tensor arguments
_MASK_FNS = {
    "isfinite",
    "isnan",
    "isinf",
    "isneginf",
    "isposinf",
    "isin",
    "signbit",
    "logical_and",
    "logical_or",
    "logical_not",
    "logical_xor",
    "eq",
    "ne",
    "lt",
    "le",
    "gt",
    "ge",
}


def _is_mask(e: ast.expr, is_dev, masks: set[str]) -> bool:
    """Whether ``e`` is a boolean mask of device values: a comparison, a
    mask function, ``.bool()``, their ``~``/``&``/``|`` combinations, or
    a local name assigned from one."""
    if isinstance(e, ast.Name):
        return e.id in masks
    if isinstance(e, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
            return False
        return is_dev(e)
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, (ast.Invert, ast.Not)):
        return _is_mask(e.operand, is_dev, masks)
    if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(e.left, is_dev, masks) or _is_mask(e.right, is_dev, masks)
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute):
        leaf = e.func.attr
        if _root_name(e.func) in TORCH_ROOTS:
            return leaf in _MASK_FNS
        if leaf == "bool" or leaf in _MASK_FNS:
            return is_dev(e.func.value)
    return False


def mask_names(fn_node: ast.AST, is_dev) -> set[str]:
    """Local names assigned a boolean mask of device values (two passes,
    as the taint pass)."""
    masks: set[str] = set()
    for _ in range(2):
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign) and _is_mask(node.value, is_dev, masks):
                masks.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return masks


def _is_tensor_test(test: ast.expr) -> str | None:
    """The name ``x`` of an ``isinstance(x, torch.Tensor)`` test, else None."""
    if (
        isinstance(test, ast.Call)
        and isinstance(test.func, ast.Name)
        and test.func.id == "isinstance"
        and len(test.args) == 2
        and isinstance(test.args[0], ast.Name)
        and "Tensor" in ast.unparse(test.args[1])
    ):
        return test.args[0].id
    return None


def tensor_narrowing(fn_node: ast.AST) -> dict[int, set[str]]:
    """``id(node) -> names`` that are known NOT to be tensors at ``node``:
    everything under the false branch of an ``isinstance(x, torch.Tensor)``
    test (``if``/``elif``/conditional expression), or the true branch of
    its negation.  Lets the host fallback of a tensor-or-scalar helper
    convert its scalar without a finding."""
    out: dict[int, set[str]] = {}

    def mark(stmts, name):
        for st in stmts:
            for sub in ast.walk(st):
                out.setdefault(id(sub), set()).add(name)

    for node in ast.walk(fn_node):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        test, negated = node.test, False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test, negated = test.operand, True
        name = _is_tensor_test(test)
        if name is None:
            continue
        host_side = node.body if negated else node.orelse
        mark(host_side if isinstance(host_side, list) else [host_side], name)
    return out


def sync_sites(fn_node: ast.AST, is_dev):
    """``(node, what)`` for every form in one function body that blocks the
    host on the device when ``is_dev`` holds for its operand: ``.tolist()``
    / ``.cpu()`` / ``.numpy()``, a data-dependent-size method
    (``.nonzero()``, ``.unique()``...), ``float()/int()/bool()``,
    ``np.asarray/np.array``, an ``if``/``while``/``assert``/conditional
    expression on a tensor, and boolean-mask indexing.  ``.item()`` and the
    ``torch.*`` data-dependent calls are a sync whatever their operand,
    so GL001 reports them on its own."""
    masks = mask_names(fn_node, is_dev)
    narrowed = tensor_narrowing(fn_node)
    base = is_dev

    for node in ast.walk(fn_node):
        hosts = narrowed.get(id(node))

        def is_dev(e, hosts=hosts):
            if hosts and isinstance(e, ast.Name) and e.id in hosts:
                return False
            return base(e)

        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute):
                if fn.attr in ("tolist", "cpu", "numpy") and is_dev(fn.value):
                    yield node, f"`.{fn.attr}()`"
                elif (
                    fn.attr in SYNC_OPS
                    and _root_name(fn) not in TORCH_ROOTS
                    and is_dev(fn.value)
                ):
                    yield node, f"`.{fn.attr}()`"
                elif (
                    fn.attr in ("asarray", "array")
                    and _root_name(fn) in NUMPY_ROOTS
                    and node.args
                    and is_dev(node.args[0])
                ):
                    yield node, f"`np.{fn.attr}()`"
            elif (
                isinstance(fn, ast.Name)
                and fn.id in ("float", "int", "bool")
                and node.args
                and is_dev(node.args[0])
            ):
                yield node, f"`{fn.id}()`"
        elif isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)) and is_dev(
            node.test
        ):
            what = {ast.If: "if", ast.While: "while", ast.Assert: "assert"}.get(
                type(node), "conditional expression"
            )
            yield node, f"`{what}` on a tensor"
        elif (
            isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Load)
            and _is_mask(node.slice, is_dev, masks)
        ):
            yield node, "boolean-mask indexing"


def unconditional_syncs(fn_node: ast.AST):
    """``(node, what)`` for the calls that synchronize whatever their
    operand: ``.item()``, ``torch.nonzero`` and the other data-dependent
    ``torch.*`` calls, and one-argument ``torch.where``."""
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "item":
            yield node, "`.item()`"
            continue
        chain = _attr_chain(fn)
        if chain.split(".", 1)[0] not in TORCH_ROOTS:
            continue
        leaf = chain.rsplit(".", 1)[-1]
        if leaf in SYNC_OPS or (
            leaf == "where" and len(node.args) == 1 and not node.keywords
        ):
            yield node, f"`{chain}()`"


# --------------------------------------------------------------- GL001
def check_gl001(ctx: Context):
    fix_fetch = (
        "keep the value on device, or fetch ONCE through "
        "magicsoup_tpu_torch.util.fetch_host outside the step loop"
    )
    for key in sorted(ctx.hot):
        rec = ctx.graph.functions[key]
        f = rec.file
        tainted = device_tainted_names(rec.node)
        found = list(unconditional_syncs(rec.node)) + list(
            sync_sites(rec.node, lambda e: expr_is_device(e, tainted))
        )
        for node, what in found:
            yield _finding(
                "GL001",
                f,
                node,
                f"{what} in hot function `{rec.qualname}` blocks the step "
                "loop on a device->host sync",
                "branch with torch.where / keep the mask on device, or hoist "
                "the decision out of the hot loop"
                if "on a tensor" in what or what == "boolean-mask indexing"
                else fix_fetch,
            )


# --------------------------------------------------------------- GL003
def check_gl003(ctx: Context):
    fix = (
        "stay in float32; deterministic f64 arithmetic belongs in "
        "ops/detmath.py — annotate sanctioned sites with "
        "`# graftlint: disable=GL003`"
    )
    for f in ctx.files:
        if f.rel.rsplit("/", 1)[-1] == "detmath.py":
            continue  # THE sanctioned f64 module
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Attribute) and node.attr in ("float64", "double"):
                root = _root_name(node)
                if root in TORCH_ROOTS | NUMPY_ROOTS and (
                    node.attr == "float64" or root in TORCH_ROOTS
                ):
                    yield _finding(
                        "GL003",
                        f,
                        node,
                        f"`{_attr_chain(node)}` outside ops/detmath.py",
                        fix,
                    )
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "double"
                and not node.args
                and _root_name(node.func) not in TORCH_ROOTS | NUMPY_ROOTS
            ):
                yield _finding(
                    "GL003",
                    f,
                    node,
                    "`.double()` outside ops/detmath.py widens a tensor to "
                    "float64",
                    fix,
                )
            elif (
                isinstance(node, ast.keyword)
                and node.arg == "dtype"
                and isinstance(node.value, ast.Constant)
                and node.value.value == "float64"
            ):
                yield _finding(
                    "GL003", f, node.value, 'dtype="float64" string literal', fix
                )


# --------------------------------------------------------------- GL004
_NP_RANDOM_OK = {"default_rng", "Generator", "PCG64", "SeedSequence", "Philox"}
#: torch draws from the process-global generator unless given generator=
_TORCH_RANDOM = {
    "rand",
    "randn",
    "randint",
    "randperm",
    "rand_like",
    "randn_like",
    "randint_like",
    "normal",
    "bernoulli",
    "multinomial",
    "poisson",
}


def check_gl004(ctx: Context):
    for f in ctx.files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain in ("time.time", "time.time_ns"):
                yield _finding(
                    "GL004",
                    f,
                    node,
                    f"`{chain}()` in library code — wall clock breaks seeded "
                    "reproducibility",
                    "thread an explicit seed / step counter through instead; "
                    "annotate telemetry-only sites with "
                    "`# graftlint: disable=GL004`",
                )
            elif chain.startswith("random.") and chain.split(".")[1] not in (
                "Random",
            ):
                yield _finding(
                    "GL004",
                    f,
                    node,
                    f"`{chain}()` uses process-global (or OS-entropy) "
                    "randomness",
                    "use a seeded random.Random(seed) instance plumbed from "
                    "the caller",
                )
            elif (
                chain.startswith(("np.random.", "numpy.random."))
                and chain.rsplit(".", 1)[-1] not in _NP_RANDOM_OK
            ):
                yield _finding(
                    "GL004",
                    f,
                    node,
                    f"`{chain}()` mutates numpy's process-global RNG",
                    "use np.random.default_rng(seed) plumbed from the caller",
                )
            elif (
                chain.split(".", 1)[0] in TORCH_ROOTS
                and chain.rsplit(".", 1)[-1] in _TORCH_RANDOM | {"manual_seed", "seed"}
                and not any(kw.arg == "generator" for kw in node.keywords)
            ):
                yield _finding(
                    "GL004",
                    f,
                    node,
                    f"`{chain}()` draws from (or reseeds) torch's "
                    "process-global generator",
                    "draw through the threefry keys of ops/prng.py (seeded "
                    "per world), or pass a seeded torch.Generator",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("PRNGKey", "prng_key")
            ):
                bad_seed = not node.args or any(
                    isinstance(sub, ast.Call)
                    and _attr_chain(sub.func).split(".")[0] in ("time", "random")
                    for a in node.args
                    for sub in ast.walk(a)
                )
                if bad_seed:
                    yield _finding(
                        "GL004",
                        f,
                        node,
                        f"unseeded (or clock-seeded) `{chain}`",
                        "derive keys from one experiment-level seed via "
                        "prng.split / fold_in",
                    )


# --------------------------------------------------------------- GL005
def check_gl005(ctx: Context):
    fix = (
        "route the fetch through magicsoup_tpu_torch.util.fetch_host — the "
        "one audited device->host point (metered, and allowed under "
        "hot_path_guard)"
    )
    for f in ctx.files:
        if f.rel.rsplit("/", 1)[-1] == "util.py":
            continue  # fetch_host lives here: the sanctioned boundary
        for key, rec in ctx.graph.functions.items():
            if rec.file is not f or key in ctx.hot:
                continue  # hot functions are GL001's domain
            tainted = device_tainted_names(rec.node)
            for node in ast.walk(rec.node):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in ("cpu", "numpy")
                    and expr_is_device(fn.value, tainted)
                ):
                    yield _finding(
                        "GL005",
                        f,
                        node,
                        f"`.{fn.attr}()` in `{rec.qualname}` bypasses the "
                        "sanctioned boundary",
                        fix,
                    )
                elif (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "to"
                    and any(
                        isinstance(v, ast.Constant) and v.value == "cpu"
                        for v in [*node.args, *(kw.value for kw in node.keywords)]
                    )
                    and expr_is_device(fn.value, tainted)
                ):
                    yield _finding(
                        "GL005",
                        f,
                        node,
                        f"`.to(\"cpu\")` in `{rec.qualname}` bypasses the "
                        "sanctioned boundary",
                        fix,
                    )
                elif (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in ("asarray", "array")
                    and _root_name(fn) in NUMPY_ROOTS
                    and node.args
                    and expr_is_device(node.args[0], tainted)
                ):
                    yield _finding(
                        "GL005",
                        f,
                        node,
                        f"`np.{fn.attr}()` on a device value in "
                        f"`{rec.qualname}` is an implicit blocking transfer",
                        fix,
                    )


# --------------------------------------------------------------- GL007
def check_gl007(ctx: Context):
    """Per-item ``.tolist()`` inside a loop in a hot function: every
    call crosses the C/Python boundary and allocates a fresh list for
    ONE row, so a batch of n items pays n round-trips.  The fast idiom
    (genetics.translate_genomes) converts the whole array once before the
    loop and slices host lists inside it.  GL001 already covers the
    device-tainted case (a blocking D2H per iteration); this rule keeps
    the host-numpy case out of the hot paths too."""
    fix = (
        "hoist the conversion: call `.tolist()` ONCE on the full array "
        "before the loop and index the resulting host list per item; "
        "waive a deliberate per-item conversion with "
        "`# graftlint: disable=GL007`"
    )
    for key in sorted(ctx.hot):
        rec = ctx.graph.functions[key]
        f = rec.file
        seen: set[int] = set()  # nested loops walk the same calls twice
        for loop in ast.walk(rec.node):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if id(node) in seen:
                    continue
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "tolist"
                ):
                    seen.add(id(node))
                    yield _finding(
                        "GL007",
                        f,
                        node,
                        f"`.tolist()` inside a loop in hot function "
                        f"`{rec.qualname}` converts per item — n "
                        "iterations pay n C/Python round-trips",
                        fix,
                    )


# --------------------------------------------------------------- GL009
def _is_device_placed(f) -> bool:
    """A module is device-placed when it imports torch at the TOP level:
    its tensors follow a world's or a caller's device.  Lazy in-function
    imports do not count (build and benchmark helpers)."""
    for node in f.tree.body:
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] in TORCH_ROOTS for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[0] in TORCH_ROOTS:
                return True
    return False


def check_gl009(ctx: Context):
    """Placement must be explicit on the hot path: a ``torch.zeros(...)``
    / ``torch.tensor(...)`` WITHOUT ``device=`` makes a CPU tensor, so a
    hot function of a module whose tensors live on a card either fails at
    the next op or copies the tensor over (a pageable host->device copy,
    which synchronizes) on every step.  ``device="cpu"`` spelled out is a
    placement too; non-device-placed modules are exempt."""
    fix = (
        "pass the placement explicitly — `device=` the world's or the "
        "tensor's device (`x.device`), or `device=\"cpu\"` for a host "
        "staging tensor; waive a deliberate CPU tensor with "
        "`# graftlint: disable=GL009`"
    )
    for key in sorted(ctx.hot):
        rec = ctx.graph.functions[key]
        f = rec.file
        if not _is_device_placed(f):
            continue
        for node in ast.walk(rec.node):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain.split(".", 1)[0] not in TORCH_ROOTS or "." not in chain:
                continue
            leaf = chain.rsplit(".", 1)[-1]
            if leaf not in _PLACEMENT_CTORS:
                continue
            if any(kw.arg == "device" for kw in node.keywords) or _host_placed(node):
                continue
            yield _finding(
                "GL009",
                f,
                node,
                f"`{chain}()` without `device=` in hot function "
                f"`{rec.qualname}` of a device-placed module — the tensor "
                "lands on the CPU",
                fix,
            )


_PICKLE_DUMP = {"pickle.dump", "cloudpickle.dump", "dill.dump"}
_PICKLE_DUMPS = {"pickle.dumps", "cloudpickle.dumps", "dill.dumps"}


def check_gl010(ctx: Context):
    """State persistence must be crash-safe: ``pickle.dump(obj, fh)``
    (or ``fh.write(pickle.dumps(obj))``) straight into the destination
    file truncates the previous snapshot the moment the file opens, so
    a crash mid-write destroys both the old bytes and the new — the
    exact failure guard.io's write-temp -> fsync -> ``os.replace``
    protocol exists to close.  Passing ``pickle.dumps`` bytes to
    ``guard.io.atomic_write_bytes`` (or any non-``.write`` consumer) is
    the sanctioned form and is not flagged; the guard package itself —
    the one place allowed to own raw file protocol — is exempt."""
    fix = (
        "serialize to bytes and hand them to "
        "guard.io.atomic_write_bytes(path, pickle.dumps(obj)) — or use "
        "guard.write_checkpoint for a verified, versioned snapshot; "
        "waive a deliberate raw write (e.g. a fault injector) with "
        "`# graftlint: disable=GL010`"
    )
    for f in ctx.files:
        if "guard" in f.path.parts:
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain in _PICKLE_DUMP and len(node.args) >= 2:
                yield _finding(
                    "GL010",
                    f,
                    node,
                    f"`{chain}()` writes state directly into its "
                    "destination file — a crash mid-write destroys the "
                    "previous snapshot along with the new one",
                    fix,
                )
            elif (
                chain.endswith(".write")
                and chain not in _PICKLE_DUMP
                and node.args
                and isinstance(node.args[0], ast.Call)
                and _attr_chain(node.args[0].func) in _PICKLE_DUMPS
            ):
                yield _finding(
                    "GL010",
                    f,
                    node,
                    f"`{chain}({_attr_chain(node.args[0].func)}(...))` "
                    "writes pickled state non-atomically — a partial "
                    "write leaves a truncated pickle where the previous "
                    "snapshot was",
                    fix,
                )


# --------------------------------------------------------------- GL012
#: the threefry draws of ops/prng.py (key plumbing such as ``split`` or
#: ``prng_key`` is not a draw)
_DRAW_LEAVES = {"uniform", "randint", "random_bits"}
#: the module names the port's draws are reached through
_PRNG_MODULES = {"prng", "_prng"}
#: first-arg forms that ARE per-world: a subscripted key array
#: (``keys[w]``) or a fresh derivation from the world lane
_PER_WORLD_DERIVES = {"split", "fold_in"}


def _imported_names(f) -> set[str]:
    """Every package segment the file imports (``from a.b import c``
    gives a, b and c; ``import a.b`` gives a and b), walked once per
    file: the scope predicates below all read it."""
    names = f.__dict__.get("_imported_names")
    if names is None:
        names = set()
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module:
                    names.update(node.module.split("."))
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    names.update(a.name.split("."))
        f._imported_names = names
    return names


def _is_fleet_scoped(f) -> bool:
    """A file is fleet-scoped when it lives under a ``fleet`` package or
    imports one — the modules whose code runs under the stacked world
    axis, where a non-per-world key is a correctness hazard rather than
    a style choice."""
    if "fleet" in f.path.parts:
        return True
    return "fleet" in _imported_names(f)


def check_gl012(ctx: Context):
    """Randomness under the fleet's stacked world axis must be
    per-world: every threefry draw (``prng.uniform`` / ``randint`` /
    ``random_bits``) in a fleet-scoped module has to consume a key
    indexed out of a per-world key array (``keys[w]``) or freshly
    derived from one (``prng.split``).  A bare key name — one unsplit
    key reused across the batch — broadcasts the SAME stream to every
    world, so B "independent" trajectories share their mutation draws,
    spawn positions, and recombination points."""
    fix = (
        "index a per-world key array (`keys[w]`) or derive the lane key "
        "with prng.split before drawing; waive a deliberately shared "
        "stream (e.g. a common environment shock) with "
        "`# graftlint: disable=GL012`"
    )
    for f in ctx.files:
        if not _is_fleet_scoped(f):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            parts = _attr_chain(node.func).split(".")
            if len(parts) < 2 or parts[-2] not in _PRNG_MODULES:
                continue
            chain = ".".join(parts)
            if parts[-1] not in _DRAW_LEAVES:
                continue
            if not node.args:
                yield _finding(
                    "GL012",
                    f,
                    node,
                    f"`{chain}()` without a key argument in a fleet "
                    "module — there is no per-world stream at all",
                    fix,
                )
                continue
            k = node.args[0]
            per_world = isinstance(k, ast.Subscript) or (
                isinstance(k, ast.Call)
                and _attr_chain(k.func).rsplit(".", 1)[-1]
                in _PER_WORLD_DERIVES
            )
            if not per_world:
                yield _finding(
                    "GL012",
                    f,
                    node,
                    f"`{chain}()` consumes a key shared across the "
                    "world axis — every world of the fleet draws the "
                    "same stream",
                    fix,
                )


#: broad handler types GL013 flags — anything these catch includes the
#: whole typed guard hierarchy (GuardError is a RuntimeError)
_BROAD_EXC = {"Exception", "BaseException"}


def _is_guard_scoped(f) -> bool:
    """A file is guard-scoped when it lives under a ``guard`` package
    or imports one — the modules that handle the typed guard errors
    (and every fleet-scoped module, which sits above them)."""
    if "guard" in f.path.parts:
        return True
    if _is_fleet_scoped(f):
        return True
    return "guard" in _imported_names(f)


def check_gl013(ctx: Context):
    """Typed guard errors must reach their policy layer.  The guard
    hierarchy (``CheckpointError``, ``SentinelTripped``,
    ``WatchdogTimeout``, ...) exists so callers can REACT — restore a
    checkpoint, quarantine a world, kill a wedged fetch.  A broad
    ``except Exception:`` (or ``BaseException:``, or a bare
    ``except:``) in a guard/fleet-scoped module that never re-raises
    swallows all of them indistinguishably from a transient hiccup:
    the run continues on corrupt state and the fault surfaces far from
    its cause.  A handler whose body contains any ``raise`` passes —
    wrapping into a typed error or re-raising after cleanup is exactly
    the sanctioned shape."""
    fix = (
        "catch the specific errors the block can actually handle, or "
        "re-raise (`raise` / `raise TypedError(...) from exc`) after "
        "cleanup; waive a handler that deliberately delivers the error "
        "elsewhere (e.g. future.set_exception) with "
        "`# graftlint: disable=GL013`"
    )
    for f in ctx.files:
        if not _is_guard_scoped(f):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            excs = (
                list(node.type.elts)
                if isinstance(node.type, ast.Tuple)
                else [node.type]
            )
            broad = any(
                e is None or _attr_chain(e).rsplit(".", 1)[-1] in _BROAD_EXC
                for e in excs
            )
            if not broad:
                continue
            if any(
                isinstance(n, ast.Raise)
                for stmt in node.body
                for n in ast.walk(stmt)
            ):
                continue
            what = (
                "bare `except:`"
                if node.type is None
                else f"`except {ast.unparse(node.type)}:`"
            )
            yield _finding(
                "GL013",
                f,
                node,
                f"{what} without re-raise in a guard-scoped module "
                "swallows the typed guard errors (CheckpointError, "
                "SentinelTripped, WatchdogTimeout) the policy layer "
                "needs to see",
                fix,
            )


def _is_serve_scoped(f) -> bool:
    """A file is serve-scoped when it lives under a ``serve`` package
    or imports one — the modules that run (or ride on) the service's
    single-writer scheduler loop, where an unbounded wait blocks every
    tenant at once."""
    if "serve" in f.path.parts:
        return True
    return "serve" in _imported_names(f)


def check_gl014(ctx: Context):
    """Serve loops must stay live.  The serving layer runs ONE
    scheduler thread for every tenant; any unbounded blocking call
    inside one of its loops — ``time.sleep`` pacing, a ``.result()``
    with no timeout on a future, a ``queue.get()`` with no timeout —
    parks the whole fleet behind a single wait that nothing can
    interrupt (a wedged transfer then looks identical to a busy
    service, and SIGTERM drain deadlines silently slip).  The
    sanctioned shapes are the non-blocking drain
    (``get_nowait()``/``Event.wait(timeout=...)``) and
    timeout-bounded waits whose expiry surfaces as a typed error.
    Scope: ``while`` loops in serve-scoped modules — request handlers
    and one-shot commands may block (their caller holds the timeout).
    """
    fix = (
        "bound the wait (`q.get(timeout=...)`, `fut.result(timeout=...)`)"
        " or drain without blocking (`get_nowait()` + `Event.wait(t)`); "
        "waive a deliberately blocking wait with "
        "`# graftlint: disable=GL014`"
    )
    for f in ctx.files:
        if not _is_serve_scoped(f):
            continue
        for loop in ast.walk(f.tree):
            if not isinstance(loop, ast.While):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                kwargs = {k.arg for k in node.keywords}
                chain = _attr_chain(node.func)
                if chain == "time.sleep":
                    yield _finding(
                        "GL014",
                        f,
                        node,
                        "`time.sleep()` inside a serve-loop `while` — "
                        "sleep pacing blocks every tenant and ignores "
                        "wake/stop events",
                        fix,
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "result"
                    and not node.args
                    and "timeout" not in kwargs
                ):
                    yield _finding(
                        "GL014",
                        f,
                        node,
                        f"`{chain}()` without a timeout inside a "
                        "serve-loop `while` — an unfinished future "
                        "wedges the single scheduler thread forever",
                        fix,
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and not node.args
                    and "timeout" not in kwargs
                    and not any(
                        k.arg == "block"
                        and isinstance(k.value, ast.Constant)
                        and k.value.value is False
                        for k in node.keywords
                    )
                ):
                    yield _finding(
                        "GL014",
                        f,
                        node,
                        f"`{chain}()` without a timeout inside a "
                        "serve-loop `while` — an empty queue blocks "
                        "the loop with no way to observe stop/wake",
                        fix,
                    )


# --------------------------------------------------------------- GL018
#: open() modes that can MODIFY the target ("w"/"x" truncate or create,
#: "+" allows in-place writes); plain reads and append-only streams
#: (JSONL telemetry sinks) are legitimately raw
_WRITE_MODE = re.compile(r"[wx+]")


def _open_write_mode(node: ast.Call) -> str | None:
    """The string-literal mode of an ``open()`` call when it can write,
    else None (reads, appends, or a dynamic mode expression)."""
    mode = node.args[1] if len(node.args) >= 2 else None
    if mode is None:
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
    if (
        isinstance(mode, ast.Constant)
        and isinstance(mode.value, str)
        and _WRITE_MODE.search(mode.value)
    ):
        return mode.value
    return None


def check_gl018(ctx: Context):
    """Writes in the robustness stack must go through ``guard.io``.
    A raw ``open(path, "wb")`` (or ``os.replace`` of a hand-built temp
    file) in a guard/fleet/serve-scoped module bypasses two contracts
    at once: the write-temp -> fsync -> ``os.replace`` atomicity that
    keeps a crash from tearing the file, and the chaos
    ``io.write`` fault point — so the chaos campaign can never reach
    the code's failure path, which means its recovery behavior is
    unproven by construction.  ``guard/io.py`` itself (the one module
    that owns the raw protocol) is exempt; append-mode streams and
    reads are not flagged."""
    fix = (
        "route the write through guard.io.atomic_write_bytes / "
        "atomic_write_text (pass chaos_site= to join the fault plane); "
        "waive a deliberate raw write (e.g. a fault injector) with "
        "`# graftlint: disable=GL018`"
    )
    for f in ctx.files:
        if f.path.parts[-2:] == ("guard", "io.py"):
            continue
        if not (_is_guard_scoped(f) or _is_serve_scoped(f)):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain == "open":
                mode = _open_write_mode(node)
                if mode is not None:
                    yield _finding(
                        "GL018",
                        f,
                        node,
                        f"`open(..., {mode!r})` in a guard-path module "
                        "writes raw — it bypasses guard.io's atomic "
                        "protocol and the chaos fault plane",
                        fix,
                    )
            elif chain in ("os.replace", "os.rename"):
                yield _finding(
                    "GL018",
                    f,
                    node,
                    f"`{chain}()` in a guard-path module finishes a "
                    "hand-rolled write protocol — use guard.io, which "
                    "already fsyncs, replaces atomically, and carries "
                    "the chaos fault point",
                    fix,
                )


# --------------------------------------------------------------- GL023
def _is_stepper_scoped(f) -> bool:
    """A file is stepper-scoped when it IS the stepper module or imports
    it — code that runs on (or rides along) the fused megastep's
    dispatch/replay loop, where per-cell host work serializes the
    pipeline."""
    if f.path.stem == "stepper":
        return True
    return "stepper" in _imported_names(f)


#: attribute names that resolve to a host genome string list; loading
#: one in a hot function decodes the device token store (or walks the
#: legacy list) cell by cell
_GENOME_LIST_ATTRS = {"cell_genomes", "genomes", "_genomes", "_genomes_list"}
#: the host string mutation engine's entry points — per-cell Python
#: string work; hot paths use the token kernels instead
_HOST_MUTATION_ENGINES = {"point_mutations", "recombinations"}


def check_gl023(ctx: Context):
    """Host genome work must not ride the hot path.  Genomes live on
    device as packed token arrays; the string side (``.cell_genomes``,
    the host mutation engine) is an import/export boundary.  In a hot
    function of a stepper-, fleet-, or serve-scoped module, a genome
    list load or a host-engine mutation call is per-cell host string
    work on the step loop's critical path — the exact cost the token
    backend deleted.  String-backend fallback sites waive with
    ``# graftlint: disable=GL023``."""
    fix = (
        "keep genomes on device: use the GenomeStore token arrays and "
        "the token mutation programs (magicsoup_tpu_torch.genomes); decode "
        "through .cell_genomes only at the import/export boundary, or "
        "waive a deliberate string-backend fallback with "
        "`# graftlint: disable=GL023`"
    )
    for key in sorted(ctx.hot):
        rec = ctx.graph.functions[key]
        f = rec.file
        if not (
            _is_stepper_scoped(f)
            or _is_fleet_scoped(f)
            or _is_serve_scoped(f)
        ):
            continue
        for node in ast.walk(rec.node):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and node.attr in _GENOME_LIST_ATTRS
            ):
                yield _finding(
                    "GL023",
                    f,
                    node,
                    f"`.{node.attr}` in hot function `{rec.qualname}` "
                    "loads the host genome string list — decoding the "
                    "device token store per cell on the hot path",
                    fix,
                )
            elif isinstance(node, ast.Call):
                leaf = _attr_chain(node.func).rsplit(".", 1)[-1]
                if leaf in _HOST_MUTATION_ENGINES:
                    yield _finding(
                        "GL023",
                        f,
                        node,
                        f"`{leaf}()` in hot function `{rec.qualname}` "
                        "runs the host string mutation engine per cell "
                        "— use the token programs "
                        "(point_mutations_tokens / "
                        "recombinations_tokens)",
                        fix,
                    )


# --------------------------------------------------------------- GL024
#: device dispatch entry points: the per-rung and fused fleet programs
#: plus the scheduler's `_dispatch_*` wrappers (the `_dispatch_` prefix
#: is the scheduler's dispatch-path naming convention; the commit/retry
#: helpers deliberately do not share it)
_DISPATCH_LEAVES = {
    "fleet_step",
    "fused_fleet_step",
    "fleet_step_program",
    "fused_step_program",
}
#: loop-name fragments that identify iteration over rung/sibling groups
_GROUP_LOOP_NAMES = ("group", "sibling")


def _loop_target_names(target) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _loop_target_names(e)]
    return []


def check_gl024(ctx: Context):
    """Device dispatches must not loop over rung groups.  A ``for``
    loop whose target or iterable names groups/siblings and whose body
    launches a device program (``fleet_step`` / ``fused_fleet_step`` /
    a scheduler ``_dispatch_*`` method) pays one program launch AND one
    physical fetch per iteration — the R-dispatches-per-megastep cost
    on the serve critical path that the cross-rung fusion planner
    exists to delete.  Loops over the PLANNER's output (an iterable
    whose expression mentions ``plan``, e.g. ``self._plan_fusion(...)``)
    are the sanctioned route and exempt; a deliberate per-group path
    waives with ``# graftlint: disable=GL024``."""
    fix = (
        "route the dispatch through the fusion planner "
        "(FleetScheduler._plan_fusion partitions the live groups; one "
        "fused set dispatches as ONE batched program), or waive a "
        "deliberate per-group dispatch with `# graftlint: disable=GL024`"
    )
    for f in ctx.files:
        if not (_is_fleet_scoped(f) or _is_serve_scoped(f)):
            continue
        for loop in ast.walk(f.tree):
            if not isinstance(loop, ast.For):
                continue
            names = " ".join(_loop_target_names(loop.target)).lower()
            iter_chain = _attr_chain(
                loop.iter.func
                if isinstance(loop.iter, ast.Call)
                else loop.iter
            ).lower()
            if not any(
                frag in names or frag in iter_chain
                for frag in _GROUP_LOOP_NAMES
            ):
                continue
            if "plan" in iter_chain:
                continue  # planner-routed: the sanctioned dispatch loop
            for node in loop.body:
                for call in ast.walk(node):
                    if not isinstance(call, ast.Call):
                        continue
                    leaf = _attr_chain(call.func).rsplit(".", 1)[-1]
                    if leaf in _DISPATCH_LEAVES or (
                        leaf.startswith("_dispatch_")
                        and leaf != "_dispatch_with_retry"
                    ):
                        yield _finding(
                            "GL024",
                            f,
                            call,
                            f"`{leaf}` dispatches a device program "
                            "inside a per-group loop — R rung groups "
                            "pay R launches + R fetches per megastep "
                            "instead of one fused program",
                            fix,
                        )


# --------------------------------------------------------------- GL025
#: attribute chains that read a wall/monotonic clock; covers the repo's
#: idioms (`time.perf_counter()`, `import time as _time`, and the bare
#: from-import forms). `time.sleep` et al. are not readings.
_BARE_CLOCK_CHAINS = {
    "time.time",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "_time.time",
    "_time.monotonic",
    "_time.perf_counter",
    "perf_counter",
    "perf_counter_ns",
    "monotonic",
    "monotonic_ns",
}
#: call leaves that carry a measurement into the telemetry plane: the
#: recorder span API (`note`, `span`), the metrics registry
#: (`observe`, plus the device census `note_device_time` and the
#: commit-to-fetch-ready bracket constructor `_device_ready`), and the
#: dispatch-row drain (`take_dispatch`).  A hot function containing one
#: of these is routing its clock readings, not hoarding them.
_CLOCK_ROUTING_LEAVES = {
    "note",
    "span",
    "observe",
    "note_device_time",
    "_device_ready",
    "take_dispatch",
}


def _routes_clock_readings(fn_node: ast.AST) -> bool:
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call):
            leaf = _attr_chain(node.func).rsplit(".", 1)[-1]
            if leaf in _CLOCK_ROUTING_LEAVES:
                return True
    return False


def check_gl025(ctx: Context):
    """Clock readings on the hot path must feed the telemetry plane.
    A bare ``time.time()`` / ``perf_counter()`` / ``monotonic()`` in a
    stepper-, fleet-, or serve-scoped hot function is a measurement the
    operator can never see: it costs a syscall on the step loop's
    critical path and then dies in a local, bypassing the recorder
    spans and the metrics registry that ``/metrics`` exposes.  A
    function that also calls the span/registry route
    (:data:`_CLOCK_ROUTING_LEAVES`, nested closures included) is
    exempt — its readings land in telemetry.  Deliberate local timings
    (e.g. a deadline check) waive with
    ``# graftlint: disable=GL025``."""
    fix = (
        "route the measurement into the telemetry plane: bracket the "
        "reading with TelemetryRecorder.note(phase, dt) or feed a "
        "registry histogram/census (MetricsRegistry.observe, "
        "telemetry.metrics.note_device_time), or waive a deliberate "
        "local timing with `# graftlint: disable=GL025`"
    )
    for key in sorted(ctx.hot):
        rec = ctx.graph.functions[key]
        f = rec.file
        if not (
            _is_stepper_scoped(f)
            or _is_fleet_scoped(f)
            or _is_serve_scoped(f)
        ):
            continue
        if _routes_clock_readings(rec.node):
            continue
        for node in ast.walk(rec.node):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain in _BARE_CLOCK_CHAINS:
                yield _finding(
                    "GL025",
                    f,
                    node,
                    f"`{chain}()` in hot function `{rec.qualname}` takes "
                    "a clock reading that never reaches the telemetry "
                    "plane — invisible to recorder spans and /metrics",
                    fix,
                )


# --------------------------------------------------------------- GL026
#: the integrator entry points a hot function must not name directly —
#: the registry (`ops.backends.integrate`) is the one selection path
_INTEGRATOR_LEAVES = {
    "integrate_signals",
    "integrate_signals_steps",
    "integrate_signals_cuda",
    "integrate_signals_cuda_grouped",
    "integrate_signals_tiled",
    "integrate_grouped",
}
#: the registry's own module: `backends.integrate_grouped` IS the route
_REGISTRY_MODULES = {"backends", "_backends"}


def check_gl026(ctx: Context):
    """The integrator backend registry is the ONE selection path on the
    hot path.  A stepper-, fleet-, or serve-scoped hot function that
    calls the kernel wrappers (``integrate_signals_cuda`` /
    ``integrate_signals_cuda_grouped``) or the torch bodies
    (``integrate_signals`` / ``integrate_grouped`` /
    ``integrate_signals_tiled``) directly has hard-wired a kernel choice:
    it bypasses the capability flags (det-able, mesh-able) the registry
    enforces, the ``World(integrator=...)``/env resolution the operator
    controls, and the per-backend dispatch census ``/metrics`` exposes.
    Route through :func:`magicsoup_tpu_torch.ops.backends.integrate` (or
    ``integrate_grouped``) with the resolved backend name; a deliberate
    direct call waives with ``# graftlint: disable=GL026``."""
    fix = (
        "route the call through the backend registry: "
        "ops.backends.integrate(integrator, X, params) with the "
        "resolved backend name (World.integrator / ops.backends.resolve), "
        "or waive a deliberate direct kernel call with "
        "`# graftlint: disable=GL026`"
    )
    for key in sorted(ctx.hot):
        rec = ctx.graph.functions[key]
        f = rec.file
        if not (
            _is_stepper_scoped(f)
            or _is_fleet_scoped(f)
            or _is_serve_scoped(f)
        ):
            continue
        for node in ast.walk(rec.node):
            if not isinstance(node, ast.Call):
                continue
            parts = _attr_chain(node.func).split(".")
            leaf = parts[-1]
            if leaf in _INTEGRATOR_LEAVES and not (
                len(parts) > 1 and parts[-2] in _REGISTRY_MODULES
            ):
                yield _finding(
                    "GL026",
                    f,
                    node,
                    f"`{leaf}()` in hot function `{rec.qualname}` "
                    "names an integrator kernel directly — bypassing "
                    "the backend registry's capability flags, "
                    "selection plane, and dispatch census",
                    fix,
                )


CHECKERS = {
    "GL001": check_gl001,
    "GL003": check_gl003,
    "GL004": check_gl004,
    "GL005": check_gl005,
    "GL007": check_gl007,
    "GL009": check_gl009,
    "GL010": check_gl010,
    "GL012": check_gl012,
    "GL013": check_gl013,
    "GL014": check_gl014,
    "GL015": concurrency.check_gl015,
    "GL016": concurrency.check_gl016,
    "GL017": concurrency.check_gl017,
    "GL018": check_gl018,
    "GL019": dataflow.check_gl019,
    "GL020": dataflow.check_gl020,
    "GL021": dataflow.check_gl021,
    "GL022": dataflow.check_gl022,
    "GL023": check_gl023,
    "GL024": check_gl024,
    "GL025": check_gl025,
    "GL026": check_gl026,
}


def checkers(only: list[str] | None = None):
    if not only:
        return dict(CHECKERS)
    wanted = {c.strip().upper() for c in only}
    unknown = wanted - CHECKERS.keys()
    if unknown:
        raise SystemExit(f"graftlint: unknown rule(s): {', '.join(sorted(unknown))}")
    return {c: fn for c, fn in CHECKERS.items() if c in wanted}
