"""
graftrace: a static thread-role model over the linted file set, plus the
three concurrency rules built on it (GL015-GL017).

The serving stack is deliberately concurrent — FleetService's scheduler
loop, HTTP handler threads, the stepper's worker thread, weakref/atexit
finalizers, and signal handlers all share mutable objects — and its
correctness rests on a single-writer discipline ("handler threads never
touch fleet state") that used to live only in review comments.  This
module makes the discipline machine-checked:

1. **Entry points per role.**  ``threading.Thread(target=...)`` calls
   (role = the thread's constant ``name=``, or the target's ``owner=``
   declaration), ``do_GET``/``do_POST``-style HTTP handler methods
   (role ``http-handler``), ``weakref.finalize``/``atexit.register``
   targets (role ``finalizer``), ``signal.signal`` handlers (role
   ``signal-handler``), and any def carrying an explicit
   ``# graftlint: owner=<role>`` declaration.
2. **Role propagation.**  Roles flow along the call graph; a function
   with an explicit ``owner=`` keeps exactly that role.  Functions that
   are reachable only from ``__init__``-like constructors are
   *init-only* (construction happens-before publication) and carry no
   role; everything else un-roled is *ambient* — callable from any
   thread, the main thread included.
3. **Attribute write/read sites per role, with lock tracking.**  Lock
   scopes come from ``with self._lock:`` blocks (attribute locks typed
   by their ``threading.Lock()``-style constructor) and module-level
   lock names.  Private helpers inherit the intersection of the locks
   their call sites hold, so a ``_flush_locked`` convention is credited
   statically.  Objects handed to a finalizer as extra args are write
   sites from the ``finalizer`` role — and a Lock-typed extra arg
   *grants* that lock to the finalizer's writes, which is exactly the
   safe registration shape.

The rules on top:

- **GL015 cross-thread-write** — a mutable attribute written from two
  or more roles with no common lock statically held by every writer.
- **GL016 lock-order-inversion** — two locks acquired in opposite
  nesting orders anywhere in the linted set.
- **GL017 queue-bypass** — serve-scoped handler-role code mutating
  scheduler/warden/lane state directly instead of submitting a command
  through the service queue (the single-writer serve contract).

Sanctioned sharing is declared, not waived silently: a
``# graftlint: owner=<role>`` on an attribute assignment names the one
role allowed to write it, and the runtime half (`analysis.ownership`)
asserts the same roles under ``MAGICSOUP_DEBUG_OWNERSHIP=1``.

Pure stdlib (ast only), like the rest of graftlint.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from magicsoup_tpu_torch.analysis.engine import Finding

AMBIENT = "ambient"

# constructors reached only before the object is published
INIT_NAMES = {"__init__", "__new__", "__post_init__", "__setstate__"}

# attribute types that synchronize internally — writes through them are
# exempt from GL015 (that is their whole job)
THREAD_SAFE_CTORS = {
    "Event",
    "Lock",
    "RLock",
    "Condition",
    "Semaphore",
    "BoundedSemaphore",
    "Barrier",
    "Queue",
    "SimpleQueue",
    "LifoQueue",
    "PriorityQueue",
}
# the subset usable as a `with` lock scope
LOCK_CTORS = {"Lock", "RLock", "Condition"}

# method names that mutate their receiver in place
MUTATORS = {
    "append",
    "appendleft",
    "add",
    "clear",
    "close",
    "discard",
    "extend",
    "flush",
    "insert",
    "pop",
    "popitem",
    "popleft",
    "put",
    "put_nowait",
    "remove",
    "reverse",
    "set",
    "set_exception",
    "set_result",
    "setdefault",
    "sort",
    "truncate",
    "update",
    "write",
    "writelines",
}

# fleet-state attribute segments the serve handlers must never touch
# directly — commands go through FleetService.submit()
SERVE_STATE = {"scheduler", "warden", "lane", "lanes"}

HANDLER_DEF_RE = re.compile(r"^do_[A-Z]+$")

RULE_INFO = {
    "GL015": (
        "cross-thread-write",
        "a mutable attribute written from two or more thread roles "
        "with no common lock statically held by every writer — the "
        "interleaving is a data race even when each write looks atomic "
        "on its own line",
    ),
    "GL016": (
        "lock-order-inversion",
        "two locks acquired in opposite nesting orders in the linted "
        "set — two threads taking the two paths concurrently deadlock, "
        "and nothing times out because both sides are 'about to' "
        "release",
    ),
    "GL017": (
        "queue-bypass",
        "serve-scoped handler-role code reaching into scheduler/"
        "warden/lane state directly — the serving layer is "
        "single-writer by contract; every mutation must be submitted "
        "as a command and applied by the scheduler loop",
    ),
}


def _chain_parts(node: ast.expr) -> list[str]:
    """``self.service.scheduler.admit`` -> ["self","service","scheduler",
    "admit"]; empty when the chain is not rooted at a plain Name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return []
    parts.append(node.id)
    return list(reversed(parts))


def _self_attr(node: ast.expr) -> str | None:
    """First attribute off ``self`` in a chain, else None."""
    parts = _chain_parts(node)
    if len(parts) >= 2 and parts[0] == "self":
        return parts[1]
    return None


def _ctor_name(value: ast.expr) -> str | None:
    """``threading.Lock()`` / ``Queue()`` -> the constructor leaf name."""
    if not isinstance(value, ast.Call):
        return None
    func = value.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


@dataclass(frozen=True)
class WriteSite:
    rel: str
    cls: str
    attr: str
    roles: frozenset
    held: frozenset
    line: int
    col: int


@dataclass(frozen=True)
class ReadSite:
    rel: str
    cls: str
    attr: str
    roles: frozenset
    line: int


@dataclass
class _RawEvent:
    func: tuple
    cls: str
    attr: str
    held: frozenset
    line: int
    col: int
    escape_role: str | None = None  # set for finalizer-escaped objects
    role_override: str | None = None  # writes inside a nested handler class


class ThreadModel:
    """Thread roles, per-role attribute access sites, and lock orders
    for one linted file set.  Built once per analyze() and shared by
    the GL015/GL016/GL017 checkers via ``Context.model``."""

    def __init__(self, files: list, graph):
        self.files = list(files)
        self.graph = graph
        # role machinery
        self.entries: dict[tuple, set[str]] = {}
        self.explicit: dict[tuple, str] = {}
        self.roles: dict[tuple, frozenset] = {}
        self.init_only: set[tuple] = set()
        # per-class attribute facts
        self.attr_ctors: dict[tuple, set[str]] = {}  # (rel,cls,attr)->ctors
        self.declared: dict[tuple, str] = {}  # (rel,cls,attr)->owner role
        self.module_locks: dict[str, set[str]] = {}  # rel -> lock names
        # access sites (materialized after role/lock resolution)
        self.writes: list[WriteSite] = []
        self.reads: list[ReadSite] = []
        self.init_writes: list[_RawEvent] = []
        # lock-order facts: (held, acquired) -> first (rel, line, col)
        self.lock_pairs: dict[tuple, tuple] = {}
        # scratch collected by the body scan
        self._raw_writes: list[_RawEvent] = []
        self._raw_reads: list[tuple] = []
        self._raw_acqs: list[tuple] = []  # (func, held, lock, rel, ln, col)
        self._call_sites: dict[tuple, list[tuple]] = {}
        self._eff: dict[tuple, frozenset] = {}

        self._scan_attr_types()
        self._scan_bodies()
        self._propagate_roles()
        self._compute_init_only()
        self._compute_effective_locks()
        self._materialize()

    # ---------------------------------------------------- type facts
    def _scan_attr_types(self) -> None:
        for f in self.files:
            locks: set[str] = set()
            for node in f.tree.body:
                if isinstance(node, ast.Assign):
                    ctor = _ctor_name(node.value)
                    if ctor in LOCK_CTORS:
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                locks.add(tgt.id)
            self.module_locks[f.rel] = locks
        for (rel, qualname), rec in self.graph.functions.items():
            cls = self._cls_of(qualname)
            for node in ast.walk(rec.node):
                if not isinstance(node, ast.Assign):
                    continue
                ctor = _ctor_name(node.value)
                if ctor is None:
                    continue
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is not None:
                        self.attr_ctors.setdefault(
                            (rel, cls, attr), set()
                        ).add(ctor)

    def attr_is_threadsafe(self, rel: str, cls: str, attr: str) -> bool:
        ctors = self.attr_ctors.get((rel, cls, attr), ())
        return bool(THREAD_SAFE_CTORS.intersection(ctors))

    def _attr_is_lock(self, rel: str, cls: str, attr: str) -> bool:
        ctors = self.attr_ctors.get((rel, cls, attr), ())
        return bool(LOCK_CTORS.intersection(ctors))

    @staticmethod
    def _cls_of(qualname: str) -> str:
        if "." in qualname:
            return qualname.rsplit(".", 1)[0]
        return f"<{qualname}>"

    # ---------------------------------------------------- body scan
    def _scan_bodies(self) -> None:
        for key, rec in self.graph.functions.items():
            f = rec.file
            cls = self._cls_of(rec.qualname)
            owner = self._def_owner(f, rec.node)
            if owner is not None:
                self.explicit[key] = owner
            if self._is_handler_record(rec.node):
                self.entries.setdefault(key, set()).add("http-handler")
            body = getattr(rec.node, "body", [])
            self._visit_stmts(key, f, cls, body, frozenset())

    @staticmethod
    def _def_owner(f, node) -> str | None:
        lines = [node.lineno] + [d.lineno for d in node.decorator_list]
        for ln in lines:
            owner = f.owners.get(ln)
            if owner is not None:
                return owner
        return None

    @staticmethod
    def _is_handler_record(node) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if HANDLER_DEF_RE.match(sub.name):
                    return True
        return False

    def _visit_stmts(
        self, key, f, cls, stmts, held: frozenset, override: str | None = None
    ) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def runs later, on its caller's thread, with
                # no locks carried over from the defining scope
                for dec in st.decorator_list:
                    self._visit_expr(key, f, cls, dec, held, st, override)
                self._visit_stmts(key, f, cls, st.body, frozenset(), override)
            elif isinstance(st, ast.ClassDef):
                # `self` inside a nested class belongs to that class's
                # instances, not the enclosing function — when the class
                # is an HTTP handler its methods run on handler threads,
                # whatever thread defined the class
                ov = override
                if self._is_handler_record(st):
                    ov = "http-handler"
                self._visit_stmts(key, f, cls, st.body, held, ov)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                inner = held
                for item in st.items:
                    self._visit_expr(
                        key, f, cls, item.context_expr, inner, st, override
                    )
                    lid = self._lock_id(f, cls, item.context_expr)
                    if lid is not None:
                        self._raw_acqs.append(
                            (
                                key,
                                inner,
                                lid,
                                f.rel,
                                item.context_expr.lineno,
                                item.context_expr.col_offset,
                            )
                        )
                        inner = inner | {lid}
                self._visit_stmts(key, f, cls, st.body, inner, override)
            else:
                self._visit_stmt_events(key, f, cls, st, held, override)
                for name in ("body", "orelse", "finalbody"):
                    sub = getattr(st, name, None)
                    if sub:
                        self._visit_stmts(key, f, cls, sub, held, override)
                for handler in getattr(st, "handlers", []):
                    self._visit_stmts(key, f, cls, handler.body, held, override)

    def _visit_stmt_events(self, key, f, cls, st, held, override=None) -> None:
        # write targets first (Store/Del contexts)
        if isinstance(st, ast.Assign):
            for tgt in st.targets:
                self._record_target(key, f, cls, tgt, held, st, override)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            self._record_target(key, f, cls, st.target, held, st, override)
        elif isinstance(st, ast.Delete):
            for tgt in st.targets:
                self._record_target(key, f, cls, tgt, held, st, override)
        # then every expression hanging off this statement (skipping
        # nested statement lists, which the caller recurses into)
        for fname, value in ast.iter_fields(st):
            if fname in ("body", "orelse", "finalbody", "handlers"):
                continue
            for expr in self._exprs(value):
                self._visit_expr(key, f, cls, expr, held, st, override)

    @staticmethod
    def _exprs(value):
        if isinstance(value, ast.expr):
            yield value
        elif isinstance(value, list):
            for v in value:
                if isinstance(v, ast.expr):
                    yield v

    def _record_target(self, key, f, cls, tgt, held, st, override=None) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._record_target(key, f, cls, el, held, st, override)
            return
        if isinstance(tgt, (ast.Subscript, ast.Starred)):
            self._record_target_inner(key, f, cls, tgt.value, held, st, override)
            return
        self._record_target_inner(key, f, cls, tgt, held, st, override)

    def _record_target_inner(
        self, key, f, cls, expr, held, st, override=None
    ) -> None:
        attr = _self_attr(expr)
        if attr is None:
            return
        self._raw_writes.append(
            _RawEvent(
                func=key,
                cls=cls,
                attr=attr,
                held=held,
                line=st.lineno,
                col=st.col_offset,
                role_override=override,
            )
        )
        owner = f.owners.get(st.lineno)
        if owner is not None:
            self.declared[(f.rel, cls, attr)] = owner

    def _visit_expr(self, key, f, cls, expr, held, st, override=None) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._record_call(key, f, cls, node, held, override)
            elif isinstance(node, ast.Attribute) and isinstance(
                getattr(node, "ctx", None), ast.Load
            ):
                attr = _self_attr(node)
                if attr is not None:
                    self._raw_reads.append(
                        (key, f.rel, cls, attr, node.lineno)
                    )

    def _record_call(self, key, f, cls, call: ast.Call, held, override=None) -> None:
        rec_cls = cls if not cls.startswith("<") else None
        # call-graph edge with the locks held at this call site, for the
        # effective-lock propagation into private helpers
        tgt = self.graph.resolve(f, rec_cls, call.func)
        if tgt is not None:
            self._call_sites.setdefault(tgt, []).append((key, held))
        # mutator method on a self attribute == write to that attribute
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in MUTATORS
        ):
            attr = _self_attr(call.func.value)
            if attr is not None:
                self._raw_writes.append(
                    _RawEvent(
                        func=key,
                        cls=cls,
                        attr=attr,
                        held=held,
                        line=call.lineno,
                        col=call.col_offset,
                        role_override=override,
                    )
                )
        # thread/finalizer/signal registrations mint role entries
        self._record_registration(key, f, rec_cls, cls, call)

    # ------------------------------------------------- registrations
    def _callee_is(self, f, func, module: str, name: str) -> bool:
        if (
            isinstance(func, ast.Attribute)
            and func.attr == name
            and isinstance(func.value, ast.Name)
            and func.value.id == module
        ):
            return True
        if isinstance(func, ast.Name):
            imported = self.graph._imports.get(f.rel, {}).get(func.id)
            return imported == (module, name)
        return False

    def _record_registration(self, key, f, rec_cls, cls, call) -> None:
        func = call.func
        is_thread = (
            isinstance(func, ast.Attribute) and func.attr == "Thread"
        ) or (isinstance(func, ast.Name) and func.id == "Thread")
        if is_thread:
            target = None
            name_const = None
            for kw in call.keywords:
                if kw.arg == "target":
                    target = self.graph.resolve_ref(f, rec_cls, kw.value)
                elif kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    if isinstance(kw.value.value, str):
                        name_const = kw.value.value
            if target is not None:
                role = self._target_owner(target) or name_const
                role = role or f"thread:{target[1]}"
                self.entries.setdefault(target, set()).add(role)
            return
        escaped = None
        if self._callee_is(f, func, "weakref", "finalize"):
            if len(call.args) >= 2:
                target = self.graph.resolve_ref(f, rec_cls, call.args[1])
                if target is not None:
                    self.entries.setdefault(target, set()).add("finalizer")
                escaped = call.args[2:]
        elif self._callee_is(f, func, "atexit", "register"):
            if call.args:
                target = self.graph.resolve_ref(f, rec_cls, call.args[0])
                if target is not None:
                    self.entries.setdefault(target, set()).add("finalizer")
                escaped = call.args[1:]
        elif self._callee_is(f, func, "signal", "signal"):
            if len(call.args) >= 2:
                target = self.graph.resolve_ref(f, rec_cls, call.args[1])
                if target is not None:
                    self.entries.setdefault(target, set()).add(
                        "signal-handler"
                    )
            return
        if not escaped:
            return
        # extra finalizer args escape to the finalizer thread: each one
        # is a write site from the `finalizer` role.  A Lock-typed arg
        # instead GRANTS that lock to the finalizer's writes — passing
        # the guarding lock alongside the guarded state is the safe
        # registration shape.
        attrs = [a for a in (map(_self_attr, escaped)) if a is not None]
        granted = frozenset(
            f"{f.rel}::{cls}.{a}"
            for a in attrs
            if self._attr_is_lock(f.rel, cls, a)
        )
        for a in attrs:
            if self._attr_is_lock(f.rel, cls, a):
                continue
            self._raw_writes.append(
                _RawEvent(
                    func=key,
                    cls=cls,
                    attr=a,
                    held=granted,
                    line=call.lineno,
                    col=call.col_offset,
                    escape_role="finalizer",
                )
            )

    def _target_owner(self, target) -> str | None:
        rec = self.graph.functions.get(target)
        if rec is None:
            return None
        return self._def_owner(rec.file, rec.node)

    # ------------------------------------------------------- locks
    def _lock_id(self, f, cls, expr) -> str | None:
        attr = _self_attr(expr)
        if attr is not None and self._attr_is_lock(f.rel, cls, attr):
            return f"{f.rel}::{cls}.{attr}"
        if isinstance(expr, ast.Name) and expr.id in self.module_locks.get(
            f.rel, ()
        ):
            return f"{f.rel}::{expr.id}"
        return None

    # ------------------------------------------------------- roles
    def _propagate_roles(self) -> None:
        roles: dict[tuple, set[str]] = {}
        for key, role in self.explicit.items():
            roles[key] = {role}
        for key, rs in self.entries.items():
            if key in self.explicit:
                continue
            roles.setdefault(key, set()).update(rs)
        stack = list(roles)
        while stack:
            key = stack.pop()
            rec = self.graph.functions.get(key)
            if rec is None:
                continue
            for callee in rec.calls:
                if callee in self.explicit or callee == key:
                    continue
                have = roles.setdefault(callee, set())
                if not roles[key] <= have:
                    have.update(roles[key])
                    stack.append(callee)
        self.roles = {k: frozenset(v) for k, v in roles.items() if v}

    def _compute_init_only(self) -> None:
        callers: dict[tuple, set[tuple]] = {}
        for key, rec in self.graph.functions.items():
            for callee in rec.calls:
                callers.setdefault(callee, set()).add(key)

        def leaf(key) -> str:
            return key[1].rsplit(".", 1)[-1]

        # greatest fixpoint: assume every candidate is init-only, then
        # evict anything with a non-init caller (or no callers at all)
        init = {
            key
            for key in self.graph.functions
            if key not in self.roles
            and key not in self.entries
            and (leaf(key) in INIT_NAMES or callers.get(key))
        }
        changed = True
        while changed:
            changed = False
            for key in list(init):
                if leaf(key) in INIT_NAMES:
                    continue
                who = callers.get(key)
                if not who or any(c not in init for c in who):
                    init.discard(key)
                    changed = True
        self.init_only = init

    def role_of(self, key) -> frozenset:
        """Final role set for a function: explicit/propagated roles, or
        {ambient} when callable from anywhere, or empty when the
        function only runs during construction."""
        if key in self.roles:
            return self.roles[key]
        if key in self.init_only:
            return frozenset()
        return frozenset({AMBIENT})

    # --------------------------------------------- effective locks
    def _compute_effective_locks(self) -> None:
        """Locks a private helper can bank on: the intersection over its
        call sites of (locks held there ∪ the caller's own effective
        set).  Monotone-increasing fixpoint from the empty set."""
        def eligible(key) -> bool:
            name = key[1].rsplit(".", 1)[-1]
            return (
                name.startswith("_")
                and not name.startswith("__")
                and key not in self.entries
                and key in self._call_sites
            )

        eff: dict[tuple, frozenset] = {}
        for _ in range(len(self.graph.functions) + 1):
            changed = False
            for key in self._call_sites:
                if not eligible(key):
                    continue
                sets = [
                    held | eff.get(caller, frozenset())
                    for caller, held in self._call_sites[key]
                ]
                new = frozenset.intersection(*sets) if sets else frozenset()
                if eff.get(key, frozenset()) != new:
                    eff[key] = new
                    changed = True
            if not changed:
                break
        self._eff = eff

    # --------------------------------------------------- finalize
    def _materialize(self) -> None:
        for ev in self._raw_writes:
            if ev.escape_role is not None:
                # the finalizer runs later: only explicitly granted
                # locks count, never the registration site's scope
                self.writes.append(
                    WriteSite(
                        rel=ev.func[0],
                        cls=ev.cls,
                        attr=ev.attr,
                        roles=frozenset({ev.escape_role}),
                        held=ev.held,
                        line=ev.line,
                        col=ev.col,
                    )
                )
                continue
            if ev.role_override is not None:
                self.writes.append(
                    WriteSite(
                        rel=ev.func[0],
                        cls=ev.cls,
                        attr=ev.attr,
                        roles=frozenset({ev.role_override}),
                        held=ev.held,
                        line=ev.line,
                        col=ev.col,
                    )
                )
                continue
            if ev.func in self.init_only:
                self.init_writes.append(ev)
                continue
            roles = self.role_of(ev.func)
            if not roles:
                self.init_writes.append(ev)
                continue
            self.writes.append(
                WriteSite(
                    rel=ev.func[0],
                    cls=ev.cls,
                    attr=ev.attr,
                    roles=roles,
                    held=ev.held | self._eff.get(ev.func, frozenset()),
                    line=ev.line,
                    col=ev.col,
                )
            )
        for key, rel, cls, attr, line in self._raw_reads:
            roles = self.role_of(key)
            if roles:
                self.reads.append(
                    ReadSite(
                        rel=rel, cls=cls, attr=attr, roles=roles, line=line
                    )
                )
        for key, held, lock, rel, line, col in self._raw_acqs:
            full = held | self._eff.get(key, frozenset())
            for h in full:
                if h == lock:
                    continue
                site = (rel, line, col)
                prev = self.lock_pairs.get((h, lock))
                if prev is None or site < prev:
                    self.lock_pairs[(h, lock)] = site


def _model(ctx) -> ThreadModel:
    if getattr(ctx, "model", None) is None:
        ctx.model = ThreadModel(ctx.files, ctx.graph)
    return ctx.model


def _short(lock_id: str) -> str:
    return lock_id.rsplit("::", 1)[-1]


# ------------------------------------------------------------- GL015
def check_gl015(ctx):
    """Cross-thread writes.  For every (class, attribute) pair, collect
    the write sites with their roles and statically-held locks; flag
    when two or more roles write with no single lock common to every
    writer.  Attributes backed by internally-synchronized types
    (Event/Lock/Queue/...) are exempt, init-only writes are invisible
    (construction happens-before publication), and a
    ``# graftlint: owner=<role>`` declaration on an assignment narrows
    the check to "no role other than the declared owner writes this"
    (ambient setup writes stay allowed — binding happens at publication).
    """
    model = _model(ctx)
    groups: dict[tuple, list[WriteSite]] = {}
    for w in model.writes:
        groups.setdefault((w.rel, w.cls, w.attr), []).append(w)
    for (rel, cls, attr), sites in sorted(groups.items()):
        if model.attr_is_threadsafe(rel, cls, attr):
            continue
        declared = model.declared.get((rel, cls, attr))
        if declared is not None:
            for w in sorted(sites, key=lambda s: (s.line, s.col)):
                foreign = w.roles - {declared, AMBIENT}
                if foreign:
                    yield Finding(
                        path=rel,
                        line=w.line,
                        col=w.col + 1,
                        rule="GL015",
                        name=RULE_INFO["GL015"][0],
                        message=(
                            f"`{cls}.{attr}` is owned by role "
                            f"`{declared}` but written from "
                            f"{sorted(foreign)}"
                        ),
                        fixit=(
                            "route the mutation through the owning "
                            "thread (e.g. a command queue), or move the "
                            "`# graftlint: owner=` declaration if "
                            "ownership really changed"
                        ),
                    )
            continue
        roles = frozenset().union(*(w.roles for w in sites))
        if len(roles) < 2:
            continue
        common = frozenset.intersection(*(w.held for w in sites))
        if common:
            continue
        keyed = sorted(sites, key=lambda s: (s.line, s.col))
        threaded = [w for w in keyed if w.roles != frozenset({AMBIENT})]
        site = (threaded or keyed)[0]
        yield Finding(
            path=rel,
            line=site.line,
            col=site.col + 1,
            rule="GL015",
            name=RULE_INFO["GL015"][0],
            message=(
                f"`{cls}.{attr}` is written from roles "
                f"{sorted(roles)} with no common lock held at every "
                "write site"
            ),
            fixit=(
                "guard every writer with one shared lock (`with "
                "self._lock:`), route writes through the owning "
                "thread's queue, or declare sanctioned ownership with "
                "`# graftlint: owner=<role>`"
            ),
        )


# ------------------------------------------------------------- GL016
def check_gl016(ctx):
    """Lock-order inversions.  Every ``with`` lock acquisition records
    the ordered pairs (already-held, newly-acquired), with held sets
    including the locks private helpers inherit from their call sites.
    A pair acquired in both directions anywhere in the linted set is a
    deadlock waiting for its first concurrent execution; one finding
    per unordered pair, reported at the later acquisition site."""
    model = _model(ctx)
    seen: set[frozenset] = set()
    for (a, b), site in sorted(model.lock_pairs.items()):
        if a == b:
            continue
        other = model.lock_pairs.get((b, a))
        if other is None:
            continue
        pair = frozenset((a, b))
        if pair in seen:
            continue
        seen.add(pair)
        first, second = sorted([site, other])
        rel, line, col = second
        yield Finding(
            path=rel,
            line=line,
            col=col + 1,
            rule="GL016",
            name=RULE_INFO["GL016"][0],
            message=(
                f"lock `{_short(a)}` and lock `{_short(b)}` are "
                f"acquired in opposite orders (other order at "
                f"{first[0]}:{first[1]}) — concurrent callers deadlock"
            ),
            fixit=(
                "pick one global acquisition order for the two locks "
                "and restructure the later site to follow it (or "
                "collapse them into a single lock)"
            ),
        )


# ------------------------------------------------------------- GL017
def check_gl017(ctx):
    """Queue bypass.  In serve-scoped modules, functions carrying the
    ``http-handler`` role may read health snapshots and submit
    commands, but never call into or assign through
    scheduler/warden/lane state: the scheduler loop is the single
    writer, and a handler-side mutation races every tenant at once."""
    from magicsoup_tpu_torch.analysis import rules as rules_mod

    model = _model(ctx)
    fix = (
        "submit a command through the service queue "
        "(`service.submit(name, payload)`) and let the scheduler loop "
        "apply it; handlers may only read the published health snapshot"
    )
    for key, rec in sorted(ctx.graph.functions.items()):
        roles = model.roles.get(key, frozenset())
        if "http-handler" not in roles:
            continue
        f = rec.file
        if not rules_mod._is_serve_scoped(f):
            continue
        for node in ast.walk(rec.node):
            if isinstance(node, ast.Call):
                parts = _chain_parts(node.func)
                hit = set(parts[1:-1]) & SERVE_STATE
                if len(parts) >= 3 and hit:
                    yield Finding(
                        path=f.rel,
                        line=node.lineno,
                        col=node.col_offset + 1,
                        rule="GL017",
                        name=RULE_INFO["GL017"][0],
                        message=(
                            f"handler-role code calls "
                            f"`{'.'.join(parts)}` — mutating "
                            f"{sorted(hit)[0]} state directly bypasses "
                            "the single-writer command queue"
                        ),
                        fixit=fix,
                    )
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = (
                    node.targets
                    if isinstance(node, (ast.Assign, ast.Delete))
                    else [node.target]
                )
                for tgt in targets:
                    expr = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                    parts = _chain_parts(expr)
                    hit = set(parts[1:]) & SERVE_STATE
                    if len(parts) >= 2 and hit:
                        yield Finding(
                            path=f.rel,
                            line=node.lineno,
                            col=node.col_offset + 1,
                            rule="GL017",
                            name=RULE_INFO["GL017"][0],
                            message=(
                                f"handler-role code writes through "
                                f"`{'.'.join(parts)}` — "
                                f"{sorted(hit)[0]} state belongs to "
                                "the scheduler loop"
                            ),
                            fixit=fix,
                        )
