"""Lock discipline: static lock-acquisition graph + guarded-write audit
(the JAX package's rules, run over the port's per-data_dir managers,
WLM gate, batcher, capture gate and mesh).

Three rules:

* ``lock-order-cycle`` — every ``with <lock>:`` block and every
  ``<lock>.acquire()`` call is an acquisition site; acquiring B while
  holding A adds edge A→B.  Edges propagate interprocedurally through
  direct calls (``self.m()``, module functions, unique method names),
  so ``with self._cv: self._dispatch()`` charges _dispatch's
  acquisitions to _cv.  A cycle in the resulting digraph is a potential
  ABBA deadlock; instances are grouped lockdep-style by their
  *definition site* (``module.Class.attr``), so two instances of the
  same manager class count as one order class.
* ``unlocked-shared-write`` — a class that owns a lock
  (``self._mu = threading.Lock()`` in ``__init__``) is a *guarded
  class*; every attribute it ever writes under that lock is a *guarded
  field*; any other write to that field outside the lock (and outside
  ``__init__`` / helpers provably called only under the lock / the
  ``_locked`` naming convention) is the caps-memo race class of bug.
* ``raw-lock-acquire`` — a known threading lock acquired via bare
  ``.acquire()`` instead of ``with``: an exception between acquire and
  release leaks the lock (the 2PL ``LockManager.acquire`` protocol
  method is not a threading lock and is exempt by resolution, not by
  name).

Lock identity resolution (`LockIndex`):

* ``self.X = threading.Lock() | RLock() | Condition() | Semaphore()``
  → lock id ``module.Class.X``;
* ``self.X = threading.Condition(self.Y)`` → X *aliases* Y (the
  jobs-runner pattern where _cv wraps _lock — treating them as two
  locks would fabricate cycles);
* module-level ``X = threading.Lock()`` → ``module.X``;
* ``with obj.X:`` where X names a lock attr of exactly ONE known class
  resolves to that class's lock (ambiguous names stay untracked rather
  than guess);
* ``with f(...):`` where f is lock-factory-shaped (``*_lock``,
  ``lock_manager_for``-style names returning registry locks) →
  ``module.f()`` as one order class.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Finding, Module

_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore")
# reentrant kinds never self-deadlock on nested acquisition
_REENTRANT = ("RLock", "Condition", "Semaphore", "BoundedSemaphore")

_MUTATORS = frozenset({
    "append", "appendleft", "add", "clear", "discard", "extend",
    "insert", "pop", "popitem", "popleft", "remove", "setdefault",
    "update", "__setitem__", "__delitem__"})


def _lock_factory_shaped(name: str) -> bool:
    return (name.endswith("_lock") or name.endswith("_locks")
            or name.endswith("lock_for") or name.endswith("_mutex"))


def _threading_ctor(call: ast.expr) -> str | None:
    """'Lock' for threading.Lock(...) / Condition(...), else None."""
    if not isinstance(call, ast.Call):
        return None
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_CTORS and \
            isinstance(fn.value, ast.Name) and fn.value.id == "threading":
        return fn.attr
    if isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS:
        return fn.id
    return None


@dataclass
class LockDef:
    lock_id: str       # module.Class.attr | module.name | module.f()
    kind: str          # Lock / RLock / Condition / ... / factory
    module: str
    cls: str | None
    attr: str


@dataclass
class FuncInfo:
    key: tuple                      # (module, class|None, name)
    node: ast.AST
    relpath: str
    # (lock_id, line, held_tuple, via_with)
    acquisitions: list = field(default_factory=list)
    # (callee_key, line, held_tuple)
    calls: list = field(default_factory=list)
    # (attr, line, held_tuple) — writes to self.<attr>
    self_writes: list = field(default_factory=list)
    # raw .acquire() sites: (lock_id, line)
    raw_acquires: list = field(default_factory=list)


class LockIndex:
    def __init__(self, modules: list[Module]):
        self.defs: dict[str, LockDef] = {}
        self.aliases: dict[tuple, str] = {}   # (mod, cls, attr) → lock_id
        self.class_locks: dict[tuple, list[str]] = {}  # (mod,cls) → ids
        self.attr_owners: dict[str, set[str]] = {}     # attr → lock_ids
        self.module_locks: dict[tuple, str] = {}       # (mod,name) → id
        for m in modules:
            self._scan(m)

    def _scan(self, m: Module) -> None:
        for node in m.tree.body:
            # module-level: X = threading.Lock()
            if isinstance(node, ast.Assign) and \
                    _threading_ctor(node.value) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                lid = f"{m.name}.{name}"
                self.defs[lid] = LockDef(lid, _threading_ctor(node.value),
                                         m.name, None, name)
                self.module_locks[(m.name, name)] = lid
            if isinstance(node, ast.ClassDef):
                self._scan_class(m, node)

    def _scan_class(self, m: Module, cls: ast.ClassDef) -> None:
        # two passes so `self._cv = Condition(self._lock)` aliases even
        # when _lock is assigned later in source order (it never is, but
        # the index shouldn't depend on it)
        assigns: list[tuple[str, ast.Call]] = []
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Assign) and \
                        len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], ast.Attribute) and \
                        isinstance(stmt.targets[0].value, ast.Name) and \
                        stmt.targets[0].value.id == "self" and \
                        _threading_ctor(stmt.value):
                    assigns.append((stmt.targets[0].attr, stmt.value))
        direct = {}
        for attr, call in assigns:
            kind = _threading_ctor(call)
            if kind == "Condition" and call.args and \
                    isinstance(call.args[0], ast.Attribute) and \
                    isinstance(call.args[0].value, ast.Name) and \
                    call.args[0].value.id == "self":
                continue  # alias, second pass
            lid = f"{m.name}.{cls.name}.{attr}"
            self.defs[lid] = LockDef(lid, kind, m.name, cls.name, attr)
            direct[attr] = lid
        for attr, call in assigns:
            if attr in direct:
                continue
            wrapped = call.args[0].attr
            target = direct.get(wrapped)
            if target is None:
                lid = f"{m.name}.{cls.name}.{attr}"
                self.defs[lid] = LockDef(lid, "Condition", m.name,
                                         cls.name, attr)
                direct[attr] = lid
            else:
                self.aliases[(m.name, cls.name, attr)] = target
        key = (m.name, cls.name)
        self.class_locks[key] = sorted(set(direct.values()))
        for attr, lid in direct.items():
            self.attr_owners.setdefault(attr, set()).add(lid)
        for (mod, c, attr), lid in self.aliases.items():
            if (mod, c) == key:
                self.attr_owners.setdefault(attr, set()).add(lid)

    # -- resolution --------------------------------------------------------
    def resolve(self, expr: ast.expr, module: str,
                cls: str | None) -> str | None:
        """Lock id for an acquisition expression, or None (untracked)."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            recv, attr = expr.value.id, expr.attr
            if recv == "self" and cls is not None:
                lid = self.aliases.get((module, cls, attr))
                if lid:
                    return lid
                direct = f"{module}.{cls}.{attr}"
                if direct in self.defs:
                    return direct
            owners = self.attr_owners.get(attr, set())
            if len(owners) == 1:
                return next(iter(owners))
            return None
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Attribute):
            owners = self.attr_owners.get(expr.attr, set())
            if len(owners) == 1:
                return next(iter(owners))
            return None
        if isinstance(expr, ast.Name):
            return self.module_locks.get((module, expr.id))
        if isinstance(expr, ast.Call):
            fn = expr.func
            if isinstance(fn, ast.Attribute) and \
                    _lock_factory_shaped(fn.attr):
                return f"{module}.{fn.attr}()"
            if isinstance(fn, ast.Name) and _lock_factory_shaped(fn.id):
                return f"{module}.{fn.id}()"
        return None

    def kind_of(self, lock_id: str) -> str:
        d = self.defs.get(lock_id)
        return d.kind if d else "factory"


# -- per-function event extraction ------------------------------------------
class _FuncVisitor:
    """Walks ONE function body tracking the held-lock stack; nested
    function defs are recorded as separate functions (their bodies run
    later, under whatever locks their caller holds)."""

    def __init__(self, index: LockIndex, module: Module,
                 cls: str | None, info: FuncInfo,
                 collect: list[FuncInfo]):
        self.index = index
        self.module = module
        self.cls = cls
        self.info = info
        self.collect = collect
        self.held: list[str] = []

    def run(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    # -- statements --------------------------------------------------------
    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later under the CALLER's locks, not the
            # enclosing with-stack — track as its own function (the
            # `<name>` marker keeps it out of guarded-class membership)
            sub = FuncInfo((self.info.key[0], self.info.key[1],
                            f"<{self.info.key[2]}.{node.name}>"), node,
                           self.info.relpath)
            self.collect.append(sub)
            _FuncVisitor(self.index, self.module, self.cls, sub,
                         self.collect).run(node.body)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: list[str] = []
            for item in node.items:
                self._expr(item.context_expr)
                lid = self.index.resolve(item.context_expr,
                                         self.module.name, self.cls)
                if lid is not None:
                    self.info.acquisitions.append(
                        (lid, item.context_expr.lineno,
                         tuple(self.held), True))
                    self.held.append(lid)
                    acquired.append(lid)
                if item.optional_vars is not None:
                    self._expr(item.optional_vars)
            for stmt in node.body:
                self._stmt(stmt)
            for lid in reversed(acquired):
                self.held.remove(lid)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._write_target(t)
                self._expr(t)
            self._expr(node.value)
            return
        if isinstance(node, ast.AugAssign):
            self._write_target(node.target)
            self._expr(node.target)
            self._expr(node.value)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._write_target(node.target)
                self._expr(node.value)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._write_target(t)
                self._expr(t)
            return
        # compound statements: visit child statements with the SAME held
        # stack; expressions inside get scanned for calls
        for fname, value in ast.iter_fields(node):
            if isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        self._stmt(v)
                    elif isinstance(v, ast.expr):
                        self._expr(v)
                    elif isinstance(v, (ast.excepthandler, ast.match_case)):
                        for s in v.body:
                            self._stmt(s)
                        for fn2, v2 in ast.iter_fields(v):
                            if isinstance(v2, ast.expr):
                                self._expr(v2)
            elif isinstance(value, ast.expr):
                self._expr(value)

    def _write_target(self, t: ast.expr) -> None:
        # self.attr = / self.attr[k] = / del self.attr[k]
        base = t
        if isinstance(base, ast.Subscript):
            base = base.value
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and base.value.id == "self":
            self.info.self_writes.append(
                (base.attr, t.lineno, tuple(self.held)))

    # -- expressions -------------------------------------------------------
    def _expr(self, node: ast.expr | None) -> None:
        if node is None:
            return
        # manual traversal so Lambda subtrees can actually be PRUNED
        # (ast.walk cannot skip descendants): a lambda body runs later,
        # under whatever locks its eventual caller holds — charging its
        # calls/acquires to the current with-stack fabricates edges
        work = [node]
        while work:
            sub = work.pop()
            if isinstance(sub, ast.Lambda):
                continue
            work.extend(ast.iter_child_nodes(sub))
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            # mutator calls on self.<attr> count as writes
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS and \
                    isinstance(fn.value, ast.Attribute) and \
                    isinstance(fn.value.value, ast.Name) and \
                    fn.value.value.id == "self":
                self.info.self_writes.append(
                    (fn.value.attr, sub.lineno, tuple(self.held)))
            # raw .acquire() on a resolvable threading lock
            if isinstance(fn, ast.Attribute) and fn.attr == "acquire":
                lid = self.index.resolve(fn.value, self.module.name,
                                         self.cls)
                if lid is not None:
                    self.info.acquisitions.append(
                        (lid, sub.lineno, tuple(self.held), False))
                    self.info.raw_acquires.append((lid, sub.lineno))
            # call events for the interprocedural graph
            key = self._callee_key(fn)
            if key is not None:
                self.info.calls.append((key, sub.lineno,
                                        tuple(self.held)))

    def _callee_key(self, fn: ast.expr):
        if isinstance(fn, ast.Name):
            return ("name", fn.id)
        if isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                return ("self", fn.attr)
            return ("attr", fn.attr)
        return None


def _collect_functions(index: LockIndex,
                       modules: list[Module]) -> list[FuncInfo]:
    out: list[FuncInfo] = []
    for m in modules:
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FuncInfo((m.name, None, node.name), node, m.relpath)
                out.append(info)
                _FuncVisitor(index, m, None, info, out).run(node.body)
            elif isinstance(node, ast.ClassDef):
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        info = FuncInfo((m.name, node.name, fn.name),
                                        fn, m.relpath)
                        out.append(info)
                        _FuncVisitor(index, m, node.name, info,
                                     out).run(fn.body)
    return out


class _CallResolver:
    def __init__(self, funcs: list[FuncInfo]):
        self.by_key = {f.key: f for f in funcs}
        self.method_owners: dict[str, list[tuple]] = {}
        self.module_funcs: dict[tuple, tuple] = {}
        for f in funcs:
            mod, cls, name = f.key
            if cls is not None:
                self.method_owners.setdefault(name, []).append(f.key)
            else:
                self.module_funcs[(mod, name)] = f.key

    def resolve(self, key, caller: FuncInfo):
        kind, name = key
        mod, cls, _ = caller.key
        if kind == "self" and cls is not None:
            k = (mod, cls, name)
            if k in self.by_key:
                return k
            return None
        if kind == "name":
            return self.module_funcs.get((mod, name))
        if kind == "attr":
            owners = self.method_owners.get(name, [])
            if len(owners) == 1:
                return owners[0]
            return None
        return None


def _transitive_acquires(funcs: list[FuncInfo],
                         resolver: _CallResolver) -> dict[tuple, set]:
    """lock ids each function may acquire, directly or via callees
    (bounded fixpoint — the call graph is small and acyclic-ish)."""
    acq = {f.key: {a[0] for a in f.acquisitions} for f in funcs}
    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for f in funcs:
            cur = acq[f.key]
            before = len(cur)
            for key, _line, _held in f.calls:
                callee = resolver.resolve(key, f)
                if callee is not None:
                    cur |= acq[callee]
            if len(cur) != before:
                changed = True
    return acq


def _find_cycles(graph: dict[str, set[str]]) -> list[list[str]]:
    """Strongly connected components with >1 node (Tarjan, iterative),
    plus single nodes with a self-edge."""
    index_counter = [0]
    stack: list[str] = []
    lowlink: dict[str, int] = {}
    index: dict[str, int] = {}
    on_stack: dict[str, bool] = {}
    sccs: list[list[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = lowlink[v] = index_counter[0]
        index_counter[0] += 1
        stack.append(v)
        on_stack[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = lowlink[w] = index_counter[0]
                    index_counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif on_stack.get(w):
                    lowlink[node] = min(lowlink[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1 or node in graph.get(node, ()):
                    sccs.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


def check(modules: list[Module]) -> list[Finding]:
    index = LockIndex(modules)
    funcs = _collect_functions(index, modules)
    resolver = _CallResolver(funcs)
    acq = _transitive_acquires(funcs, resolver)
    findings: list[Finding] = []

    # -- edges + raw acquires ----------------------------------------------
    graph: dict[str, set[str]] = {}
    edge_sites: dict[tuple, tuple] = {}   # (a,b) → (relpath, line, ctx)

    def add_edge(a: str, b: str, relpath: str, line: int,
                 ctx: str) -> None:
        if a == b:
            return
        if b not in graph.setdefault(a, set()):
            graph[a].add(b)
            edge_sites[(a, b)] = (relpath, line, ctx)

    for f in funcs:
        ctx = f.key[2] if f.key[1] is None else f"{f.key[1]}.{f.key[2]}"
        for lid, line, held, via_with in f.acquisitions:
            for h in held:
                add_edge(h, lid, f.relpath, line, ctx)
            if held and held[-1] == lid and via_with and \
                    index.kind_of(lid) not in _REENTRANT:
                findings.append(Finding(
                    "lock-order-cycle", f.relpath, line,
                    f"non-reentrant lock {lid} re-acquired while "
                    "already held (self-deadlock)", ctx))
        for key, line, held in f.calls:
            if not held:
                continue
            callee = resolver.resolve(key, f)
            if callee is None:
                continue
            for lid in acq[callee]:
                for h in held:
                    add_edge(h, lid, f.relpath, line, ctx)
        for lid, line in f.raw_acquires:
            findings.append(Finding(
                "raw-lock-acquire", f.relpath, line,
                f"{lid} acquired via bare .acquire() — use a `with` "
                "block so exceptions cannot leak the lock", ctx))

    for cycle in _find_cycles(graph):
        members = set(cycle)
        sites = sorted(
            (f"{a}→{b} at {s[0]}:{s[1]}", s)
            for (a, b), s in edge_sites.items()
            if a in members and b in members and b in graph.get(a, ()))
        where = sites[0][1] if sites else ("", 0, "")
        findings.append(Finding(
            "lock-order-cycle", where[0], where[1],
            "lock-order cycle (potential ABBA deadlock): "
            + " ; ".join(s for s, _ in sites), where[2]))

    # -- unlocked-shared-write ---------------------------------------------
    findings += _check_guarded_writes(index, funcs)
    return findings


def _check_guarded_writes(index: LockIndex,
                          funcs: list[FuncInfo]) -> list[Finding]:
    findings: list[Finding] = []
    by_class: dict[tuple, list[FuncInfo]] = {}
    for f in funcs:
        mod, cls, _name = f.key
        if cls is not None and not f.key[2].startswith("<"):
            by_class.setdefault((mod, cls), []).append(f)
    for ckey, members in sorted(by_class.items()):
        class_locks = set(index.class_locks.get(ckey, ()))
        if not class_locks:
            continue
        lock_attrs = {index.defs[lid].attr for lid in class_locks} | {
            attr for (m, c, attr) in index.aliases if (m, c) == ckey}

        def holds(held: tuple) -> bool:
            return bool(set(held) & class_locks)

        # fixpoint: helper methods whose every intra-class call site
        # holds a class lock are lock-held throughout (the `_dispatch`
        # pattern); the `_locked` suffix declares it by convention
        locked_methods: set[str] = {
            f.key[2] for f in members if f.key[2].endswith("_locked")}
        for _ in range(10):
            call_sites: dict[str, list[bool]] = {}
            for f in members:
                caller_locked = f.key[2] in locked_methods
                for key, _line, held in f.calls:
                    if key[0] == "self":
                        call_sites.setdefault(key[1], []).append(
                            holds(held) or caller_locked)
            new = set(locked_methods)
            for f in members:
                name = f.key[2]
                sites = call_sites.get(name)
                if sites and all(sites):
                    new.add(name)
            if new == locked_methods:
                break
            locked_methods = new

        # guarded fields: written under a class lock at least once
        guarded: set[str] = set()
        for f in members:
            in_locked = f.key[2] in locked_methods
            for attr, _line, held in f.self_writes:
                if attr in lock_attrs:
                    continue
                if holds(held) or in_locked:
                    guarded.add(attr)
        for f in members:
            name = f.key[2]
            if name == "__init__" or name in locked_methods:
                continue
            ctx = f"{ckey[1]}.{name}"
            for attr, line, held in f.self_writes:
                if attr in guarded and not holds(held):
                    findings.append(Finding(
                        "unlocked-shared-write", f.relpath, line,
                        f"{ckey[1]}.{attr} is written under "
                        f"{sorted(class_locks)[0]} elsewhere but "
                        "written here without it", ctx))
    return findings
