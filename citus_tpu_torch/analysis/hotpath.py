"""CUDA hot-path hygiene: host syncs in the captured region, and rebuilds.

The port's counterpart of the JAX package's traced-function rules.
What a CUDA graph captures is ``PlanCompiler._dispatch``
(``executor/compiler.py``; ``executor/graphs.py`` records it between
``capture_begin`` and ``capture_end``) and every function it reaches
by direct calls — the *captured region*.  The region is found the way
``lockgraph.py`` walks calls: ``self.m()`` within the class, module
functions and names imported from other modules of the package,
``alias.f()`` through an imported module, and ``obj.m()`` when exactly
one class of ``executor/`` or ``ops/`` defines ``m``.  Four rules:

* ``host-sync-in-capture`` — inside the region: ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``
  / ``.synchronize()``; the ops whose output size depends on the data
  (``torch.nonzero`` / ``.nonzero()``, one-argument ``torch.where``,
  ``torch.unique``, ``torch.masked_select``, boolean-mask indexing
  where the mask is a comparison or a ``~`` / ``&`` / ``|`` of one);
  and ``int()`` / ``float()`` / ``bool()`` around an expression with a
  ``torch.`` call or a tensor reduction.  On the card a host sync
  during capture raises, and a value read at capture is baked into
  every replay.
* ``capture-python-branch`` — ``if`` / ``while`` / ``assert`` / a
  conditional expression on such an expression inside the region: the
  branch taken at capture is the one every replay takes.
* ``device-sync-in-loop`` — the same syncs inside a ``for`` / ``while``
  in ``executor/stream.py``, ``feed.py``, ``batch.py`` and
  ``scanpipe.py``: each iteration waits for the device, the overlap the
  pipelines exist to keep.  Designed sync points carry an inline
  ``# graftlint: ignore[device-sync-in-loop]`` with their reason.
* ``rebuild-in-loop`` — ``torch.cuda.CUDAGraph()`` or a kernel library
  build or load (``build_all``, ``ctypes.CDLL``) inside a loop in
  ``executor/`` or ``ops/``: the counterpart of ``jit-in-loop``.

Functions the region reaches only on paths that are never captured
(mesh plans, the stream, multi-pass) still count: their findings are
baselined with that reason, never rewritten in a way that changes
results.
"""

from __future__ import annotations

import ast

from .core import PKG, Finding, Module

HOT_PREFIXES = (f"{PKG}/executor/", f"{PKG}/ops/")
STREAM_MODULES = tuple(f"{PKG}/executor/{m}.py"
                       for m in ("stream", "feed", "batch", "scanpipe"))
# (module, class, function) of what a CUDA graph captures
CAPTURE_ROOTS = ((f"{PKG}.executor.compiler", "PlanCompiler", "_dispatch"),)

# host syncs, by method name (a call with no receiver check: a numpy
# array's .tolist() in the region is host work baked into a replay too)
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy", "synchronize")
# ops whose output size depends on the data
_DATA_SIZED = ("nonzero", "unique", "masked_select")
_REDUCTIONS = ("sum", "max", "min", "any", "all", "mean", "prod",
               "count_nonzero", "amax", "amin")
# torch calls that read metadata only: no sync
_META = frozenset({"is_tensor", "is_floating_point", "is_complex",
                   "is_available", "is_current_stream_capturing",
                   "device", "finfo", "iinfo", "promote_types",
                   "result_type", "get_default_dtype", "Size",
                   "current_stream", "current_device", "device_count",
                   "get_device_name", "get_device_properties"})
_REBUILDS = ("CUDAGraph", "build_all", "CDLL")
# method names too common to resolve by uniqueness (containers, strings,
# tensors): `x.get()` must not pull a manager's `get` into the region
_COMMON = frozenset({
    "get", "set", "append", "extend", "pop", "items", "keys", "values",
    "update", "add", "clear", "setdefault", "copy", "insert", "remove",
    "sort", "index", "count", "split", "join", "format", "replace",
    "strip", "startswith", "endswith", "lower", "upper", "to", "view",
    "reshape", "sum", "max", "min", "any", "all", "clone", "close",
    "run", "execute", "snapshot", "reset", "release", "acquire", "put",
    "record", "read", "write", "wait", "start", "stop", "fill_",
    "zero_", "__init__", "__call__", "__enter__", "__exit__"})


def _call_name(fn: ast.expr) -> str | None:
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _rooted_at_torch(expr: ast.expr) -> bool:
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return isinstance(expr, ast.Name) and expr.id == "torch"


def _is_torch_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        _rooted_at_torch(node.func) and node.func.attr not in _META


def _tensor_valued(expr: ast.expr) -> bool:
    """Whether `expr` holds a torch call or a tensor reduction."""
    for sub in ast.walk(expr):
        if _is_torch_call(sub):
            return True
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in _REDUCTIONS and \
                not _rooted_at_torch(sub.func):
            # x.sum() / x.any(): a reduction on a receiver (np.sum(...)
            # and torch.sum(...) are module calls, counted above)
            recv = sub.func.value
            if not (isinstance(recv, ast.Name)
                    and recv.id in ("np", "numpy", "math", "builtins")):
                return True
    return False


def _is_mask(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return True
    return isinstance(expr, ast.BinOp) and \
        isinstance(expr.op, (ast.BitAnd, ast.BitOr)) and \
        (_is_mask(expr.left) or _is_mask(expr.right))


def _sync_of(node: ast.AST) -> str | None:
    """How a host sync reads, else None."""
    if isinstance(node, ast.Call):
        fn = node.func
        name = _call_name(fn)
        if isinstance(fn, ast.Attribute):
            if name in _SYNC_METHODS and not node.args:
                return f".{name}()"
            if name in _DATA_SIZED:
                return (f"torch.{name}()" if _rooted_at_torch(fn)
                        else f".{name}()")
            if name == "where" and _rooted_at_torch(fn) and \
                    len(node.args) == 1 and not node.keywords:
                return "torch.where(cond)"
        if isinstance(fn, ast.Name) and name in ("int", "float", "bool") \
                and node.args and _tensor_valued(node.args[0]):
            return f"{name}() on a tensor expression"
    if isinstance(node, ast.Subscript) and \
            isinstance(node.ctx, ast.Load) and _is_mask(node.slice):
        return "boolean-mask indexing"
    return None


def _scoped(node: ast.AST, prefix: list[str]):
    """(node, qualname) over a function body, nested defs included."""
    stack = list(prefix)

    def walk(n):
        scoped = isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef))
        if scoped:
            stack.append(n.name)
        yield n, ".".join(stack)
        for child in ast.iter_child_nodes(n):
            yield from walk(child)
        if scoped:
            stack.pop()

    yield from walk(node)


# -- the captured region ----------------------------------------------------
class _Index:
    def __init__(self, modules: list[Module]):
        self.funcs: dict[tuple, tuple[ast.AST, Module]] = {}
        self.methods: dict[str, list[tuple]] = {}
        self.imports: dict[str, dict[str, tuple[str, str]]] = {}
        self.aliases: dict[str, dict[str, str]] = {}
        for m in modules:
            self._scan(m)

    def _scan(self, m: Module) -> None:
        hot = m.relpath.startswith(HOT_PREFIXES)
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs[(m.name, None, node.name)] = (node, m)
            elif isinstance(node, ast.ClassDef):
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        key = (m.name, node.name, fn.name)
                        self.funcs[key] = (fn, m)
                        if hot:
                            self.methods.setdefault(fn.name, []).append(
                                key)
        imports: dict[str, tuple[str, str]] = {}
        aliases: dict[str, str] = {}
        pkg = m.name.split(".")
        if not m.relpath.endswith("__init__.py"):
            pkg = pkg[:-1]
        for node in ast.walk(m.tree):
            if isinstance(node, ast.ImportFrom):
                base = pkg[:len(pkg) - node.level + 1] if node.level \
                    else []
                mod = ".".join(base + (node.module.split(".")
                                       if node.module else []))
                for a in node.names:
                    imports[a.asname or a.name] = (mod, a.name)
                    aliases[a.asname or a.name] = f"{mod}.{a.name}"
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        aliases[a.asname] = a.name
        self.imports[m.name] = imports
        self.aliases[m.name] = aliases

    def callees(self, key: tuple, node: ast.AST) -> list[tuple]:
        mod, cls, _name = key
        out = []
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            if isinstance(fn, ast.Name):
                k = (mod, None, fn.id)
                if k not in self.funcs and fn.id in self.imports[mod]:
                    src_mod, src_name = self.imports[mod][fn.id]
                    k = (src_mod, None, src_name)
                if k in self.funcs:
                    out.append(k)
            elif isinstance(fn, ast.Attribute):
                recv = fn.value
                if isinstance(recv, ast.Name) and recv.id == "self" and \
                        cls is not None and (mod, cls, fn.attr) in self.funcs:
                    out.append((mod, cls, fn.attr))
                    continue
                if isinstance(recv, ast.Name) and \
                        recv.id in self.aliases[mod]:
                    k = (self.aliases[mod][recv.id], None, fn.attr)
                    if k in self.funcs:
                        out.append(k)
                        continue
                owners = self.methods.get(fn.attr, [])
                if len(owners) == 1 and fn.attr not in _COMMON:
                    out.append(owners[0])
        return out


def captured_region(modules: list[Module]) -> dict[tuple, tuple]:
    """(module, class, function) → (node, Module) of every function the
    capture roots reach by direct calls, within executor/ and ops/."""
    index = _Index(modules)
    region: dict[tuple, tuple] = {}
    work = [k for k in CAPTURE_ROOTS if k in index.funcs]
    while work:
        key = work.pop()
        if key in region:
            continue
        node, mod = index.funcs[key]
        if not mod.relpath.startswith(HOT_PREFIXES):
            continue
        region[key] = (node, mod)
        work.extend(k for k in index.callees(key, node) if k not in region)
    return region


def _check_region(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    for (mod_name, cls, _name), (node, mod) in sorted(
            captured_region(modules).items(),
            key=lambda kv: (kv[1][1].relpath, kv[1][0].lineno)):
        for sub, ctx in _scoped(node, [cls] if cls else []):
            what = _sync_of(sub)
            if what is not None:
                findings.append(Finding(
                    "host-sync-in-capture", mod.relpath, sub.lineno,
                    f"{what} in the captured region (reached from "
                    "PlanCompiler._dispatch) — a host sync raises during "
                    "capture and a value read there is baked into every "
                    "replay", ctx))
            test = (sub.test if isinstance(sub, (ast.If, ast.While,
                                                 ast.Assert, ast.IfExp))
                    else None)
            if test is not None and _tensor_valued(test):
                kind = {ast.If: "if", ast.While: "while",
                        ast.Assert: "assert", ast.IfExp: "conditional "
                        "expression"}[type(sub)]
                findings.append(Finding(
                    "capture-python-branch", mod.relpath, sub.lineno,
                    f"Python `{kind}` on a tensor expression in the "
                    "captured region — the branch taken at capture is "
                    "the one every replay takes (use torch.where, or "
                    "decide on the host before the dispatch)", ctx))
    return findings


class _LoopVisitor(ast.NodeVisitor):
    """device-sync-in-loop and rebuild-in-loop over one module."""

    def __init__(self, mod: Module, findings: list[Finding]):
        self.mod = mod
        self.findings = findings
        self.stack: list[str] = []
        self.loop_depth = 0
        self.stream = mod.relpath in STREAM_MODULES

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(rule, self.mod.relpath, node.lineno,
                                     msg, ".".join(self.stack)))

    def _visit_scope(self, node) -> None:
        self.stack.append(node.name)
        outer = self.loop_depth
        self.loop_depth = 0  # loops don't span function boundaries
        self.generic_visit(node)
        self.loop_depth = outer
        self.stack.pop()

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_ClassDef = _visit_scope

    def _visit_loop(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def visit_Call(self, node: ast.Call) -> None:
        if self.loop_depth:
            name = _call_name(node.func)
            if name in _REBUILDS:
                self._flag("rebuild-in-loop", node,
                           f"{name}() inside a loop builds (or loads) "
                           "anew every iteration — hoist it out of the "
                           "loop or cache what it returns")
            if self.stream:
                what = _sync_of(node)
                if what is not None and "mask" not in what:
                    self._flag("device-sync-in-loop", node,
                               f"{what} inside a streaming loop waits "
                               "for the device every iteration, "
                               "serializing transfer and compute")
        self.generic_visit(node)


def check(modules: list[Module]) -> list[Finding]:
    findings = _check_region(modules)
    for mod in modules:
        if mod.relpath.startswith(HOT_PREFIXES):
            _LoopVisitor(mod, findings).visit(mod.tree)
    return findings
