"""Error/resource discipline: exception swallowing and thread ownership.

* ``bare-except`` — ``except:`` catches SystemExit/KeyboardInterrupt
  and the sanitizer's violations; always name the class.
* ``swallowed-base-exception`` — ``except BaseException`` whose body
  never re-raises: cancellation (StatementTimeout / QueryCanceled ride
  the exception channel) silently dies here.
* ``swallowed-fault-seam`` — a broad handler (``Exception`` or wider)
  that swallows (no ``raise`` in its body) around a ``try`` block that
  contains a ``fault_point(...)`` seam: injected faults and the
  cooperative cancellation check inside the seam would be eaten, which
  breaks both the chaos-soak invariant (clean answer OR clean error)
  and statement timeouts.
* ``silent-exception`` — ``except Exception: pass`` (body is only
  pass/continue): best-effort code must narrow to the classes it
  actually expects (OSError, ValueError, ...) or justify itself in the
  baseline; "ignore everything" has already hidden real bugs here.
* ``unowned-thread`` — ``threading.Thread(...)`` without
  ``daemon=True`` and without a reachable ``.join()`` in the same
  function: a non-daemon thread nobody joins keeps the process alive
  after the session closes.
* ``raw-durable-write`` — ``os.replace`` / ``os.fsync`` / ``open``
  with a writable mode anywhere in ``citus_tpu_torch/`` outside the
  ``utils/io`` durable-write seam (and its crash shim): a writer that
  bypasses the seam silently loses the tmp+fsync+rename+dir-fsync
  discipline, the embedded checksums AND the power-cut torture
  harness's interception point.  Genuinely non-durable writes (build
  artifacts, lint baselines) justify themselves inline or in the
  baseline.
* ``raw-device-placement`` — a host→device transfer anywhere in
  ``citus_tpu_torch/`` outside the ``executor/hbm`` accounted-placement
  seam (``place``, ``place_tracked``, ``place_sharded_slices*``) and the
  ``distributed/mesh`` primitives it drives (``put_sharded*``,
  ``put_replicated``): a placement that bypasses the accountant is
  invisible to the measured device-memory ledger, the OOM
  classification that feeds the degradation ladder, and the MemSim
  torture harness's interception point.  A transfer is ``.cuda()``,
  ``.to(<device>)`` (a ``device=`` keyword, a ``"cuda…"`` string, a
  ``torch.device(...)`` call, a ``devices[i]`` subscript, or a name
  or attribute spelled ``…device``), ``torch.as_tensor`` /
  ``torch.tensor`` with a ``device=``, or a call of the mesh's
  ``put_sharded*`` / ``put_replicated``.  An allocation on a device
  (``torch.empty(..., device=x.device)``) is not a transfer, and a
  device→device move through a local name (``.to(home)``) is not seen.
* ``mesh-seam`` — a transfer aimed at one mesh position's device (a
  ``devices[i]`` subscript) outside ``distributed/mesh.py``: that is
  where a lost position refuses its slice, so it must go through the
  mesh seams, where the ``mesh.device_put`` fault point, the MeshSim
  position checks and the ``DeviceLostError`` classification live.
"""

from __future__ import annotations

import ast

from .core import PKG, Finding, Module, qualname_of

_BROAD = ("Exception", "BaseException")

_PREFIX = f"{PKG}/"

# the sanctioned home of raw durable-write primitives: the shared
# helper seam itself, plus the crash shim that simulates torn disks
_IO_SEAM = (f"{PKG}/utils/io.py", f"{PKG}/utils/crashsim.py")

# the sanctioned home of raw device-placement primitives: the
# accounted seam itself, plus the mesh helpers it drives
_PLACEMENT_SEAM = (f"{PKG}/executor/hbm.py", f"{PKG}/distributed/mesh.py")

# the sanctioned home of position-targeted transfers (the device-loss
# fault surface)
_MESH_SEAM = (f"{PKG}/distributed/mesh.py",)

# torch factories that copy host data when given a device=
_HOST_COPIES = ("as_tensor", "tensor")


def _is_write_mode(node: ast.Call) -> bool:
    """open(...) with a literal mode containing w/a/+/x."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not (isinstance(mode, ast.Constant)
            and isinstance(mode.value, str)):
        return False
    return any(c in mode.value for c in "wa+x")


def _device_shaped(expr: ast.expr) -> bool:
    """Whether `expr` reads as a device: a "cuda…" string, a
    torch.device(...) call, a `devices[i]` subscript, or a name or
    attribute spelled …device."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cuda")
    if isinstance(expr, ast.Call):
        fn = expr.func
        return isinstance(fn, ast.Attribute) and fn.attr == "device"
    if isinstance(expr, ast.Subscript):
        return _device_shaped(expr.value) or (
            isinstance(expr.value, (ast.Name, ast.Attribute))
            and _ident(expr.value).endswith("devices"))
    if isinstance(expr, (ast.Name, ast.Attribute)):
        return _ident(expr).lower().endswith("device")
    return False


def _ident(expr: ast.expr) -> str:
    return expr.id if isinstance(expr, ast.Name) else \
        expr.attr if isinstance(expr, ast.Attribute) else ""


def _transfer_target(node: ast.Call, fn) -> ast.expr | None:
    """The device a host→device transfer call aims at, else None."""
    if not isinstance(fn, ast.Attribute):
        return None
    kw = next((k.value for k in node.keywords if k.arg == "device"), None)
    if fn.attr == "to":
        target = kw if kw is not None else (node.args[0] if node.args
                                            else None)
        return target if target is not None and \
            _device_shaped(target) else None
    if fn.attr in _HOST_COPIES and isinstance(fn.value, ast.Name) and \
            fn.value.id == "torch" and kw is not None:
        return kw
    return None


def _transfer(node: ast.Call, fn) -> str | None:
    """How a host→device transfer call reads, else None."""
    if isinstance(fn, ast.Attribute) and fn.attr == "cuda" and \
            not (isinstance(fn.value, ast.Name) and fn.value.id == "torch"):
        return ".cuda()"
    if _transfer_target(node, fn) is None:
        return None
    return ".to(<device>)" if fn.attr == "to" else \
        f"torch.{fn.attr}(..., device=)"


def _handler_names(h: ast.ExceptHandler) -> list[str]:
    t = h.type
    if t is None:
        return []
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for e in elts:
        if isinstance(e, ast.Name):
            out.append(e.id)
        elif isinstance(e, ast.Attribute):
            out.append(e.attr)
    return out


def _body_reraises(h: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(h))


def _body_is_silent(h: ast.ExceptHandler) -> bool:
    return all(isinstance(n, (ast.Pass, ast.Continue)) for n in h.body)


def _contains_fault_point(nodes: list[ast.stmt]) -> bool:
    for stmt in nodes:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                fn = n.func
                name = (fn.id if isinstance(fn, ast.Name)
                        else fn.attr if isinstance(fn, ast.Attribute)
                        else None)
                if name == "fault_point":
                    return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, mod: Module, findings: list[Finding]):
        self.mod = mod
        self.findings = findings
        self.stack: list[ast.AST] = []

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(rule, self.mod.relpath, node.lineno,
                                     msg, qualname_of(self.stack)))

    def _visit_scope(self, node) -> None:
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_ClassDef = _visit_scope

    def visit_Try(self, node: ast.Try) -> None:
        seam = _contains_fault_point(node.body)
        for h in node.handlers:
            names = _handler_names(h)
            if h.type is None:
                self._flag("bare-except", h,
                           "bare `except:` catches SystemExit/"
                           "KeyboardInterrupt — name the exception "
                           "class")
            elif "BaseException" in names and not _body_reraises(h):
                self._flag("swallowed-base-exception", h,
                           "`except BaseException` without re-raise "
                           "swallows cancellation and injected faults")
            elif seam and not _body_reraises(h) and \
                    any(n in _BROAD for n in names):
                self._flag("swallowed-fault-seam", h,
                           "broad handler swallows a try block that "
                           "contains a fault_point() seam — injected "
                           "faults and timeout checks die here")
            elif any(n in _BROAD for n in names) and _body_is_silent(h):
                self._flag("silent-exception", h,
                           "`except Exception: pass` — narrow to the "
                           "classes this site actually expects")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        self._check_raw_durable_write(node, fn)
        self._check_raw_device_placement(node, fn)
        self._check_mesh_seam(node, fn)
        is_thread_ctor = (
            isinstance(fn, ast.Attribute) and fn.attr == "Thread"
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "threading") or (
            isinstance(fn, ast.Name) and fn.id == "Thread")
        if is_thread_ctor:
            has_daemon = any(
                kw.arg == "daemon" and
                isinstance(kw.value, ast.Constant) and
                kw.value.value is True
                for kw in node.keywords)
            if not has_daemon and not self._joined_nearby():
                self._flag("unowned-thread", node,
                           "thread started without daemon=True and "
                           "with no .join() in this function — nobody "
                           "owns its shutdown")
        self.generic_visit(node)

    def _check_raw_durable_write(self, node: ast.Call, fn) -> None:
        if not self.mod.relpath.startswith(_PREFIX) or \
                self.mod.relpath in _IO_SEAM:
            return
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "os" \
                and fn.attr in ("replace", "fsync"):
            self._flag("raw-durable-write", node,
                       f"os.{fn.attr}() outside utils/io — route the "
                       "write through the durable-write seam "
                       "(atomic_write_* / atomic_stream_writer) so "
                       "fsync discipline, checksums and the crash shim "
                       "all apply")
            return
        if isinstance(fn, ast.Name) and fn.id == "open" and \
                _is_write_mode(node):
            self._flag("raw-durable-write", node,
                       "open() for writing outside utils/io — durable "
                       "state must go through the atomic-write seam; "
                       "justify genuinely non-durable writers inline")

    def _check_raw_device_placement(self, node: ast.Call, fn) -> None:
        if not self.mod.relpath.startswith(_PREFIX) or \
                self.mod.relpath in _PLACEMENT_SEAM:
            return
        name = (fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute)
                else None)
        if name is not None and (name.startswith("put_sharded")
                                 or name == "put_replicated"):
            self._flag("raw-device-placement", node,
                       f"{name}() outside executor/hbm — route the "
                       "placement through DeviceMemoryAccountant."
                       "place*() so the measured device-memory ledger, "
                       "OOM classification and the MemSim torture "
                       "harness all apply")
            return
        what = _transfer(node, fn)
        if what is not None:
            self._flag("raw-device-placement", node,
                       f"{what} outside executor/hbm — a host→device "
                       "transfer must flow through the accounted seam; "
                       "justify genuinely unaccounted placements inline")

    def _check_mesh_seam(self, node: ast.Call, fn) -> None:
        """A transfer aimed at one position's device (`devices[i]`)
        outside distributed/mesh.py bypasses the mesh.device_put fault
        point, the MeshSim position checks and the DeviceLostError
        classification."""
        if not self.mod.relpath.startswith(_PREFIX) or \
                self.mod.relpath in _MESH_SEAM:
            return
        target = _transfer_target(node, fn)
        if isinstance(target, ast.Subscript) and _device_shaped(target):
            self._flag("mesh-seam", node,
                       "transfer to one position's device outside "
                       "distributed/mesh.py — per-position transfers "
                       "must go through the mesh seams "
                       "(put_sharded_slices / put_sharded / "
                       "put_replicated) so the mesh.device_put fault "
                       "point, MeshSim position checks and "
                       "DeviceLostError classification all apply")

    def _joined_nearby(self) -> bool:
        """The enclosing function (or class, for threads stored on self
        and joined by a sibling stop()/shutdown() method) calls
        .join() in a thread-shaped way: the receiver is a plain
        variable or a self-attribute, and the only allowed argument is
        a timeout (positional numeric or keyword) — which excludes
        ``os.path.join(...)``, ``",".join(xs)`` and ``sep.join(xs)``,
        any of which would otherwise disable this rule for the whole
        scope."""
        for scope in reversed(self.stack):
            for n in ast.walk(scope):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "join"):
                    continue
                recv = n.func.value
                recv_ok = isinstance(recv, ast.Name) or (
                    isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id == "self")
                args_ok = (not n.args or (
                    len(n.args) == 1
                    and isinstance(n.args[0], ast.Constant)
                    and isinstance(n.args[0].value, (int, float))))
                kw_ok = all(kw.arg == "timeout" for kw in n.keywords)
                if recv_ok and args_ok and kw_ok:
                    return True
        return False


def check(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        _Visitor(mod, findings).visit(mod.tree)
    return findings
