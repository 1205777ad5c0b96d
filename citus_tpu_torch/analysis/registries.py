"""Registry sync: names used in source ↔ their central registry.

The port has five name registries, the JAX package's, at the same
module paths under citus_tpu_torch/:

* fault points — ``FAULT_POINTS`` in ``utils/faultinjection.py`` vs
  every ``fault_point("name")`` call site;
* counters — ``ALL_COUNTERS`` (via the module constants) in
  ``stats/counters.py`` vs every ``increment(sc.NAME)`` site;
* config vars — the ``_register(ConfigVar("name", ...))`` registry in
  ``config.py`` vs every ``settings.get("name")`` / ``.set("name")``
  read/write site;
* EXPLAIN tags — ``EXPLAIN_TAGS`` in ``planner/explain.py`` vs every
  ``explain_tag("name")`` render site;
* span names — ``SPAN_NAMES`` in ``stats/tracing.py`` vs every
  ``trace_span("name")`` / ``span_name("name")`` record site (the
  flight recorder's EXPLAIN_TAGS analogue: bench drivers and
  trace_summarize key on these strings, so a silently renamed span is
  a silently broken phase attribution).

Both directions are findings: a name used but not registered is
``*-registry: unregistered``, a registered name never used is
``*-registry: unused``.  Everything is resolved from the AST (no
imports), so the checker works on a tree that doesn't import (and
cannot be fooled by runtime monkey-patching).
"""

from __future__ import annotations

import ast

from .core import PKG, Finding, Module, scoped_walk

FAULTINJECTION_MOD = f"{PKG}/utils/faultinjection.py"
COUNTERS_MOD = f"{PKG}/stats/counters.py"
CONFIG_MOD = f"{PKG}/config.py"
EXPLAIN_MOD = f"{PKG}/planner/explain.py"
TRACING_MOD = f"{PKG}/stats/tracing.py"


# -- registry extraction (AST, no imports) ----------------------------------
def _dict_literal_keys(tree: ast.AST, var: str) -> dict[str, int]:
    """String keys of `VAR = {...}` at module level → line."""
    for node in tree.body if hasattr(tree, "body") else []:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, ast.Name) and t.id == var
                   for t in targets) and \
                    isinstance(node.value, ast.Dict):
                return {k.value: k.lineno for k in node.value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
    return {}


def _counter_constants(tree: ast.AST) -> dict[str, str]:
    """UPPER_NAME = "string" module assignments → {attr: value}."""
    out: dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id.isupper() and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _registered_config_vars(tree: ast.AST) -> dict[str, int]:
    """Names from `_register(ConfigVar("name", ...))` calls → line."""
    out: dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "_register" and node.args and \
                isinstance(node.args[0], ast.Call):
            inner = node.args[0]
            if inner.args and isinstance(inner.args[0], ast.Constant) \
                    and isinstance(inner.args[0].value, str):
                out[inner.args[0].value] = inner.args[0].lineno
    return out


# -- use-site extraction ----------------------------------------------------
def _calls(modules: list[Module]) -> list[tuple[Module, ast.Call, str]]:
    """(module, call, ctx) of every call in the tree: one scoped walk,
    shared by every registry's use-site scan."""
    return [(m, node, ctx) for m in modules
            for node, ctx in scoped_walk(m.tree)
            if isinstance(node, ast.Call)]


def _str_arg_calls(calls: list, fn_name: str, skip_paths: tuple = (),
                   ) -> list[tuple[str, str, int, str]]:
    """(name, relpath, line, ctx) for every `fn_name("literal")` call."""
    out = []
    for m, node, ctx in calls:
        if m.relpath in skip_paths:
            continue
        fn = node.func
        name = (fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute)
                else None)
        if name == fn_name and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            out.append((node.args[0].value, m.relpath,
                        node.lineno, ctx))
    return out


def _settings_accesses(calls: list) -> list[tuple[str, str, int, str]]:
    """settings.get("name") / settings.set("name", v) /
    .override(name=...) sites — receiver must be settings-shaped
    (`settings` or `*.settings`), so dict .get() calls don't match."""
    out = []
    for m, node, ctx in calls:
        if m.relpath == CONFIG_MOD:
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        fn = node.func
        recv = fn.value
        recv_is_settings = (
            (isinstance(recv, ast.Name) and recv.id == "settings")
            or (isinstance(recv, ast.Attribute)
                and recv.attr == "settings"))
        if recv_is_settings and fn.attr in ("get", "set", "reset") \
                and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            out.append((node.args[0].value, m.relpath, node.lineno,
                        ctx))
        if recv_is_settings and fn.attr == "override":
            for kw in node.keywords:
                if kw.arg is not None:
                    out.append((kw.arg, m.relpath, node.lineno,
                                ctx))
    return out


def check(modules: list[Module], partial: bool = False) -> list[Finding]:
    """`partial` marks a subset scan (explicit CLI paths): the
    "registered but never used" direction is skipped there — the use
    sites may simply not have been scanned — while registry-internal
    consistency and the "used but unregistered" direction still hold
    for whatever WAS scanned."""
    findings: list[Finding] = []
    by_path = {m.relpath: m for m in modules}
    calls = _calls(modules)

    # -- fault points ------------------------------------------------------
    reg_mod = by_path.get(FAULTINJECTION_MOD)
    if reg_mod is not None:
        registry = _dict_literal_keys(reg_mod.tree, "FAULT_POINTS")
        uses = _str_arg_calls(calls, "fault_point",
                              skip_paths=(FAULTINJECTION_MOD,))
        used = {u[0] for u in uses}
        for name, path, line, ctx in sorted(uses):
            if name not in registry:
                findings.append(Finding(
                    "fault-point-registry", path, line,
                    f"fault point {name!r} is not declared in "
                    "FAULT_POINTS (utils/faultinjection.py)", ctx))
        for name in (() if partial else sorted(set(registry) - used)):
            findings.append(Finding(
                "fault-point-registry", FAULTINJECTION_MOD,
                registry[name],
                f"fault point {name!r} is registered but has no "
                "fault_point() call site in the tree"))

    # -- counters ----------------------------------------------------------
    cmod = by_path.get(COUNTERS_MOD)
    if cmod is not None:
        consts = _counter_constants(cmod.tree)
        registered = {consts[a]: line for a, line in
                      _counter_list_lines(cmod.tree, consts).items()}
        # increment(sc.NAME) / increment(NAME) sites resolved through
        # the constants table
        used: dict[str, tuple[str, int, str]] = {}
        unknown: list[tuple[str, str, int, str]] = []
        for m, node, ctx in calls:
            if m.relpath == COUNTERS_MOD:
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "increment"
                    and node.args):
                continue
            arg = node.args[0]
            # an IfExp argument (`sc.A if cond else sc.B`) marks
            # BOTH branches as used, a pick from a dict literal
            # (`{"hit": sc.A, ...}[status]`) every value
            branches = ([arg.body, arg.orelse]
                        if isinstance(arg, ast.IfExp)
                        else list(arg.value.values)
                        if isinstance(arg, ast.Subscript)
                        and isinstance(arg.value, ast.Dict)
                        else [arg])
            for b in branches:
                attr = (b.attr if isinstance(b, ast.Attribute)
                        else b.id if isinstance(b, ast.Name)
                        else None)
                if attr is None:
                    continue  # dynamic — out of scope
                if attr in consts:
                    used.setdefault(consts[attr],
                                    (m.relpath, node.lineno, ctx))
                elif attr.isupper():
                    unknown.append((attr, m.relpath, node.lineno,
                                    ctx))
        for attr, path, line, ctx in sorted(unknown):
            findings.append(Finding(
                "counter-registry", path, line,
                f"counter constant {attr} is not defined in "
                "stats/counters.py", ctx))
        for name in (() if partial
                     else sorted(set(registered) - set(used))):
            findings.append(Finding(
                "counter-registry", COUNTERS_MOD, registered[name],
                f"counter {name!r} is in ALL_COUNTERS but never "
                "incremented anywhere in the tree"))
        for name in sorted(set(used) - set(registered)):
            path, line, ctx = used[name]
            findings.append(Finding(
                "counter-registry", path, line,
                f"counter {name!r} is incremented but missing from "
                "ALL_COUNTERS (snapshots would silently drop it)", ctx))
        for attr in sorted(set(consts) - set(
                _counter_list_lines(cmod.tree, consts))):
            findings.append(Finding(
                "counter-registry", COUNTERS_MOD, 1,
                f"counter constant {attr} is defined but not listed in "
                "ALL_COUNTERS (snapshots would silently drop it)"))

    # -- config vars -------------------------------------------------------
    cfg = by_path.get(CONFIG_MOD)
    if cfg is not None:
        registry = _registered_config_vars(cfg.tree)
        accesses = _settings_accesses(calls)
        read = {a[0] for a in accesses}
        for name, path, line, ctx in sorted(accesses):
            if name not in registry:
                findings.append(Finding(
                    "config-registry", path, line,
                    f"config var {name!r} is not registered in "
                    "config.py (Settings.get would raise ConfigError)",
                    ctx))
        for name in (() if partial else sorted(set(registry) - read)):
            findings.append(Finding(
                "config-registry", CONFIG_MOD, registry[name],
                f"config var {name!r} is registered but never read via "
                "settings.get() in the tree (dead knob?)"))

    # -- EXPLAIN tags ------------------------------------------------------
    emod = by_path.get(EXPLAIN_MOD)
    if emod is not None:
        registry = _dict_literal_keys(emod.tree, "EXPLAIN_TAGS")
        uses = _str_arg_calls(calls, "explain_tag")
        used = {u[0] for u in uses}
        for name, path, line, ctx in sorted(uses):
            if name not in registry:
                findings.append(Finding(
                    "explain-tag-registry", path, line,
                    f"EXPLAIN tag {name!r} is not declared in "
                    "EXPLAIN_TAGS (planner/explain.py)", ctx))
        for name in (() if partial else sorted(set(registry) - used)):
            findings.append(Finding(
                "explain-tag-registry", EXPLAIN_MOD, registry[name],
                f"EXPLAIN tag {name!r} is registered but never "
                "rendered via explain_tag()"))

    # -- span names (stats/tracing.py flight recorder) ---------------------
    tmod = by_path.get(TRACING_MOD)
    if tmod is not None:
        registry = _dict_literal_keys(tmod.tree, "SPAN_NAMES")
        uses = (_str_arg_calls(calls, "trace_span")
                + _str_arg_calls(calls, "span_name"))
        used = {u[0] for u in uses}
        for name, path, line, ctx in sorted(uses):
            if name not in registry:
                findings.append(Finding(
                    "span-registry", path, line,
                    f"span name {name!r} is not declared in "
                    "SPAN_NAMES (stats/tracing.py)", ctx))
        for name in (() if partial else sorted(set(registry) - used)):
            findings.append(Finding(
                "span-registry", TRACING_MOD, registry[name],
                f"span name {name!r} is registered but never recorded "
                "via trace_span()/span_name()"))
    return findings


def _counter_list_lines(tree: ast.AST,
                        consts: dict[str, str]) -> dict[str, int]:
    """attr → line for entries of the ALL_COUNTERS and PORT_COUNTERS
    lists (both are snapshotted)."""
    out: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id in ("ALL_COUNTERS", "PORT_COUNTERS") \
                and isinstance(node.value, ast.List):
            out.update({e.id: e.lineno for e in node.value.elts
                        if isinstance(e, ast.Name) and e.id in consts})
    return out
