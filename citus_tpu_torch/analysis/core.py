"""graftlint driver for the port: module collection, findings, baseline
suppression (the JAX package's citus_tpu/analysis/core.py, aimed at
citus_tpu_torch/).

A finding's identity deliberately excludes the line number — baselines
must survive unrelated edits above the flagged site.  The key is
(rule, path, enclosing qualname, message); the message embeds the
specific names involved (lock ids, counter names) so two different
violations in one function stay distinct.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field

# rules a source line can suppress with `# graftlint: ignore[rule, ...]`
_IGNORE_RE = re.compile(r"#\s*graftlint:\s*ignore\[([a-z0-9\-,\s]+)\]")

# the port and the scripts that drive it; never the JAX package
# (citus_tpu/, linted by its own graftlint) nor its tools
PKG = "citus_tpu_torch"
DEFAULT_SUBDIRS = (PKG, "chip_smoke.py", "tools/compare_grid_sums.py",
                   "tools/dense_grid_layouts.py",
                   "tools/compare_bit_unpack.py", "tools/compare_phases.py")
# repo-relative; every entry carries a `why`
BASELINE_NAME = f"{PKG}/analysis/lint_baseline.json"


@dataclass
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    context: str = ""  # enclosing ClassName.func qualname ("" = module)

    @property
    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.context}|{self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "context": self.context, "message": self.message}

    def __str__(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{ctx}"


@dataclass
class Module:
    """One parsed source file."""

    path: str          # absolute
    relpath: str       # repo-relative, forward slashes
    name: str          # dotted module name (citus_tpu_torch.wlm.manager)
    source: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)

    def ignored_rules(self, line: int) -> set[str]:
        """Rules suppressed by an inline marker on `line` (1-based)."""
        if 1 <= line <= len(self.lines):
            m = _IGNORE_RE.search(self.lines[line - 1])
            if m:
                return {r.strip() for r in m.group(1).split(",")}
        return set()


def _module_name(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    return mod[:-9] if mod.endswith(".__init__") else mod


def collect_modules(root: str,
                    subdirs: tuple = DEFAULT_SUBDIRS,
                    ) -> tuple[list[Module], list[Finding]]:
    """Parse every .py file under root/<subdir>; syntax errors become
    `parse-error` findings instead of aborting the run."""
    modules: list[Module] = []
    findings: list[Finding] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base) and base.endswith(".py"):
            paths = [base]
        else:
            paths = sorted(
                os.path.join(dp, f)
                for dp, _dirs, files in os.walk(base)
                for f in files
                if f.endswith(".py") and "__pycache__" not in dp)
        for path in paths:
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                src = f.read()
            try:
                tree = ast.parse(src, filename=rel)
            except SyntaxError as e:
                findings.append(Finding(
                    "parse-error", rel, e.lineno or 0,
                    f"file does not parse: {e.msg}"))
                continue
            modules.append(Module(path, rel, _module_name(rel), src, tree,
                                  src.splitlines()))
    return modules, findings


def qualname_of(stack: list) -> str:
    """Enclosing context for a finding: Class.method / func / ''."""
    names = [n.name for n in stack
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))]
    return ".".join(names)


def scoped_walk(tree: ast.AST):
    """Yield (node, qualname) for every node, qualname being the
    enclosing Class.method context — the one scope-tracking traversal
    shared by every rule that attributes findings to functions."""
    stack: list[ast.AST] = []

    def walk(node):
        scoped = isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.ClassDef))
        if scoped:
            stack.append(node)
        qn = qualname_of(stack)
        yield node, qn
        for child in ast.iter_child_nodes(node):
            yield from walk(child)
        if scoped:
            stack.pop()

    yield from walk(tree)


FAMILY_RULES = {
    "lockgraph": frozenset({"lock-order-cycle", "unlocked-shared-write",
                            "raw-lock-acquire"}),
    "hotpath": frozenset({"host-sync-in-capture", "capture-python-branch",
                          "device-sync-in-loop", "rebuild-in-loop"}),
    "registries": frozenset({"fault-point-registry", "counter-registry",
                             "config-registry", "explain-tag-registry",
                             "span-registry"}),
    "discipline": frozenset({"bare-except", "swallowed-base-exception",
                             "swallowed-fault-seam", "silent-exception",
                             "unowned-thread", "raw-durable-write",
                             "raw-device-placement", "mesh-seam"}),
}


def run_lint(root: str, subdirs: tuple = DEFAULT_SUBDIRS,
             rules: tuple | None = None) -> list[Finding]:
    """Run the rule families over root/<subdirs>; returns ALL findings
    (inline-suppressed ones already removed, baseline NOT applied —
    callers pair this with `unbaselined`).  With `rules`, only the
    families that own those rules run (single-rule wrapper tests skip
    the other three analyses)."""
    from . import discipline, hotpath, lockgraph, registries

    def wanted(family: str) -> bool:
        return rules is None or bool(FAMILY_RULES[family] & set(rules))

    # a scan over anything but the default roots is PARTIAL: the
    # "registered but never used" direction cannot be judged when the
    # use sites may simply not have been scanned
    partial = tuple(subdirs) != DEFAULT_SUBDIRS
    modules, findings = collect_modules(root, subdirs)
    if wanted("lockgraph"):
        findings += lockgraph.check(modules)
    if wanted("hotpath"):
        findings += hotpath.check(modules)
    if wanted("registries"):
        findings += registries.check(modules, partial=partial)
    if wanted("discipline"):
        findings += discipline.check(modules)
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    by_path = {m.relpath: m for m in modules}
    kept = []
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None and f.rule in mod.ignored_rules(f.line):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return kept


# -- baseline ---------------------------------------------------------------
def load_baseline(path: str) -> dict[str, str]:
    """baseline key → why.  Missing file = empty baseline."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return {}
    out: dict[str, str] = {}
    for e in data.get("findings", []):
        key = (f"{e['rule']}|{e['path']}|{e.get('context', '')}|"
               f"{e['message']}")
        out[key] = e.get("why", "")
    return out


def unbaselined(findings: list[Finding],
                baseline: dict[str, str]) -> tuple[list[Finding],
                                                   list[str]]:
    """(new findings not in baseline, stale baseline keys).  A stale
    entry means the violation was fixed — the baseline must shrink with
    it, or dead suppressions accumulate and eventually mask a
    regression at the same site."""
    keys = {f.key for f in findings}
    fresh = [f for f in findings if f.key not in baseline]
    stale = sorted(k for k in baseline if k not in keys)
    return fresh, stale


def baseline_payload(findings: list[Finding],
                     whys: dict[str, str] | None = None) -> dict:
    """Serializable baseline for --write-baseline; `whys` carries
    forward justifications from an existing baseline."""
    whys = whys or {}
    return {
        "comment": ("graftlint suppression baseline — every entry MUST "
                    "carry a `why`; regenerate with `python -m "
                    "citus_tpu_torch.analysis --write-baseline` and "
                    "re-justify "
                    "anything new"),
        "findings": [
            {"rule": f.rule, "path": f.path, "context": f.context,
             "message": f.message,
             "why": whys.get(f.key, "TODO: justify or fix")}
            for f in findings],
    }
