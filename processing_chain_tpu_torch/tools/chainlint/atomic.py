"""Atomic-write discipline for run-dir artifacts.

The chain's durability rule (utils/fsio.py): anything a later run's
exists-check, a concurrent reader (live /status, chain-top), or the
store's integrity layer might trust must be written via
``fsio.atomic_write`` or the tmp+``os.replace`` idiom — an interrupted
writer must never leave a truncated file under a trusted name.

A ``open(path, "w"/"wb"/"x")`` call is compliant when:

  * the path expression mentions a temp name (``tmp``/``.part``) — the
    first half of the idiom; or
  * the enclosing function also calls ``os.replace``/``os.rename`` —
    the second half; or
  * it happens inside the ``write_fn`` handed to ``fsio.atomic_write``
    (a lambda argument, or a local def whose name is passed in); or
  * it opens in append mode (streams are append-only by design and
    torn tails are handled by readers — events.read_jsonl).

Anything else is a finding. Deliberate exceptions (crash-sentinel touch
files whose CONTENT is irrelevant, per-job provenance logs) carry inline
disables with reasons.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Checker, Finding, ModuleSource, symbol_of
from .locks import dotted


def _mode_of(call: ast.Call) -> Optional[str]:
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


class AtomicWriteChecker(Checker):
    rule = "atomic-write"

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        findings: list[Finding] = []
        blessed: set[int] = set()      # node ids inside atomic_write(...) args
        blessed_fn_names: set[str] = set()  # local defs passed to atomic_write

        # atomic wrappers: local defs that forward a function parameter
        # into atomic_write (models/metadata._maybe_write) bless their
        # call sites exactly like atomic_write itself does
        wrapper_names: set[str] = {"atomic_write"}
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = {a.arg for a in node.args.args + node.args.kwonlyargs}
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        (dotted(sub.func) or "").split(".")[-1] == "atomic_write" \
                        and any(isinstance(a, ast.Name) and a.id in params
                                for a in sub.args):
                    wrapper_names.add(node.name)

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                name = dotted(node.func) or ""
                if name.split(".")[-1] in wrapper_names:
                    for arg in list(node.args) + [kw.value for kw in node.keywords]:
                        if isinstance(arg, ast.Name):
                            blessed_fn_names.add(arg.id)
                        for sub in ast.walk(arg):
                            blessed.add(id(sub))

        # map: function node -> does it (or an enclosing one) replace/rename?
        def has_replace(fn: ast.AST) -> bool:
            for n in ast.walk(fn):
                if isinstance(n, ast.Call):
                    nm = dotted(n.func) or ""
                    if nm in ("os.replace", "os.rename", "shutil.move"):
                        return True
            return False

        class _Walker(ast.NodeVisitor):
            def __init__(self) -> None:
                self.fn_stack: list[ast.AST] = []

            def _visit_fn(self, node) -> None:
                self.fn_stack.append(node)
                self.generic_visit(node)
                self.fn_stack.pop()

            visit_FunctionDef = _visit_fn
            visit_AsyncFunctionDef = _visit_fn
            visit_Lambda = _visit_fn

            def visit_Call(self, node: ast.Call) -> None:
                self.generic_visit(node)
                name = dotted(node.func) or ""
                if name not in ("open", "io.open") or not node.args:
                    return
                mode = _mode_of(node)
                if mode is None or not any(c in mode for c in "wx"):
                    return
                if id(node) in blessed:
                    return  # inside atomic_write's write_fn argument
                try:
                    path_text = ast.unparse(node.args[0]).lower()
                except Exception:  # pragma: no cover - unparse is total on 3.9+
                    path_text = ""
                if "tmp" in path_text or "part" in path_text:
                    return
                for fn in self.fn_stack:
                    if getattr(fn, "name", None) in blessed_fn_names:
                        return  # a def handed to atomic_write as write_fn
                    if has_replace(fn):
                        return
                f = mod.finding(
                    AtomicWriteChecker.rule, node,
                    f"open({ast.unparse(node.args[0])}, {mode!r}) writes a "
                    "trusted path in place — an interrupted run leaves a "
                    "truncated file; use fsio.atomic_write or the "
                    "tmp+os.replace idiom (docs/LINT.md)",
                    symbol=symbol_of(mod.tree, node))
                if f:
                    findings.append(f)

        _Walker().visit(mod.tree)
        return findings
