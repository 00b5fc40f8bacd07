"""Subprocess hygiene: one blessed door for external commands.

``utils.runner.shell`` is the chain's only sanctioned subprocess entry:
it takes LIST argv, bounds wall time, and converts failures into
``ChainError`` with a bounded stderr tail. Everything else is a finding:

  * direct ``subprocess.run/Popen/call/check_call/check_output``,
    ``os.system``, ``os.popen`` outside utils/runner.py;
  * ``shell=True`` anywhere (literal): an interpolated command string is
    one filename-with-a-space away from an injection or a quoting bug;
  * ``shell("…string…")`` / ``shell(f"…")`` — the helper accepts a
    string for historical reasons, but chain code must pass list argv.

Infrastructure call sites that genuinely cannot route through
``runner.shell`` (the native-library bootstrap that runs before the
package is importable-safe, the device health probe) carry inline
disables with their reasons — visible at the call site, counted here.
"""

from __future__ import annotations

import ast

from .core import Checker, Finding, ModuleSource, symbol_of
from .locks import dotted

_BANNED = {
    "subprocess.run", "subprocess.Popen", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "subprocess.getoutput", "subprocess.getstatusoutput",
    "os.system", "os.popen",
}

#: the blessed implementation itself
_ALLOW_FILES = ("processing_chain_tpu_torch/utils/runner.py",)


class SubprocessHygieneChecker(Checker):
    rule = "subprocess-hygiene"

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        if mod.rel in _ALLOW_FILES:
            return []
        findings: list[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func) or ""
            sym = ""
            if name in _BANNED:
                sym = symbol_of(mod.tree, node)
                f = mod.finding(
                    self.rule, node,
                    f"direct {name}() — external commands go through "
                    "utils.runner.shell (list argv, timeout, bounded "
                    "stderr in ChainError)",
                    symbol=sym)
                if f:
                    findings.append(f)
            for kw in node.keywords:
                if kw.arg == "shell" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    f = mod.finding(
                        self.rule, node,
                        "shell=True — pass list argv instead of an "
                        "interpolated command string",
                        symbol=sym or symbol_of(mod.tree, node))
                    if f:
                        findings.append(f)
            if name.split(".")[-1] == "shell" and node.args:
                first = node.args[0]
                if isinstance(first, ast.JoinedStr) or (
                        isinstance(first, ast.Constant)
                        and isinstance(first.value, str)):
                    f = mod.finding(
                        self.rule, node,
                        "runner.shell() called with a command STRING — "
                        "pass list argv so no shell ever parses it",
                        symbol=symbol_of(mod.tree, node))
                    if f:
                        findings.append(f)
        return findings
