"""Lock discipline: guarded attributes and the acquisition-order graph.

``lock-guard``: an attribute whose declaration line (usually in
``__init__``) carries ``# guarded-by: <lock>`` may only be read or
written inside a ``with <lock>`` scope. Exemptions: the declaring
class's ``__init__``/``__new__`` (construction happens before the
object is shared) and functions annotated ``# holds-lock: <lock>``
(callers acquire for them — the ``_locked``-suffix convention, made
machine-readable).

Lock matching is by dotted-suffix after stripping the ``self``/``cls``
receiver, so ``# guarded-by: _registry._lock`` accepts both
``with self._registry._lock`` and ``with metric._registry._lock``.

``lock-order``: every *lexically nested* pair ``with A: … with B:``
contributes an A→B edge to a process-wide graph; a cycle means two code
paths can acquire the same locks in opposite orders — the classic
deadlock. Lock-looking context managers are recognized by their final
attribute component containing ``lock`` (case-insensitive). The static
graph only sees same-function nesting; the runtime recorder
(utils/lockdebug.py, PC_LOCK_DEBUG=1 under tests) sees cross-function
chains, and both feed the same cycle detector so the evidence agrees.
"""

from __future__ import annotations

import ast
from typing import Optional

from ...utils.lockdebug import find_cycle
from .core import Checker, Finding, ModuleSource, symbol_of


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a pure Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _strip_receiver(parts: list[str]) -> list[str]:
    return parts[1:] if parts and parts[0] in ("self", "cls") else parts


def guard_matches(declared: str, held: str) -> bool:
    """Componentwise suffix match after stripping self/cls, either way:
    declared '_registry._lock' is satisfied by held
    'metric._registry._lock'; declared 'self._lock' by held '_lock'."""
    d = _strip_receiver(declared.split("."))
    h = _strip_receiver(held.split("."))
    if not d or not h:
        return False
    shorter, longer = (d, h) if len(d) <= len(h) else (h, d)
    return longer[-len(shorter):] == shorter


def _is_lockish(name: str) -> bool:
    return "lock" in name.split(".")[-1].lower()


class _FunctionWalker(ast.NodeVisitor):
    """Shared traversal: tracks the with-stack of dotted context
    expressions and the enclosing class/function chain."""

    def __init__(self, mod: ModuleSource) -> None:
        self.mod = mod
        self.with_stack: list[tuple[str, int]] = []  # (dotted expr, line)
        self.class_stack: list[str] = []
        self.func_stack: list[ast.AST] = []
        self.findings: list[Finding] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node) -> None:
        self.func_stack.append(node)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            expr = item.context_expr
            # `with lock:` and `with lock.acquire_timeout(…):` both hold
            # the lock; use the callee text for call expressions
            name = dotted(expr.func if isinstance(expr, ast.Call) else expr)
            if name is not None:
                self.on_with(name, node.lineno)
                self.with_stack.append((name, node.lineno))
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        del self.with_stack[len(self.with_stack) - pushed:]

    visit_AsyncWith = visit_With

    def on_with(self, name: str, lineno: int) -> None:
        pass


class LockGuardChecker(Checker):
    rule = "lock-guard"

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        declared = self._collect_declarations(mod)
        if not declared:
            return []
        walker = _GuardWalker(mod, declared)
        walker.visit(mod.tree)
        return walker.findings

    @staticmethod
    def _collect_declarations(mod: ModuleSource) -> dict[str, tuple[str, Optional[str], int]]:
        """{attr/global name: (lock expr, declaring class or None, line)}
        from ``# guarded-by:`` comments on assignment lines."""
        declared: dict[str, tuple[str, Optional[str], int]] = {}

        class _Decl(ast.NodeVisitor):
            def __init__(self) -> None:
                self.class_stack: list[str] = []

            def visit_ClassDef(self, node: ast.ClassDef) -> None:
                self.class_stack.append(node.name)
                self.generic_visit(node)
                self.class_stack.pop()

            def _handle(self, node, targets) -> None:
                lock = mod.guarded_by.get(node.lineno)
                if lock is None:
                    return
                cls = self.class_stack[-1] if self.class_stack else None
                for target in targets:
                    if isinstance(target, ast.Attribute) and \
                            isinstance(target.value, ast.Name) and \
                            target.value.id in ("self", "cls"):
                        declared[target.attr] = (lock, cls, node.lineno)
                    elif isinstance(target, ast.Name):
                        declared[target.id] = (lock, cls, node.lineno)

            def visit_Assign(self, node: ast.Assign) -> None:
                self._handle(node, node.targets)
                self.generic_visit(node)

            def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
                self._handle(node, [node.target])
                self.generic_visit(node)

        _Decl().visit(mod.tree)
        return declared


class _GuardWalker(_FunctionWalker):
    def __init__(self, mod: ModuleSource, declared: dict) -> None:
        super().__init__(mod)
        self.declared = declared

    def _exempt(self, name: str, node: ast.AST) -> bool:
        lock, cls, decl_line = self.declared[name]
        if node.lineno == decl_line:
            return True  # the declaration itself
        func = self.func_stack[-1] if self.func_stack else None
        if func is not None:
            if func.name in ("__init__", "__new__") and (
                    cls is None or (self.class_stack
                                    and self.class_stack[-1] == cls)):
                return True
            held_doc = self.mod.holds_lock.get(func.lineno)
            if held_doc is not None and guard_matches(lock, held_doc):
                return True
        return any(guard_matches(lock, held) for held, _ in self.with_stack)

    def _check(self, name: str, node: ast.AST) -> None:
        if name not in self.declared or self._exempt(name, node):
            return
        lock = self.declared[name][0]
        f = self.mod.finding(
            "lock-guard", node,
            f"'{name}' is declared guarded-by {lock} but is accessed "
            f"outside any `with {lock}` scope (add the lock, a "
            f"`# holds-lock: {lock}` contract on the enclosing function, "
            "or a justified disable)",
            symbol=symbol_of(self.mod.tree, self.func_stack[-1])
            if self.func_stack else "",
        )
        if f:
            self.findings.append(f)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self._check(node.attr, node)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        # module-level guarded globals (declared without a class)
        if node.id in self.declared and self.declared[node.id][1] is None:
            self._check(node.id, node)


class LockOrderChecker(Checker):
    rule = "lock-order"

    def __init__(self) -> None:
        #: (from, to) -> first location observed
        self.edges: dict[tuple[str, str], tuple[str, int]] = {}

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        checker = self

        class _OrderWalker(_FunctionWalker):
            def on_with(self, name: str, lineno: int) -> None:
                if not _is_lockish(name):
                    return
                inner = self._canonical(name)
                for held, _ in self.with_stack:
                    if not _is_lockish(held):
                        continue
                    outer = self._canonical(held)
                    if outer != inner:
                        checker.edges.setdefault(
                            (outer, inner), (self.mod.rel, lineno))

            def _canonical(self, name: str) -> str:
                parts = name.split(".")
                if parts[0] in ("self", "cls") and self.class_stack:
                    parts[0] = self.class_stack[-1]
                return ".".join(parts[-2:]) if len(parts) >= 2 else parts[0]

        walker = _OrderWalker(mod)
        walker.visit(mod.tree)
        return []

    def finalize(self) -> list[Finding]:
        graph: dict[str, set] = {}
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        cycle = find_cycle(graph)
        if not cycle:
            return []
        locs = []
        for a, b in zip(cycle, cycle[1:]):
            where = self.edges.get((a, b))
            if where:
                locs.append(f"{a}→{b} at {where[0]}:{where[1]}")
        first = self.edges.get((cycle[0], cycle[1]), ("", 0))
        f = Finding(
            rule="lock-order",
            path=first[0],
            line=first[1],
            message=("static lock-acquisition cycle "
                     f"{' → '.join(cycle)} ({'; '.join(locs)}): two paths "
                     "can take these locks in opposite orders and "
                     "deadlock — pick one global order"),
            symbol="lock-order-graph",
        )
        f.snippet = " → ".join(cycle)
        return [f]
