"""Pooled-buffer ownership: every acquire must reach a release.

The bug class reviews kept catching by hand: a
``BufferPool.acquire`` result that never reaches ``release()`` /
``put(..., recycle=...)`` on some path silently strands a ~100 MB block
(the pool's weakref tracking turns it into a leak-of-one-allocation,
but at chunk cadence that is the high-water mark).

Model (deliberately function-local — the pool protocol is designed so
ownership transfers are explicit at call boundaries):

  * An *acquire site* is any call ``<pool>.acquire(...)`` where the
    receiver's last component contains "pool" (``pool``, ``self._pool``,
    ``DEFAULT_POOL``…).
  * The result must be bound to a simple name (directly or via a
    comprehension); acquiring into an expression — discarded, passed
    straight into a call, stored into a container — requires a
    ``# chainlint: ownership-transfer (<reason>)`` annotation on the
    statement, because the new owner is not visible to a local analysis.
  * A bound name reaches a *sink* when it is passed to a ``release``
    call, mentioned in a ``recycle=`` keyword, returned or yielded
    (ownership passes to the consumer — the bufpool protocol), mentioned
    on an ownership-transfer-annotated statement, or captured by a
    nested function (deferred-release callbacks).
  * Coverage is structural: starting from the statements after the
    acquire in its own block, a sink covers when it is reached on every
    path — a plain statement, an ``if`` with sinks in BOTH arms, a
    ``with`` body, a ``try`` whose ``finally`` (or body plus every
    handler) sinks, or an enclosing ``finally``. Sinks only inside one
    arm of a branch, or inside a loop the acquire is not in, leave a
    leaking path and the rule fires.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .core import Checker, Finding, ModuleSource, symbol_of
from .locks import dotted

_SIMPLE_STMTS = (
    ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr, ast.Return,
    ast.Raise, ast.Assert, ast.Delete,
)
_TRY_TYPES = tuple(
    t for t in (getattr(ast, "Try", None), getattr(ast, "TryStar", None))
    if t is not None
)


def _is_pool_acquire(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute) or call.func.attr != "acquire":
        return False
    recv = dotted(call.func.value)
    return recv is not None and "pool" in recv.split(".")[-1].lower()


def _mentions(node: ast.AST, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node)
    )


def _find_acquire(stmt: ast.stmt) -> Optional[ast.Call]:
    """The acquire call in a SIMPLE statement (compound statements are
    scanned via their nested simple statements, never wholesale — a
    `while` must not re-report its body's acquires)."""
    if not isinstance(stmt, _SIMPLE_STMTS):
        return None
    for n in ast.walk(stmt):
        if isinstance(n, ast.Call) and _is_pool_acquire(n):
            return n
    return None


def _iter_blocks(node: ast.AST) -> Iterable[list]:
    """Every statement list directly owned by `node` (nested function
    scopes excluded — they run on their own clock)."""
    for field_ in ("body", "orelse", "finalbody"):
        block = getattr(node, field_, None)
        if isinstance(block, list) and block and \
                isinstance(block[0], ast.stmt):
            yield block
    for handler in getattr(node, "handlers", []):
        yield handler.body


def _walk_blocks(func: ast.AST):
    """(block, owner-chain) pairs for every block in `func`'s own scope;
    owner-chain is the list of compound statements from `func` down."""
    def rec(node, chain):
        for block in _iter_blocks(node):
            yield block, chain
            for stmt in block:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                yield from rec(stmt, chain + [stmt])
    yield from rec(func, [])


class BufpoolOwnershipChecker(Checker):
    rule = "bufpool-ownership"

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_function(mod, node))
        return findings

    # ------------------------------------------------------------ sinks

    @staticmethod
    def _is_sink_stmt(mod: ModuleSource, stmt: ast.stmt, name: str) -> bool:
        if not isinstance(stmt, _SIMPLE_STMTS) or not _mentions(stmt, name):
            return False
        if stmt.lineno in mod.transfer_lines:
            return True
        if isinstance(stmt, ast.Return) and stmt.value is not None \
                and _mentions(stmt.value, name):
            return True
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Yield, ast.YieldFrom)) \
                    and node.value is not None \
                    and _mentions(node.value, name):
                return True
            if isinstance(node, ast.Call):
                fn = node.func
                fname = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else "")
                if fname in ("release", "recycle") and any(
                        _mentions(arg, name) for arg in node.args):
                    return True
                for kw in node.keywords:
                    if kw.arg == "recycle" and _mentions(kw.value, name):
                        return True
        return False

    # --------------------------------------------------------- coverage

    # tri-state path analysis over a statement block
    COVERED = "covered"          # every path reaches a sink
    LEAKED = "leaked"            # some path exits the function unsinked
    FALLTHROUGH = "fallthrough"  # runs off the end of the block unsinked

    def _analyze(self, mod: ModuleSource, stmts: list, name: str) -> str:
        for stmt in stmts:
            if self._is_sink_stmt(mod, stmt, name):
                return self.COVERED
            if isinstance(stmt, (ast.Return, ast.Raise)):
                return self.LEAKED  # exits without a sink
            if isinstance(stmt, ast.If):
                body = self._analyze(mod, stmt.body, name)
                orelse = (self._analyze(mod, stmt.orelse, name)
                          if stmt.orelse else self.FALLTHROUGH)
                if self.LEAKED in (body, orelse):
                    return self.LEAKED
                if body == orelse == self.COVERED:
                    return self.COVERED
                # at least one arm falls through unsinked: keep scanning
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                state = self._analyze(mod, stmt.body, name)
                if state != self.FALLTHROUGH:
                    return state
            elif isinstance(stmt, _TRY_TYPES):
                if stmt.finalbody:
                    state = self._analyze(mod, stmt.finalbody, name)
                    if state != self.FALLTHROUGH:
                        return state
                body = self._analyze(mod, stmt.body, name)
                handlers = [self._analyze(mod, h.body, name)
                            for h in stmt.handlers]
                if body == self.LEAKED or self.LEAKED in handlers:
                    return self.LEAKED
                if body == self.COVERED and handlers and \
                        all(h == self.COVERED for h in handlers):
                    return self.COVERED
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                # zero iterations possible -> a sink inside never covers,
                # but an unsinked return/raise inside still leaks
                if self._analyze(mod, stmt.body, name) == self.LEAKED:
                    return self.LEAKED
        return self.FALLTHROUGH

    def _covers(self, mod: ModuleSource, stmts: list, name: str) -> bool:
        """True when every control-flow path through `stmts` reaches a
        sink for `name` (or terminates the function through one)."""
        return self._analyze(mod, stmts, name) == self.COVERED

    # --------------------------------------------------------------- main

    def _check_function(self, mod: ModuleSource, func: ast.AST) -> list[Finding]:
        findings: list[Finding] = []
        def sym() -> str:
            # only for a finding: the scope scan walks the whole module
            return symbol_of(mod.tree, func) or func.name

        nested_defs = [
            n for n in ast.walk(func)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)) and n is not func
        ]

        for block, chain in _walk_blocks(func):
            for idx, stmt in enumerate(block):
                acq = _find_acquire(stmt)
                if acq is None:
                    continue
                target = None
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    target = stmt.targets[0].id
                elif isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    target = stmt.target.id
                if target is None:
                    if stmt.lineno not in mod.transfer_lines:
                        f = mod.finding(
                            self.rule, acq,
                            "pool.acquire() result is not bound to a "
                            "simple name — the new owner is invisible to "
                            "leak analysis; bind it, or annotate the "
                            "statement with `# chainlint: "
                            "ownership-transfer (reason)`",
                            symbol=sym())
                        if f:
                            findings.append(f)
                    continue

                if any(_mentions(nd, target) for nd in nested_defs):
                    continue  # captured for deferred release
                all_stmts = [
                    s for b, _ in _walk_blocks(func) for s in b
                    if s is not stmt
                ]
                if not any(self._is_sink_stmt(mod, s, target)
                           for s in all_stmts):
                    f = mod.finding(
                        self.rule, acq,
                        f"'{target}' is acquired from a pool but never "
                        "reaches release()/recycle=/return — the block "
                        "leaks; release it, or annotate the hand-off "
                        "with `# chainlint: ownership-transfer (reason)`",
                        symbol=sym())
                    if f:
                        findings.append(f)
                    continue
                covered = self._covers(mod, block[idx + 1:], target)
                if not covered:
                    # an enclosing try's finally can still cover
                    for owner in chain:
                        if isinstance(owner, _TRY_TYPES) and owner.finalbody \
                                and self._covers(mod, owner.finalbody, target):
                            covered = True
                            break
                if not covered:
                    f = mod.finding(
                        self.rule, acq,
                        f"'{target}' is not released on every path from "
                        "here (a branch, loop-skip, or error exit leaks "
                        "the block) — release unconditionally, in a "
                        "finally:, in both arms of the branch, or "
                        "annotate ownership-transfer",
                        symbol=sym())
                    if f:
                        findings.append(f)
        return findings
