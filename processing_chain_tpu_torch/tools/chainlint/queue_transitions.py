"""queue-transition: every serve queue state write is a declared edge.

The serve daemon's crash story rests on the DurableQueue record state
machine (queued → running → done | failed, plus the re-arm and
recovery edges). Its known failure mode: a
state write added in one code path that recovery or the scheduler's
settle pass didn't know about, stranding records. The cure is ONE
declared transition table in ``serve/queue.py`` (``STATES``,
``INITIAL``, ``TRANSITIONS``) shared by three consumers:

  * this static checker — every ``<record>.state = "…"`` assignment in
    a serve-queue module must carry a ``# queue-transition: <from> ->
    <to>`` annotation naming a declared edge (multiple sources:
    ``a|b -> c``); undeclared writes, unknown states, non-literal
    assignments and constructor states other than ``INITIAL`` are
    findings, and a declared edge no annotated write implements is a
    stale-table finding (baseline-style hygiene);
  * ``tools queue-crashcheck`` — fault-injects every atomic-write
    boundary in claim/settle/recover and asserts reload lands every
    record in a declared state with no stranded ``running`` records;
  * docs/SERVE.md — the rendered table between the
    ``<!-- queue-transitions:begin/end -->`` markers is drift-checked
    both ways against the declaration (render it with
    ``tools queue-crashcheck --render-table``).

Scope: ``serve/queue.py`` itself plus any linted module that imports
``JobRecord``/``DurableQueue`` from it — the only places a queue record
can leak to.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Optional

from .core import Checker, Finding, ModuleSource, symbol_of

RULE = "queue-transition"

#: names whose import marks a module as handling queue records
_SCOPE_NAMES = ("JobRecord", "DurableQueue")

_DOC_BEGIN = "<!-- queue-transitions:begin -->"
_DOC_END = "<!-- queue-transitions:end -->"
_DOC_EDGE_RE = re.compile(r"`([a-z]+)\s*(?:->|→)\s*([a-z]+)`")


def load_transitions(path: str) -> tuple[tuple, Optional[str], set, dict]:
    """(STATES, INITIAL, TRANSITIONS, edge meanings) parsed from
    serve/queue.py's AST — never imported, so the linter works on any
    tree. The meaning of each edge is its trailing comment on the
    declaration line, so the rendered docs/SERVE.md table has exactly
    ONE source (no second copy of the semantics to drift)."""
    states: tuple = ()
    initial: Optional[str] = None
    transitions: set = set()
    meanings: dict = {}
    if not os.path.isfile(path):
        return states, initial, transitions, meanings
    with open(path, encoding="utf-8") as f:
        text = f.read()
    lines = text.splitlines()
    tree = ast.parse(text)
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            targets, value = [node.target.id], node.value
        else:
            continue
        if value is None:
            continue
        if "STATES" in targets:
            states = tuple(
                c.value for c in ast.walk(value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            )
        if "INITIAL" in targets and isinstance(value, ast.Constant):
            initial = value.value
        if "TRANSITIONS" in targets:
            for sub in ast.walk(value):
                if isinstance(sub, ast.Tuple) and len(sub.elts) == 2 and \
                        all(isinstance(e, ast.Constant) and
                            isinstance(e.value, str) for e in sub.elts):
                    edge = (sub.elts[0].value, sub.elts[1].value)
                    transitions.add(edge)
                    if 1 <= sub.lineno <= len(lines):
                        _, hash_, comment = \
                            lines[sub.lineno - 1].partition("#")
                        if hash_:
                            meanings[edge] = comment.strip()
    return states, initial, transitions, meanings


def render_table(states: tuple, initial: Optional[str],
                 transitions: set, meanings: Optional[dict] = None) -> str:
    """The markdown block docs/SERVE.md carries between the markers.
    `meanings` comes from load_transitions — the trailing comments on
    the declaration lines — so the table is rendered from exactly one
    source and a new edge can never ship with a silently blank cell."""
    meanings = meanings or {}
    lines = [
        _DOC_BEGIN,
        f"Initial state: `{initial}`. States: "
        + ", ".join(f"`{s}`" for s in states) + ".",
        "",
        "| edge | meaning |",
        "|------|---------|",
    ] + [
        f"| `{a} -> {b}` | {meanings.get((a, b), '')} |"
        for a, b in sorted(transitions)
    ] + [_DOC_END]
    return "\n".join(lines)


class QueueTransitionChecker(Checker):
    rule = RULE

    def __init__(self, queue_path: str, doc_path: str) -> None:
        self.queue_path = queue_path
        self.doc_path = doc_path
        self.states, self.initial, self.transitions, self.meanings = \
            load_transitions(queue_path)
        self.queue_visited = False
        self.queue_rel = "processing_chain_tpu_torch/serve/queue.py"
        #: declared edges actually implemented by an annotated write
        self.implemented: set = set()

    # ------------------------------------------------------------- scope

    def _in_scope(self, mod: ModuleSource) -> bool:
        if os.path.normpath(os.path.abspath(mod.path)) == \
                os.path.normpath(os.path.abspath(self.queue_path)):
            return True
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom):
                if any(a.name in _SCOPE_NAMES for a in node.names):
                    return True
            if isinstance(node, ast.ClassDef) and node.name in _SCOPE_NAMES:
                return True
        return False

    # ------------------------------------------------------------- visit

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        if not self.transitions or not self._in_scope(mod):
            return []
        is_queue_mod = os.path.normpath(os.path.abspath(mod.path)) == \
            os.path.normpath(os.path.abspath(self.queue_path))
        if is_queue_mod:
            self.queue_visited = True
            self.queue_rel = mod.rel
        findings: list[Finding] = []

        def add(node, message):
            f = mod.finding(self.rule, node, message,
                            symbol=symbol_of(mod.tree, node))
            if f:
                findings.append(f)

        for node in ast.walk(mod.tree):
            # --- record.state = <value> -----------------------------------
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                state_targets = [
                    t for t in targets
                    if isinstance(t, ast.Attribute) and t.attr == "state"
                ]
                if state_targets and node.value is not None:
                    self._check_write(mod, node, add)
            # --- JobRecord(..., state="…") --------------------------------
            if isinstance(node, ast.Call):
                name = node.func
                callee = name.id if isinstance(name, ast.Name) else (
                    name.attr if isinstance(name, ast.Attribute) else ""
                )
                if callee == "JobRecord":
                    for kw in node.keywords:
                        if kw.arg == "state":
                            if not (isinstance(kw.value, ast.Constant) and
                                    kw.value.value == self.initial):
                                add(node,
                                    "JobRecord must be constructed in the "
                                    f"declared initial state {self.initial!r}"
                                    " — later states only via declared "
                                    "transitions")
        # the dataclass default itself (queue.py): state must default to
        # INITIAL
        if is_queue_mod:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) and \
                        node.name == "JobRecord":
                    for stmt in node.body:
                        if isinstance(stmt, ast.AnnAssign) and \
                                isinstance(stmt.target, ast.Name) and \
                                stmt.target.id == "state" and \
                                stmt.value is not None:
                            if not (isinstance(stmt.value, ast.Constant) and
                                    stmt.value.value == self.initial):
                                add(stmt,
                                    "JobRecord.state default must be the "
                                    f"declared initial state {self.initial!r}")
        return findings

    def _check_write(self, mod: ModuleSource, node: ast.AST, add) -> None:
        value = node.value
        if not (isinstance(value, ast.Constant) and
                isinstance(value.value, str)):
            add(node,
                "queue state must be assigned as a string literal — a "
                "computed state cannot be checked against the declared "
                "transition table")
            return
        dst = value.value
        if dst not in self.states:
            add(node,
                f"{dst!r} is not a declared queue state "
                f"(serve/queue.py STATES: {', '.join(self.states)})")
            return
        edge = mod.queue_edges.get(node.lineno)
        if edge is None:
            add(node,
                f"undeclared queue state write (-> {dst!r}): annotate "
                "with '# queue-transition: <from> -> <to>' naming an "
                "edge declared in serve/queue.py TRANSITIONS")
            return
        sources, ann_dst = edge
        if ann_dst != dst:
            add(node,
                f"queue-transition annotation says '-> {ann_dst}' but the "
                f"assignment writes {dst!r}")
            return
        for src in sources:
            if src not in self.states:
                add(node,
                    f"{src!r} in the queue-transition annotation is not a "
                    "declared queue state")
            elif (src, dst) not in self.transitions:
                add(node,
                    f"edge {src} -> {dst} is not declared in "
                    "serve/queue.py TRANSITIONS — declare it (and teach "
                    "recovery/crashcheck about it) or fix the write")
            else:
                self.implemented.add((src, dst))

    # ---------------------------------------------------------- finalize

    def finalize(self) -> list[Finding]:
        findings: list[Finding] = []
        if not self.transitions or not self.queue_visited:
            return findings
        rel_queue = self.queue_rel
        # declaration sanity: the table every other consumer derives
        # from must be internally closed — an edge naming an undeclared
        # state (or an initial state outside STATES) would let writes
        # pass the per-site check while recovery and the crashcheck
        # harness have no idea the state exists
        if self.initial not in self.states:
            f = Finding(
                rule=self.rule, path=rel_queue, line=1,
                message=f"INITIAL {self.initial!r} is not in the declared "
                        "STATES tuple",
                symbol="table-unsound")
            findings.append(f)
        for a, b in sorted(self.transitions):
            for endpoint in (a, b):
                if endpoint not in self.states:
                    f = Finding(
                        rule=self.rule, path=rel_queue, line=1,
                        message=f"declared edge {a} -> {b} names "
                                f"{endpoint!r}, which is not in STATES — "
                                "declare the state or fix the edge",
                        symbol="table-unsound")
                    f.snippet = f"{a} -> {b}"
                    findings.append(f)
        for a, b in sorted(self.transitions - self.implemented):
            f = Finding(
                rule=self.rule, path=rel_queue, line=1,
                message=f"declared edge {a} -> {b} is implemented by no "
                        "annotated state write — stale table entry, "
                        "remove it or annotate its implementation",
                symbol="table-stale")
            f.snippet = f"{a} -> {b}"
            findings.append(f)
        # docs/SERVE.md drift, both ways (telemetry-doc discipline)
        try:
            with open(self.doc_path, encoding="utf-8") as fh:
                doc = fh.read()
        except OSError:
            doc = ""
        rel_doc = "docs/" + os.path.basename(self.doc_path)
        if _DOC_BEGIN in doc and _DOC_END in doc:
            block = doc.split(_DOC_BEGIN, 1)[1].split(_DOC_END, 1)[0]
            doc_edges = {
                (a, b) for a, b in _DOC_EDGE_RE.findall(block)
            }
            for a, b in sorted(self.transitions - doc_edges):
                f = Finding(
                    rule=self.rule, path=rel_doc, line=1,
                    message=f"declared edge {a} -> {b} is missing from the "
                            f"{rel_doc} transition table — re-render it "
                            "with `tools queue-crashcheck --render-table`",
                    symbol="doc-drift")
                f.snippet = f"{a} -> {b}"
                findings.append(f)
            for a, b in sorted(doc_edges - self.transitions):
                f = Finding(
                    rule=self.rule, path=rel_doc, line=1,
                    message=f"{rel_doc} documents edge {a} -> {b} but "
                            "serve/queue.py TRANSITIONS does not declare "
                            "it — stale doc or missing declaration",
                    symbol="doc-drift")
                f.snippet = f"{a} -> {b}"
                findings.append(f)
        else:
            f = Finding(
                rule=self.rule, path=rel_doc, line=1,
                message=f"{rel_doc} carries no queue-transition table "
                        f"(markers {_DOC_BEGIN} … {_DOC_END}) — render one "
                        "with `tools queue-crashcheck --render-table`",
                symbol="doc-drift")
            findings.append(f)
        return findings
