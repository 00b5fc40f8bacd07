"""chainlint driver: file model, disable comments, checker protocol.

The analysis unit is a ``ModuleSource`` — path + text + AST + the
comment map (extracted with ``tokenize`` so strings that merely look
like comments can't confuse the suppression logic). Checkers are small
classes over that model; cross-file rules (the lock-order graph) get a
``finalize()`` pass after every module has been visited.

Suppression contract (docs/LINT.md):

  * ``# chainlint: disable=<rule>[,<rule>…] (<reason>)`` — on the
    offending line, or alone on the line directly above it. The reason
    is REQUIRED: a disable without one is itself a finding
    (``bad-disable``), so exemptions stay auditable.
  * ``# chainlint: disable-file=<rule> (<reason>)`` — module-wide, must
    appear in the first 20 lines.

Annotations (consumed by individual checkers, never suppressions):

  * ``# guarded-by: <lock>``          declares a lock-protected attribute
  * ``# holds-lock: <lock>``          marks a function whose callers hold
                                      the lock already
  * ``# chainlint: ownership-transfer (<reason>)`` marks a statement that
    hands a pooled buffer to another owner
  * ``# plan-exempt: (<reason>)``     marks an environment-input read whose
    value never alters artifact bytes (plan-purity rule; the input must
    also be declared ``exempt`` in store/plan_schema.py)
  * ``# queue-transition: <from>[|<from>…] -> <to>`` declares which edge
    of the serve queue state machine a ``.state`` assignment implements
    (queue-transition rule; the edge must exist in serve/queue.py's
    declared TRANSITIONS table)
"""

from __future__ import annotations

import ast
import hashlib
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

#: every rule chainlint knows; ``bad-disable`` guards the suppression
#: syntax itself and can never be disabled
ALL_RULES = (
    "lock-guard",
    "lock-order",
    "bufpool-ownership",
    "subprocess-hygiene",
    "atomic-write",
    "telemetry-name",
    "plan-purity",
    "queue-transition",
    "bad-disable",
)

_DISABLE_RE = re.compile(
    r"#\s*chainlint:\s*(disable|disable-file)\s*=\s*"
    r"(?P<rules>[a-z-]+(?:\s*,\s*[a-z-]+)*)"
    r"(?P<reason>\s*\(.*\))?"
)
_TRANSFER_RE = re.compile(
    r"#\s*chainlint:\s*ownership-transfer(?P<reason>\s*\(.*\))?"
)
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>[A-Za-z_][\w.]*)")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*(?P<lock>[A-Za-z_][\w.]*)")
_PLAN_EXEMPT_RE = re.compile(r"#\s*plan-exempt:(?P<reason>\s*\(.*\))?")
_QUEUE_EDGE_RE = re.compile(
    r"#\s*queue-transition:\s*"
    r"(?P<src>[a-z]+(?:\s*\|\s*[a-z]+)*)\s*->\s*(?P<dst>[a-z]+)"
)


@dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    symbol: str = ""  # enclosing function/class, for stable baselines

    @property
    def snippet(self) -> str:
        return getattr(self, "_snippet", "")

    @snippet.setter
    def snippet(self, value: str) -> None:
        self._snippet = value.strip()[:160]

    def fingerprint(self) -> str:
        """Line-number-free identity: baselines must survive unrelated
        edits above a grandfathered site, so the key is the rule + file
        + enclosing symbol + normalized source line, not the line no."""
        basis = f"{self.rule}|{self.path}|{self.symbol}|{self.snippet}"
        return hashlib.sha1(basis.encode()).hexdigest()[:12]

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym}: {self.message}"


@dataclass
class ModuleSource:
    """A parsed target file plus everything checkers ask of it."""

    path: str
    rel: str
    text: str
    tree: ast.Module
    lines: list[str]
    #: {line no -> comment text} (tokenize-accurate)
    comments: dict[int, str] = field(default_factory=dict)
    #: {line no -> rules disabled on that line}
    disables: dict[int, set] = field(default_factory=dict)
    file_disables: set = field(default_factory=set)
    #: disables whose reason is missing (line -> raw comment)
    bad_disables: list = field(default_factory=list)
    #: {line no -> lock name} from # guarded-by:
    guarded_by: dict[int, str] = field(default_factory=dict)
    #: {line no -> lock name} from # holds-lock:
    holds_lock: dict[int, str] = field(default_factory=dict)
    #: lines carrying a valid ownership-transfer annotation
    transfer_lines: set = field(default_factory=set)
    #: {line no -> reason} from valid # plan-exempt: (reason) annotations
    plan_exempt: dict[int, str] = field(default_factory=dict)
    #: {line no -> (sources tuple, destination)} from # queue-transition:
    queue_edges: dict[int, tuple] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def disabled(self, rule: str, lineno: int) -> bool:
        if rule in self.file_disables:
            return True
        return rule in self.disables.get(lineno, ())

    def finding(self, rule: str, node_or_line, message: str,
                symbol: str = "") -> Optional[Finding]:
        """Build a Finding unless a disable comment covers it."""
        lineno = getattr(node_or_line, "lineno", node_or_line)
        if rule != "bad-disable" and self.disabled(rule, lineno):
            return None
        f = Finding(rule=rule, path=self.rel, line=lineno,
                    message=message, symbol=symbol)
        f.snippet = self.line_text(lineno)
        return f


def _extract_comments(text: str) -> dict[int, str]:
    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # the ast parse already succeeded; comments are best-effort
    return out


def _comment_effective_lines(comments: dict[int, str],
                             lines: list[str]) -> Iterable[tuple[int, str, int]]:
    """Yield (effective code line, comment text, comment line). A comment
    sharing a line with code applies to that line; a standalone comment
    line applies to the next line (annotations sit above long calls)."""
    for lineno, comment in comments.items():
        code = lines[lineno - 1][: lines[lineno - 1].find("#")].strip() \
            if lineno <= len(lines) else ""
        effective = lineno if code else lineno + 1
        yield effective, comment, lineno


def load_module(path: str, root: str) -> Optional[ModuleSource]:
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return None  # the compileall CI gate owns syntax errors
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    mod = ModuleSource(
        path=path, rel=rel, text=text, tree=tree,
        lines=text.splitlines(),
    )
    mod.comments = _extract_comments(text)
    for eff, comment, cline in _comment_effective_lines(mod.comments, mod.lines):
        m = _DISABLE_RE.search(comment)
        if m:
            rules = {r.strip() for r in m.group("rules").split(",")}
            unknown = rules - set(ALL_RULES)
            reason = (m.group("reason") or "").strip("() \t")
            if not reason or unknown:
                why = (f"unknown rule(s) {sorted(unknown)}" if unknown
                       else "missing (reason)")
                mod.bad_disables.append((cline, comment.strip(), why))
            elif m.group(1) == "disable-file":
                if cline <= 20:
                    mod.file_disables |= rules
                else:
                    mod.bad_disables.append(
                        (cline, comment.strip(),
                         "disable-file must sit in the first 20 lines"))
            else:
                mod.disables.setdefault(eff, set()).update(rules)
        m = _TRANSFER_RE.search(comment)
        if m:
            if (m.group("reason") or "").strip("() \t"):
                mod.transfer_lines.add(eff)
            else:
                mod.bad_disables.append(
                    (cline, comment.strip(), "missing (reason)"))
        m = _GUARDED_RE.search(comment)
        if m:
            mod.guarded_by[eff] = m.group("lock")
        m = _HOLDS_RE.search(comment)
        if m:
            mod.holds_lock[eff] = m.group("lock")
        m = _PLAN_EXEMPT_RE.search(comment)
        if m:
            reason = (m.group("reason") or "").strip("() \t")
            if reason:
                mod.plan_exempt[eff] = reason
            else:
                mod.bad_disables.append(
                    (cline, comment.strip(), "missing (reason)"))
        m = _QUEUE_EDGE_RE.search(comment)
        if m:
            sources = tuple(
                s.strip() for s in m.group("src").split("|") if s.strip()
            )
            mod.queue_edges[eff] = (sources, m.group("dst"))
    return mod


class Checker:
    """Base checker: per-module visit plus an optional cross-file pass."""

    rule: str = ""

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        return []

    def finalize(self) -> list[Finding]:
        return []


@dataclass
class LintConfig:
    root: str
    targets: Sequence[str] = ()
    rules: Optional[set] = None  # None = all
    #: the port's own registries; the docs are the reference package's
    #: (read only: the port's catalog declares a subset of their names)
    catalog_path: str = "processing_chain_tpu_torch/telemetry/catalog.py"
    doc_path: str = "docs/TELEMETRY.md"
    plan_schema_path: str = "processing_chain_tpu_torch/store/plan_schema.py"
    queue_module_path: str = "processing_chain_tpu_torch/serve/queue.py"
    serve_doc_path: str = "docs/SERVE.md"

    #: directories whose findings are skipped wholesale (fixtures carry
    #: deliberate violations; vendored/test trees are out of contract)
    EXCLUDE_PARTS = ("__pycache__", ".git", "tests/chainlint_fixtures")

    def default_targets(self) -> list[str]:
        return [
            os.path.join(self.root, "processing_chain_tpu_torch"),
            os.path.join(self.root, "chip_smoke.py"),
        ]

    def iter_files(self) -> Iterable[str]:
        targets = list(self.targets) or self.default_targets()
        for target in targets:
            if os.path.isfile(target):
                if target.endswith(".py"):
                    yield target
                continue
            for dirpath, dirnames, filenames in os.walk(target):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                rel = os.path.relpath(dirpath, self.root).replace(os.sep, "/")
                if any(part in rel for part in self.EXCLUDE_PARTS):
                    continue
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def symbol_of(tree: ast.Module, node: ast.AST) -> str:
    """Dotted enclosing-scope name of `node` (Class.method), for stable
    baseline keys. Linear scan — fine at lint cadence."""
    path: list[str] = []

    def descend(parent: ast.AST, trail: list[str]) -> bool:
        for child in ast.iter_child_nodes(parent):
            if child is node:
                path.extend(trail)
                own = getattr(node, "name", None)
                if isinstance(node, (ast.ClassDef, ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and own:
                    path.append(own)
                return True
            if isinstance(child, (ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                if descend(child, trail + [child.name]):
                    return True
            else:
                if descend(child, trail):
                    return True
        return False

    descend(tree, [])
    return ".".join(path)


def build_checkers(cfg: LintConfig) -> list[Checker]:
    from . import (
        atomic, locks, ownership, planpurity, queue_transitions, subproc,
        telemetry_names,
    )

    checkers: list[Checker] = [
        locks.LockGuardChecker(),
        locks.LockOrderChecker(),
        ownership.BufpoolOwnershipChecker(),
        subproc.SubprocessHygieneChecker(),
        atomic.AtomicWriteChecker(),
        telemetry_names.TelemetryNameChecker(
            catalog_path=os.path.join(cfg.root, cfg.catalog_path),
            doc_path=os.path.join(cfg.root, cfg.doc_path),
            root=cfg.root,
        ),
        planpurity.PlanPurityChecker(
            schema_path=os.path.join(cfg.root, cfg.plan_schema_path),
        ),
        queue_transitions.QueueTransitionChecker(
            queue_path=os.path.join(cfg.root, cfg.queue_module_path),
            doc_path=os.path.join(cfg.root, cfg.serve_doc_path),
        ),
    ]
    if cfg.rules is not None:
        checkers = [c for c in checkers if c.rule in cfg.rules]
    return checkers


def run_lint(cfg: LintConfig) -> list[Finding]:
    """Run every enabled checker over the configured tree; returns the
    raw (pre-baseline) findings, sorted by location."""
    checkers = build_checkers(cfg)
    findings: list[Finding] = []
    want_bad_disable = cfg.rules is None or "bad-disable" in cfg.rules
    for path in cfg.iter_files():
        mod = load_module(path, cfg.root)
        if mod is None:
            continue
        if want_bad_disable:
            for cline, comment, why in mod.bad_disables:
                f = mod.finding(
                    "bad-disable", cline,
                    f"malformed chainlint annotation ({why}): {comment}")
                if f:
                    findings.append(f)
        for checker in checkers:
            findings.extend(checker.visit_module(mod))
    for checker in checkers:
        findings.extend(checker.finalize())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
