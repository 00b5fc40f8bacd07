"""Telemetry-name registry: call sites ↔ catalog ↔ docs, all in sync.

Names are parsed out of ``telemetry/catalog.py`` by AST (not imported),
so the linter works on any tree — including the test fixtures. Three
obligations, all under the one ``telemetry-name`` rule:

  1. every metric-constructor literal (``counter("chain_…")`` etc.) is
     declared in ``METRICS`` with the same kind, and every ``emit("…")``
     literal is declared in ``EVENTS``;
  2. dynamic (non-literal) names are findings — a name the catalog can't
     see is a name the doc drift check can't protect;
  3. the catalog and docs/TELEMETRY.md agree both ways: every catalog
     name appears in the doc, every ``chain_[a-z_]*`` token in the doc
     appears in the catalog — and the same for alert rules: every
     ``ALERT_RULES`` key is documented as an ``alert:<name>`` token,
     every ``alert:<name>`` token resolves to a declared rule.

The registry plumbing itself (telemetry/metrics.py, events.py, the
``telemetry/__init__`` re-exports) is allowlisted: its parameters ARE
the dynamic names.
"""

from __future__ import annotations

import ast
import os
import re

from .core import Checker, Finding, ModuleSource, symbol_of
from .locks import dotted

_METRIC_CTORS = ("counter", "gauge", "histogram")
#: registry plumbing whose name arguments are parameters by design: these
#: modules beside the configured catalog are allow-listed
_ALLOW_NAMES = ("metrics.py", "events.py", "__init__.py", "catalog.py")
#: emit receivers that are the chain event log (`ln.emit(...)` on a
#: pipeline lane is NOT an event emission)
_EMIT_RECEIVERS = ("telemetry", "tm", "events", "EVENTS")

_DOC_NAME_RE = re.compile(r"`(chain_[a-z0-9_]+)`")
_DOC_ALERT_RE = re.compile(r"`alert:([a-z0-9_]+)`")


def load_catalog(path: str) -> tuple[dict, set, set]:
    """(METRICS dict, EVENTS set, ALERT_RULES names) parsed from the
    catalog module's AST."""
    metrics: dict = {}
    events: set = set()
    rules: set = set()
    if not os.path.isfile(path):
        return metrics, events, rules
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            targets = [node.target.id]
            value = node.value
        else:
            continue
        if "METRICS" in targets and isinstance(value, ast.Dict):
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                    metrics[k.value] = v.value
        if "EVENTS" in targets:
            for sub in ast.walk(value):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                    events.add(sub.value)
        if "ALERT_RULES" in targets and isinstance(value, ast.Dict):
            for k in value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    rules.add(k.value)
    return metrics, events, rules


class TelemetryNameChecker(Checker):
    rule = "telemetry-name"

    def __init__(self, catalog_path: str, doc_path: str, root: str) -> None:
        self.catalog_path = catalog_path
        self.doc_path = doc_path
        self.metrics, self.events, self.rules = load_catalog(catalog_path)
        #: the catalog's repo-relative path (the default config's is
        #: processing_chain_tpu_torch/telemetry/catalog.py)
        self.rel_cat = os.path.relpath(catalog_path, root).replace(os.sep, "/")
        pkg = self.rel_cat.rpartition("/")[0]
        self.allow_files = tuple(
            f"{pkg}/{name}" if pkg else name for name in _ALLOW_NAMES)

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        if mod.rel in self.allow_files or not (self.metrics or self.events):
            return []
        findings: list[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func) or ""
            last = name.split(".")[-1]
            if last in _METRIC_CTORS and node.args:
                first = node.args[0]
                if isinstance(first, ast.Constant) and isinstance(first.value, str):
                    lit = first.value
                    if not lit.startswith("chain_"):
                        continue  # a foreign registry / test helper
                    if lit not in self.metrics:
                        f = mod.finding(
                            self.rule, node,
                            f"metric {lit!r} is not declared in "
                            "telemetry/catalog.py — declare it there and "
                            "in docs/TELEMETRY.md",
                            symbol=symbol_of(mod.tree, node))
                        if f:
                            findings.append(f)
                    elif self.metrics[lit] != last:
                        f = mod.finding(
                            self.rule, node,
                            f"metric {lit!r} is declared as "
                            f"{self.metrics[lit]} in the catalog but "
                            f"constructed here as {last}",
                            symbol=symbol_of(mod.tree, node))
                        if f:
                            findings.append(f)
            if last == "emit":
                recv = name.split(".")[:-1]
                if recv and recv[-1] not in _EMIT_RECEIVERS:
                    continue  # someone else's emit (pipeline lanes, logging)
                if not node.args:
                    continue
                first = node.args[0]
                if isinstance(first, ast.Constant) and isinstance(first.value, str):
                    if first.value not in self.events:
                        f = mod.finding(
                            self.rule, node,
                            f"event {first.value!r} is not declared in "
                            "telemetry/catalog.py EVENTS — declare it "
                            "there and in docs/TELEMETRY.md",
                            symbol=symbol_of(mod.tree, node))
                        if f:
                            findings.append(f)
                else:
                    f = mod.finding(
                        self.rule, node,
                        "dynamic event name — emit() literals are the "
                        "contract the catalog and doc drift checks "
                        "protect; use a declared literal",
                        symbol=symbol_of(mod.tree, node))
                    if f:
                        findings.append(f)
        return findings

    def finalize(self) -> list[Finding]:
        findings: list[Finding] = []
        if not (self.metrics or self.events or self.rules):
            return findings
        try:
            with open(self.doc_path, encoding="utf-8") as f:
                doc = f.read()
        except OSError:
            f_ = Finding(
                rule=self.rule, path=os.path.basename(self.doc_path), line=1,
                message=f"telemetry doc {self.doc_path} is missing — the "
                        "catalog has nothing to agree with",
                symbol="doc-drift")
            return [f_]
        doc_lines = doc.splitlines()
        rel_doc = os.path.basename(os.path.dirname(self.doc_path) or ".") \
            + "/" + os.path.basename(self.doc_path)
        rel_cat = self.rel_cat

        def _doc_line(tok: str) -> int:
            for i, line in enumerate(doc_lines, 1):
                if tok in line:
                    return i
            return 1

        for name in sorted(self.metrics):
            if name not in doc:
                f_ = Finding(
                    rule=self.rule, path=rel_cat, line=1,
                    message=f"metric {name!r} is in the catalog but not "
                            "documented in docs/TELEMETRY.md",
                    symbol="doc-drift")
                f_.snippet = name
                findings.append(f_)
        for name in sorted(self.events):
            if name not in doc:
                f_ = Finding(
                    rule=self.rule, path=rel_cat, line=1,
                    message=f"event {name!r} is in the catalog but not "
                            "documented in docs/TELEMETRY.md",
                    symbol="doc-drift")
                f_.snippet = name
                findings.append(f_)
        for name in sorted(self.rules):
            if f"alert:{name}" not in doc:
                f_ = Finding(
                    rule=self.rule, path=rel_cat, line=1,
                    message=f"alert rule {name!r} is in the catalog but "
                            "not documented in docs/TELEMETRY.md (name "
                            "it as `alert:" + name + "`)",
                    symbol="doc-drift")
                f_.snippet = name
                findings.append(f_)
        for tok in sorted(set(_DOC_ALERT_RE.findall(doc))):
            if tok not in self.rules:
                f_ = Finding(
                    rule=self.rule, path=rel_doc,
                    line=_doc_line(f"alert:{tok}"),
                    message=f"docs/TELEMETRY.md names alert rule {tok!r} "
                            "but telemetry/catalog.py ALERT_RULES does "
                            "not declare it — stale doc or missing "
                            "declaration",
                    symbol="doc-drift")
                f_.snippet = tok
                findings.append(f_)
        for tok in sorted(set(_DOC_NAME_RE.findall(doc))):
            base = tok
            # the doc's histogram tables legitimately reference the
            # derived _bucket/_sum/_count series
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix) and base[: -len(suffix)] in self.metrics:
                    base = base[: -len(suffix)]
            if base not in self.metrics:
                f_ = Finding(
                    rule=self.rule, path=rel_doc, line=_doc_line(tok),
                    message=f"docs/TELEMETRY.md names {tok!r} but the "
                            "catalog does not declare it — stale doc or "
                            "missing declaration",
                    symbol="doc-drift")
                f_.snippet = tok
                findings.append(f_)
        return findings
