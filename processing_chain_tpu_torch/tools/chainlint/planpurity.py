"""plan-purity: hidden inputs must reach the plan, not just the bytes.

The store serves artifact BYTES by plan hash and chain-serve dedupes
across tenants by it, so any input that can influence what an encoder
writes while escaping the plan payload is a latent cache poisoner: two
processes with different knob values mint the same key for different
byte streams, and whichever commits first is served to everyone.

This checker makes that impossible to do silently. It traces
environment reads — ``os.environ.get``/``[]``/``in``, ``os.getenv``,
and *wrapper* functions whose env-key argument is a parameter
(``_env_int("PC_X")``) — through a statically-resolvable call graph
built over every linted module, and intersects them with two surfaces:

  * the **byte surface**: functions that (transitively) issue one of the
    registry's ``BYTE_SINK_CALLS`` (``VideoWriter``, ``run_bucket``, …)
    or are named in ``BYTE_PRODUCER_DEFS`` (the serve Executor
    ``run_batch`` protocol);
  * the **plan surface**: functions that construct plan payloads
    (methods named ``plan``, functions named ``*_plan``, or any function
    building a dict with an ``"op"`` key — the plan schema's marker).

An env input that reaches bytes must be declared in
``store/plan_schema.py`` (the registry, parsed by AST like
telemetry/catalog.py) as either

  * ``plan``   — and then it must ALSO reach the plan surface, so the
    plan field can never be deleted without re-opening the finding; or
  * ``exempt`` — and then every read site must carry a
    ``# plan-exempt: (reason)`` annotation; the claim is verified
    dynamically by the ``PC_PLAN_DEBUG`` recorder (utils/plandebug.py),
    which fails the suite on same-plan/different-bytes.

Resolution is deliberately conservative: only calls the AST can resolve
(same-module functions, ``self.``-methods of the enclosing class, and
package-relative imports) propagate taint, so the checker can miss but
never invent a path. Module-level reads (import-time constants) are out
of scope — they cannot vary between two jobs in one process.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Optional

from .core import Checker, Finding, ModuleSource
from .locks import dotted

RULE = "plan-purity"

#: fallback byte surface for trees without a registry module (self-tests
#: on scratch roots): the real tree always ships store/plan_schema.py,
#: whose declarations override these.
DEFAULT_SINKS = ("VideoWriter", "run_bucket", "write_batch",
                 "concat_video", "remux")
DEFAULT_PRODUCERS = ("run_batch",)


def load_schema(path: str) -> tuple[dict, tuple, tuple, tuple]:
    """(ENV_INPUTS, BYTE_SINK_CALLS, BYTE_PRODUCER_DEFS,
    OUT_OF_SCOPE_MODULES) parsed from the registry module's AST (never
    imported; works on any tree)."""
    env_inputs: dict = {}
    sinks: tuple = DEFAULT_SINKS
    producers: tuple = DEFAULT_PRODUCERS
    out_of_scope: tuple = ()
    if not os.path.isfile(path):
        return env_inputs, sinks, producers, out_of_scope
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            targets, value = [node.target.id], node.value
        else:
            continue
        if "ENV_INPUTS" in targets and isinstance(value, ast.Dict):
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Dict):
                    entry = {}
                    for ek, ev in zip(v.keys, v.values):
                        if isinstance(ek, ast.Constant) and \
                                isinstance(ev, ast.Constant):
                            entry[ek.value] = ev.value
                    env_inputs[k.value] = entry
        if "BYTE_SINK_CALLS" in targets:
            sinks = tuple(
                c.value for c in ast.walk(value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            )
        if "BYTE_PRODUCER_DEFS" in targets:
            producers = tuple(
                c.value for c in ast.walk(value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            )
        if "OUT_OF_SCOPE_MODULES" in targets:
            out_of_scope = tuple(
                c.value for c in ast.walk(value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            )
    return env_inputs, sinks, producers, out_of_scope


@dataclass
class _EnvRead:
    var: str
    line: int
    exempt_reason: Optional[str]  # a valid # plan-exempt annotation
    suppressed: bool              # a chainlint disable covers the site
    snippet: str


@dataclass
class _Func:
    """One function/method node of the interprocedural graph."""

    rel: str
    qual: str
    name: str
    enclosing_class: Optional[str]
    reads: list = field(default_factory=list)     # [_EnvRead]
    #: (dotted callee name, positional literal-str args (None for
    #: non-literals), call line)
    calls: list = field(default_factory=list)
    #: parameter index used as the env-var name in a read (wrapper
    #: functions like _env_int(name))
    param_env_index: Optional[int] = None
    contains_sink: bool = False
    is_plan_surface: bool = False
    is_producer: bool = False

    @property
    def key(self) -> tuple:
        return (self.rel, self.qual)


@dataclass
class _ModuleFacts:
    rel: str
    funcs: dict = field(default_factory=dict)      # qual -> _Func
    #: raw import records: (alias, candidate module parts tuple,
    #: imported name or None) — resolved in finalize against the set of
    #: visited modules
    imports: list = field(default_factory=list)
    plan_exempt: dict = field(default_factory=dict)
    #: suppression state carried past visit time, so reads synthesized
    #: at wrapper call sites in finalize honor site disables too
    disables: dict = field(default_factory=dict)
    file_disabled: bool = False

    def suppressed(self, line: int) -> bool:
        return self.file_disabled or RULE in self.disables.get(line, ())


def _is_environ(expr: ast.AST) -> bool:
    name = dotted(expr) or ""
    return name == "os.environ" or name.endswith(".environ") or \
        name == "environ"


class _Collector:
    """Per-module AST walk building _Func records with qualnames."""

    def __init__(self, mod: ModuleSource, facts: _ModuleFacts,
                 sinks: tuple, producers: tuple) -> None:
        self.mod = mod
        self.facts = facts
        self.sinks = sinks
        self.producers = producers

    def collect(self) -> None:
        self._imports(self.mod.tree)
        for node in self.mod.tree.body:
            self._visit(node, prefix=[], enclosing_class=None, func=None)

    # ------------------------------------------------------------ imports

    def _imports(self, tree: ast.Module) -> None:
        pkg_parts = self.facts.rel.split("/")[:-1]  # module's package dir
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.level:
                if node.level - 1 > len(pkg_parts):
                    continue
                base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
            else:
                base = []
            mod_parts = (node.module or "").split(".") if node.module else []
            mod_parts = [p for p in mod_parts if p]
            for alias in node.names:
                if alias.name == "*":
                    continue
                self.facts.imports.append((
                    alias.asname or alias.name,
                    tuple(base + mod_parts),
                    alias.name,
                ))

    # -------------------------------------------------------------- walk

    def _visit(self, node: ast.AST, prefix: list,
               enclosing_class: Optional[str], func: Optional[_Func]) -> None:
        if isinstance(node, ast.ClassDef):
            for child in node.body:
                self._visit(child, prefix + [node.name], node.name, None)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = ".".join(prefix + [node.name])
            f = _Func(
                rel=self.facts.rel, qual=qual, name=node.name,
                enclosing_class=enclosing_class,
                is_producer=node.name in self.producers,
                is_plan_surface=(
                    node.name == "plan" or node.name.endswith("_plan")
                ),
            )
            self.facts.funcs[qual] = f
            params = [a.arg for a in (
                node.args.posonlyargs + node.args.args
            )]
            f._params = params
            for child in node.body:
                self._visit(child, prefix + [node.name], enclosing_class, f)
            return
        if func is not None:
            self._inspect(node, func)
        for child in ast.iter_child_nodes(node):
            self._visit(child, prefix, enclosing_class, func)

    # ----------------------------------------------------------- inspect

    def _read(self, func: _Func, var: str, line: int) -> None:
        func.reads.append(_EnvRead(
            var=var, line=line,
            exempt_reason=self.mod.plan_exempt.get(line),
            suppressed=self.mod.disabled(RULE, line),
            snippet=self.mod.line_text(line),
        ))

    def _inspect(self, node: ast.AST, func: _Func) -> None:
        if isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            tail = name.split(".")[-1]
            if tail in self.sinks:
                func.contains_sink = True
            if name == "os.getenv" or name.endswith("environ.get") or \
                    name == "getenv":
                if node.args:
                    first = node.args[0]
                    if isinstance(first, ast.Constant) and \
                            isinstance(first.value, str):
                        self._read(func, first.value, node.lineno)
                    elif isinstance(first, ast.Name) and \
                            first.id in getattr(func, "_params", ()):
                        func.param_env_index = \
                            getattr(func, "_params").index(first.id)
            else:
                lits = tuple(
                    a.value if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) else None
                    for a in node.args[:6]
                )
                func.calls.append((name, lits, node.lineno))
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and _is_environ(node.value):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                self._read(func, sl.value, node.lineno)
        elif isinstance(node, ast.Compare) and node.comparators and \
                _is_environ(node.comparators[0]) and \
                any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
            if isinstance(node.left, ast.Constant) and \
                    isinstance(node.left.value, str):
                self._read(func, node.left.value, node.lineno)
        elif isinstance(node, ast.Constant) and node.value == "op":
            # a dict/subscript key "op" marks plan-payload construction
            # (store/plan_schema: every plan carries its op name)
            func.is_plan_surface = True


class PlanPurityChecker(Checker):
    rule = RULE

    def __init__(self, schema_path: str) -> None:
        self.schema_path = schema_path
        (self.env_inputs, self.sinks, self.producers,
         self.out_of_scope) = load_schema(schema_path)
        self.modules: dict[str, _ModuleFacts] = {}
        self.schema_rel: Optional[str] = None
        self.schema_visited = False

    def visit_module(self, mod: ModuleSource) -> list[Finding]:
        facts = _ModuleFacts(rel=mod.rel)
        facts.plan_exempt = dict(mod.plan_exempt)
        facts.disables = {ln: set(rs) for ln, rs in mod.disables.items()}
        facts.file_disabled = RULE in mod.file_disables
        _Collector(mod, facts, self.sinks, self.producers).collect()
        self.modules[mod.rel] = facts
        if os.path.normpath(os.path.abspath(mod.path)) == \
                os.path.normpath(os.path.abspath(self.schema_path)):
            self.schema_visited = True
            self.schema_rel = mod.rel
        return []

    # ---------------------------------------------------------- finalize

    def _resolve_imports(self) -> dict:
        """alias maps per module: alias -> ("mod", rel) | ("func", key)."""
        visited = set(self.modules)
        out: dict = {}
        for rel, facts in self.modules.items():
            amap: dict = {}
            for alias, base_parts, name in facts.imports:
                as_mod = "/".join(base_parts + (name,)) + ".py"
                holder = "/".join(base_parts) + ".py" if base_parts else None
                if as_mod in visited:
                    amap[alias] = ("mod", as_mod)
                elif holder and holder in visited and \
                        name in self.modules[holder].funcs:
                    amap[alias] = ("func", (holder, name))
            out[rel] = amap
        return out

    def _build_graph(self) -> tuple[dict, dict]:
        """(edges: key -> set of callee keys, funcs: key -> _Func); also
        propagates wrapper env reads (param-named keys) to call sites."""
        funcs: dict = {}
        for facts in self.modules.values():
            for f in facts.funcs.values():
                funcs[f.key] = f
        aliases = self._resolve_imports()
        edges: dict = {k: set() for k in funcs}
        for rel, facts in self.modules.items():
            amap = aliases.get(rel, {})
            local = facts.funcs
            for f in facts.funcs.values():
                for name, lits, line in f.calls:
                    target = None
                    parts = name.split(".") if name else []
                    if len(parts) == 1:
                        # nearest enclosing scope first (nested helper
                        # siblings), then module level, then imports
                        pref = f.qual.split(".")[:-1]
                        while target is None:
                            cand = ".".join(pref + [parts[0]])
                            if cand in local:
                                target = (rel, cand)
                            if not pref:
                                break
                            pref = pref[:-1]
                        if target is None and \
                                amap.get(parts[0], ("", ""))[0] == "func":
                            target = amap[parts[0]][1]
                    elif len(parts) == 2:
                        head, meth = parts
                        if head in ("self", "cls") and f.enclosing_class:
                            cand = f"{f.enclosing_class}.{meth}"
                            if cand in local:
                                target = (rel, cand)
                        elif amap.get(head, ("", ""))[0] == "mod":
                            mod_rel = amap[head][1]
                            if meth in self.modules[mod_rel].funcs:
                                target = (mod_rel, meth)
                        elif amap.get(head, ("", ""))[0] == "func":
                            pass  # attribute on an imported function: skip
                    if target is not None and target in funcs:
                        edges[f.key].add(target)
                        callee = funcs[target]
                        if callee.param_env_index is not None and \
                                len(lits) > callee.param_env_index and \
                                lits[callee.param_env_index] is not None:
                            var = lits[callee.param_env_index]
                            mod_facts = self.modules[rel]
                            f.reads.append(_EnvRead(
                                var=var, line=line,
                                exempt_reason=mod_facts.plan_exempt.get(line),
                                suppressed=mod_facts.suppressed(line),
                                snippet="",
                            ))
        return edges, funcs

    def finalize(self) -> list[Finding]:
        if not self.modules:
            return []
        edges, funcs = self._build_graph()

        # transitive closure over callees: env reads + sink reachability.
        # ITERATIVE FIXPOINT, not memoized DFS — a memo filled while a
        # cycle was cut open records truncated answers for every node on
        # the cycle, silently dropping reads/sinks in mutually recursive
        # call chains. The graph is a few thousand nodes at lint
        # cadence; iterating to fixpoint is cheap and cycle-correct.
        reads: dict = {k: {r.var for r in f.reads}
                       for k, f in funcs.items()}
        sink: dict = {k: f.contains_sink or f.is_producer
                      for k, f in funcs.items()}
        changed = True
        while changed:
            changed = False
            for key in funcs:
                for callee in edges.get(key, ()):
                    if callee not in funcs:
                        continue
                    if not reads[callee] <= reads[key]:
                        reads[key] |= reads[callee]
                        changed = True
                    if sink[callee] and not sink[key]:
                        sink[key] = True
                        changed = True

        tainted: set = set()
        plan_vars: set = set()
        for key, f in funcs.items():
            if sink[key]:
                tainted |= reads[key]
            if f.is_plan_surface:
                plan_vars |= reads[key]

        findings: list[Finding] = []

        def report(f: _Func, read: _EnvRead, message: str) -> None:
            if read.suppressed:
                return
            finding = Finding(rule=self.rule, path=f.rel, line=read.line,
                              message=message, symbol=f.qual)
            finding.snippet = read.snippet or f"{read.var}"
            findings.append(finding)

        seen_vars: set = set()
        for f in funcs.values():
            out_of_scope = any(
                f.rel == p or f.rel.startswith(p) for p in self.out_of_scope
            )
            for read in f.reads:
                seen_vars.add(read.var)
                if read.var not in tainted or out_of_scope:
                    continue
                decl = self.env_inputs.get(read.var)
                if decl is None:
                    report(f, read,
                         f"hidden input {read.var!r} can reach artifact "
                         "bytes but is not declared in "
                         "store/plan_schema.py — fold it into the plan "
                         "payload (status 'plan') or declare it 'exempt' "
                         "and annotate the read '# plan-exempt: (reason)'")
                elif decl.get("status") == "plan":
                    if read.var not in plan_vars:
                        report(f, read,
                             f"{read.var!r} is declared plan-covered in "
                             "store/plan_schema.py but no plan "
                             "construction reads it — the plan field is "
                             "missing or went stale")
                elif decl.get("status") == "covered":
                    if not decl.get("via") or not decl.get("reason"):
                        report(f, read,
                             f"{read.var!r} is declared 'covered' in "
                             "store/plan_schema.py but the entry names no "
                             "'via'/'reason' — say which derived plan "
                             "value captures it")
                elif decl.get("status") == "exempt":
                    if read.exempt_reason is None:
                        report(f, read,
                             f"{read.var!r} is declared exempt in "
                             "store/plan_schema.py but this byte-reaching "
                             "read carries no '# plan-exempt: (reason)' "
                             "annotation")
                else:
                    report(f, read,
                         f"{read.var!r} has unknown status "
                         f"{decl.get('status')!r} in store/plan_schema.py "
                         "(expected 'plan' or 'exempt')")

        # registry hygiene, full-tree runs only (the schema module was
        # among the linted files): a declared input nobody reads is a
        # stale entry — mirror the baseline's stale-entry discipline
        if self.schema_visited and self.schema_rel:
            for var in sorted(set(self.env_inputs) - seen_vars):
                f_ = Finding(
                    rule=self.rule, path=self.schema_rel, line=1,
                    message=f"{var!r} is declared in store/plan_schema.py "
                            "but no linted module reads it — stale "
                            "declaration, remove it",
                    symbol="schema-stale")
                f_.snippet = var
                findings.append(f_)
        return findings
