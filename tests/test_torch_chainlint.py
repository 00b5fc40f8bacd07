"""The port's own gates (processing_chain_tpu_torch/tools/chainlint, the
port's copy of processing_chain_tpu/tools/chainlint):

  * parity: on every case module of tests/chainlint_fixtures, the JAX
    package's `run_lint` and the port's give identical findings, with the
    port's LintConfig pointed at the JAX registries (it reads those files
    and imports nothing of the JAX package);
  * the rules' contracts of tests/test_chainlint.py, as parametrised cases
    run through both linters, and the CLI's exit codes, baseline update
    and expiry;
  * the port's gate: bare, `python -m processing_chain_tpu_torch tools
    chain-lint` is clean on the port's registries and baseline without
    jax, and seeded violations in a copy of the port fail it by name;
  * the bufpool counters the gate found missing: the port's pool counts
    what JAX's counts, and the port's run-report shows the pool line;
  * the runtime recorders of the port (utils/lockdebug, utils/plandebug)
    over the port's serve `wave` path, which tests/conftest.py's session
    gate does not read.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from processing_chain_tpu import telemetry as jtm
from processing_chain_tpu.io.bufpool import BufferPool as JBufferPool
from processing_chain_tpu.tools.chainlint.core import LintConfig as JLintConfig
from processing_chain_tpu.tools.chainlint.core import run_lint as jrun_lint
from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.io.bufpool import BufferPool
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.telemetry import report as treport
from processing_chain_tpu_torch.telemetry.metrics import REGISTRY
from processing_chain_tpu_torch.tools.chainlint import baseline as bl
from processing_chain_tpu_torch.tools.chainlint import cli as lint_cli
from processing_chain_tpu_torch.tools.chainlint import planpurity
from processing_chain_tpu_torch.tools.chainlint.core import LintConfig, load_module, run_lint
from processing_chain_tpu_torch.utils import lockdebug, plandebug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "chainlint_fixtures")
CASES = sorted(n for n in os.listdir(FIXTURES) if n.endswith("_cases.py"))
#: the JAX package's registry paths, as its LintConfig defaults name them
JAX_REGISTRIES = {
    k: getattr(JLintConfig(root=REPO), k)
    for k in ("catalog_path", "doc_path", "plan_schema_path", "queue_module_path",
              "serve_doc_path")
}
PORT_QUEUE = os.path.join(REPO, "processing_chain_tpu_torch", "serve", "queue.py")
SERVE_DOC = os.path.join(REPO, "docs", "SERVE.md")
#: the 8 doc-drift names the port's baseline grandfathers, by the Queue A
#: item (ROADMAP.md) whose port declares them (the media boundary's io and
#: adoption names, and io/framesizes' memo counter, are declared in the
#: port's catalog)
PENDING = {
    "4b": ("chain_priors_extract_total", "chain_priors_cache_hits_total",
           "chain_priors_frames_total", "chain_priors_mvs_total",
           "chain_priors_extract_seconds"),
    11: ("chain_media_faults_injected_total", "chain_media_deadline_expired_total",
         "chain_isolated_decodes_total"),
}


def _key(findings):
    return [(f.rule, f.path, f.line, f.symbol, f.message) for f in findings]


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("case", CASES)
def test_fixture_findings_equal_the_jax_linter(case):
    target = os.path.join(FIXTURES, case)
    want = jrun_lint(JLintConfig(root=REPO, targets=[target]))
    got = run_lint(LintConfig(root=REPO, targets=[target], **JAX_REGISTRIES))
    assert want, f"{case}: the fixture raised no finding"
    assert _key(got) == _key(want)


def test_the_fixture_cases_are_the_eight_rule_families():
    assert [c[: -len("_cases.py")] for c in CASES] == [
        "atomic", "lockorder", "locks", "ownership", "planpurity", "queue_transition",
        "subproc", "telemetry"]


# ------------------------------------------------------------------- rules


#: (id, source, rules, extra LintConfig fields, findings wanted by rule)
RULE_CASES = [
    ("guard-init-exempt", """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._data = []  # guarded-by: _lock
                self._data.append(0)
        """, ["lock-guard"], {}, {}),
    ("reasonless-disable-does-not-suppress", """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._data = []  # guarded-by: _lock

            def bad(self):
                # chainlint: disable=lock-guard
                return self._data
        """, None, {}, {"lock-guard": 1, "bad-disable": 1}),
    ("unknown-rule-in-disable", """
        x = 1  # chainlint: disable=made-up-rule (because)
        """, None, {}, {"bad-disable": 1}),
    ("lock-order-consistent", """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def one():
            with A:
                with B:
                    pass

        def two():
            with A:
                with B:
                    pass
        """, ["lock-order"], {}, {}),
    ("lock-order-inverted", """
        import threading

        A_LOCK = threading.Lock()
        B_LOCK = threading.Lock()

        def one():
            with A_LOCK:
                with B_LOCK:
                    pass

        def two():
            with B_LOCK:
                with A_LOCK:
                    pass
        """, ["lock-order"], {}, {"lock-order": 1}),
    ("bufpool-early-return", """
        def f(pool, shape, flag):
            block = pool.acquire(shape)
            if flag:
                return None
            pool.release(block)
        """, ["bufpool-ownership"], {}, {"bufpool-ownership": 1}),
    ("bufpool-release-in-loop", """
        def f(pool, shapes):
            for shape in shapes:
                block = pool.acquire(shape)
                use(block)
                pool.release(block)
        """, ["bufpool-ownership"], {}, {}),
    ("subprocess-direct", """
        import subprocess

        def f(cmd):
            subprocess.run(cmd)
        """, ["subprocess-hygiene"], {}, {"subprocess-hygiene": 1}),
    ("atomic-in-place-write", """
        def f(path, text):
            with open(path, "w") as fh:
                fh.write(text)
        """, ["atomic-write"], {}, {"atomic-write": 1}),
    ("plan-purity-missing-registry", """
        import os

        def knob():
            return os.environ.get("PC_SECRET", "")

        def render(path, VideoWriter):
            return VideoWriter(path, knob())
        """, ["plan-purity"], {}, {"plan-purity": 1}),
    ("plan-purity-mutual-recursion", """
        import os

        def helper(n):
            if n > 0:
                return a_plan(n - 1)
            return ""

        def a_plan(n):
            knob = os.environ.get("PC_CYCLE_SECRET", "")
            return helper(n) + knob

        def render(path, VideoWriter):
            return VideoWriter(path, helper(3))
        """, ["plan-purity"], {}, {"plan-purity": 1}),
    ("plan-purity-wrapper-site-disable", """
        import os

        def env(name):
            return os.environ.get(name, "")

        def render(path, VideoWriter):
            # chainlint: disable=plan-purity (fixture: justified wrapper-site suppression)
            return VideoWriter(path, env("PC_WRAPPED_SECRET"))
        """, ["plan-purity"], {}, {}),
    ("plan-purity-site-disable", """
        import os

        def knob():
            # chainlint: disable=plan-purity (fixture: justified site suppression)
            return os.environ.get("PC_SECRET", "")

        def render(path, VideoWriter):
            return VideoWriter(path, knob())
        """, ["plan-purity"], {}, {}),
    ("plan-exempt-without-reason", """
        import os

        def knob():
            # plan-exempt:
            return os.environ.get("PC_SECRET", "")
        """, None, {}, {"bad-disable": 1}),
    ("queue-out-of-scope", """
        def flip(thing):
            thing.state = "anything-at-all"
        """, ["queue-transition"],
        {"queue_module_path": PORT_QUEUE, "serve_doc_path": SERVE_DOC}, {}),
    ("queue-annotation-mismatch", """
        from processing_chain_tpu_torch.serve.queue import JobRecord

        def bad(record):
            # queue-transition: running -> done (mismatched)
            record.state = "failed"
        """, ["queue-transition"],
        {"queue_module_path": PORT_QUEUE, "serve_doc_path": SERVE_DOC},
        {"queue-transition": 1}),
    ("queue-undeclared-edge", """
        from processing_chain_tpu_torch.serve.queue import JobRecord

        def bad(record):
            # queue-transition: done -> running
            record.state = "running"
        """, ["queue-transition"],
        {"queue_module_path": PORT_QUEUE, "serve_doc_path": SERVE_DOC},
        {"queue-transition": 1}),
]


def _lint_source(tmp_path, source, rules, cfg_cls=LintConfig, run=run_lint, **cfg_kw):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(source))
    return run(cfg_cls(root=str(tmp_path), targets=[str(path)],
                       rules=set(rules) if rules else None, **cfg_kw))


@pytest.mark.parametrize("name,source,rules,cfg_kw,want", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_rule_case(tmp_path, name, source, rules, cfg_kw, want):
    got = _lint_source(tmp_path, source, rules, **cfg_kw)
    counts = {}
    for f in got:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    assert counts == want, [f.render() for f in got]
    ref = _lint_source(tmp_path, source, rules, JLintConfig, jrun_lint, **cfg_kw)
    assert _key(got) == _key(ref)


def test_doc_drift_both_directions(tmp_path):
    (tmp_path / "catalog.py").write_text(
        'METRICS = {"chain_documented_total": "counter",\n'
        '           "chain_undocumented_total": "counter"}\n'
        'EVENTS = frozenset({"run_start"})\n')
    (tmp_path / "TELEMETRY.md").write_text(
        "| `chain_documented_total` | — |\n"
        "| `chain_ghost_total` | only in the doc |\n"
        "`run_start`\n")
    (tmp_path / "mod.py").write_text("x = 1\n")
    findings = run_lint(LintConfig(
        root=str(tmp_path), targets=[str(tmp_path / "mod.py")], rules={"telemetry-name"},
        catalog_path="catalog.py", doc_path="TELEMETRY.md"))
    # the catalog's finding carries the configured catalog's path, the
    # doc's the doc's folder and name
    assert [(f.path, f.snippet) for f in findings] == [
        ("catalog.py", "chain_undocumented_total"),
        (f"{tmp_path.name}/TELEMETRY.md", "chain_ghost_total")]


def test_registry_plumbing_beside_the_configured_catalog_is_allowlisted(tmp_path):
    pkg = tmp_path / "pkg" / "telemetry"
    pkg.mkdir(parents=True)
    (pkg / "catalog.py").write_text('METRICS = {"chain_x_total": "counter"}\nEVENTS = ()\n')
    plumbing = "def emit(event, **f):\n    EVENTS.emit(event, **f)\n"
    for rel in ("pkg/telemetry/events.py", "pkg/other.py"):
        (tmp_path / rel).write_text(plumbing)
    findings = run_lint(LintConfig(
        root=str(tmp_path), targets=[str(tmp_path / "pkg")], rules={"telemetry-name"},
        catalog_path="pkg/telemetry/catalog.py", doc_path="absent.md"))
    local = [f for f in findings if f.symbol != "doc-drift"]
    assert [(f.path, f.symbol) for f in local] == [("pkg/other.py", "emit")]


def test_catalog_matches_live_registrations():
    """Every chain_ metric the port registers on import is declared in
    the port's catalog with the same kind (the dynamic twin of the rule)."""
    import processing_chain_tpu_torch.engine.jobs  # noqa: F401
    import processing_chain_tpu_torch.engine.prefetch  # noqa: F401
    import processing_chain_tpu_torch.io.bufpool  # noqa: F401
    import processing_chain_tpu_torch.serve.service  # noqa: F401
    import processing_chain_tpu_torch.store.store  # noqa: F401
    import processing_chain_tpu_torch.telemetry.profiling  # noqa: F401
    from processing_chain_tpu_torch.telemetry import catalog

    live = {n: m.kind for n, m in REGISTRY._metrics.items() if n.startswith("chain_")}
    assert {n: catalog.METRICS.get(n) for n in live} == live


def test_registry_stale_declaration_flagged():
    """A declared input nobody reads is a finding on a full-tree run over
    the port with the port's schema."""
    cfg = LintConfig(root=REPO)
    checker = planpurity.PlanPurityChecker(os.path.join(REPO, cfg.plan_schema_path))
    checker.env_inputs["PC_NO_SUCH_KNOB"] = {"status": "exempt", "reason": "stale"}
    for path in cfg.iter_files():
        mod = load_module(path, REPO)
        if mod is not None:
            checker.visit_module(mod)
    findings = checker.finalize()
    assert [(f.symbol, f.snippet) for f in findings] == [("schema-stale", "PC_NO_SUCH_KNOB")]


def test_port_queue_implements_every_declared_edge():
    findings = run_lint(LintConfig(
        root=REPO, targets=[os.path.join(REPO, "processing_chain_tpu_torch", "serve")],
        rules={"queue-transition"}))
    assert findings == [], "\n".join(f.render() for f in findings)


# ---------------------------------------------------------------- baseline


def _one_finding(tmp_path, pad=""):
    findings = _lint_source(tmp_path, pad + "import subprocess\n\n\ndef f(cmd):\n"
                            "    subprocess.run(cmd)\n", ["subprocess-hygiene"])
    assert len(findings) == 1
    return findings


def test_baseline_add_suppress_expire(tmp_path):
    findings = _one_finding(tmp_path)
    path = str(tmp_path / "baseline.json")
    assert bl.write_baseline(path, findings, [], reason="grandfathered") == 1
    entries = bl.load_baseline(path)
    result = bl.apply_baseline(findings, entries)
    assert result.new == [] and len(result.baselined) == 1
    assert len(bl.apply_baseline([], entries).stale) == 1
    assert bl.write_baseline(path, [], [], reason="-") == 0
    assert bl.load_baseline(path) == []


def test_baseline_reason_is_mandatory(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "atomic-write", "path": "x.py", "symbol": "f", "snippet": "open(p, 'w')",
         "reason": "  "}]}))
    with pytest.raises(bl.BaselineError, match="reason"):
        bl.load_baseline(str(path))


def test_fingerprint_survives_line_shifts(tmp_path):
    first = _one_finding(tmp_path)[0]
    shifted = _one_finding(tmp_path, pad="# a comment\n\n\n")[0]
    assert shifted.fingerprint() == first.fingerprint() and shifted.line != first.line


def test_port_baseline_holds_the_pending_names_with_their_items():
    entries = bl.load_baseline(os.path.join(REPO, bl.DEFAULT_BASELINE))
    assert bl.DEFAULT_BASELINE == "processing_chain_tpu_torch/tools/chainlint/baseline.json"
    got = {e.snippet: e for e in entries}
    want = {name: item for item, names in PENDING.items() for name in names}
    assert sorted(got) == sorted(want) and len(entries) == 8
    for name, entry in got.items():
        assert (entry.rule, entry.path, entry.symbol) == (
            "telemetry-name", "docs/TELEMETRY.md", "doc-drift")
        assert f"Queue A item {want[name]}:" in entry.reason


# --------------------------------------------------------------------- CLI


def _write_bad(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import subprocess\n\ndef f(c):\n    subprocess.run(c)\n")
    return bad


def test_cli_exit_codes(tmp_path, capsys):
    bad = _write_bad(tmp_path)
    assert lint_cli.main(["--root", str(tmp_path), str(bad), "--no-baseline"]) == 1
    assert "subprocess-hygiene" in capsys.readouterr().out
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    assert lint_cli.main(["--root", str(tmp_path), str(ok), "--no-baseline"]) == 0
    assert "chain-lint: OK — 0 findings in 1 file(s)" in capsys.readouterr().out
    assert lint_cli.main(["--rules", "no-such-rule"]) == 2
    assert lint_cli.main(["--update-baseline"]) == 2  # a reason is required


def test_cli_update_baseline_and_stale_gate(tmp_path, capsys):
    bad = _write_bad(tmp_path)
    base = str(tmp_path / "BL.json")
    args = ["--root", str(tmp_path), str(bad), "--baseline", base]
    assert lint_cli.main(args + ["--update-baseline", "--reason", "transition"]) == 0
    assert lint_cli.main(args) == 0
    bad.write_text("x = 1\n")
    capsys.readouterr()
    assert lint_cli.main(args) == 1
    assert "STALE" in capsys.readouterr().out
    assert lint_cli.main(args + ["--allow-stale"]) == 0
    assert lint_cli.main(args + ["--update-baseline", "--reason", "-"]) == 0
    assert bl.load_baseline(base) == []


def test_cli_json_output(tmp_path, capsys):
    bad = _write_bad(tmp_path)
    assert lint_cli.main(["--root", str(tmp_path), str(bad), "--no-baseline", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["files"] == 1 and doc["findings"][0]["rule"] == "subprocess-hygiene"
    assert doc["findings"][0]["fingerprint"]


def test_find_repo_root_keys_on_the_port(tmp_path):
    (tmp_path / "processing_chain_tpu_torch" / "x").mkdir(parents=True)
    assert lint_cli.find_repo_root(str(tmp_path / "processing_chain_tpu_torch" / "x")) \
        == str(tmp_path)


# --------------------------------------------------------------- the gate


def _port_cli(cwd, *args):
    """`python -m processing_chain_tpu_torch tools chain-lint` in a fresh
    interpreter; prints whether jax was imported after the lint."""
    code = ("import sys\n"
            "from processing_chain_tpu_torch.__main__ import main\n"
            f"rc = main(['tools', 'chain-lint', *{list(args)!r}])\n"
            "print('jax loaded:', any(m.split('.')[0] in ('jax', 'processing_chain_tpu') "
            "for m in sys.modules))\n"
            "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_bare_gate_is_clean_on_the_port_without_jax():
    proc = _port_cli(REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "chain-lint: OK — 0 findings, 8 baselined in " in proc.stdout
    assert "jax loaded: False" in proc.stdout


#: (file of the port, text appended to it, what the gate must name)
SEEDED = [
    ("processing_chain_tpu_torch/telemetry/profiling.py",
     "\n\ndef _seeded_shell(cmd):\n    subprocess.run(cmd)\n",
     "subprocess-hygiene [_seeded_shell]: direct subprocess.run()"),
    ("processing_chain_tpu_torch/serve/service.py",
     '\n\n_SEEDED = tm.counter("chain_seeded_rogue_total", "not in the catalog")\n',
     "metric 'chain_seeded_rogue_total' is not declared in telemetry/catalog.py"),
    ("processing_chain_tpu_torch/serve/executors.py",
     '\n\nclass _SeededExecutor:\n    def run_batch(self, units):\n'
     '        return os.environ.get("PC_SEEDED_HIDDEN_KNOB", "")\n',
     "hidden input 'PC_SEEDED_HIDDEN_KNOB' can reach artifact bytes"),
    ("processing_chain_tpu_torch/serve/queue.py",
     '\n\ndef _seeded_resurrect(rec):\n    # queue-transition: done -> running\n'
     '    rec.state = "running"\n',
     "edge done -> running is not declared in serve/queue.py TRANSITIONS"),
]


def test_seeded_violations_fail_the_gate_by_name(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "processing_chain_tpu_torch"),
                    root / "processing_chain_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc", "assets"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
    (root / "docs").mkdir()
    for doc in ("TELEMETRY.md", "SERVE.md"):
        shutil.copy(os.path.join(REPO, "docs", doc), root / "docs")
    assert lint_cli.main(["--root", str(root)]) == 0
    for rel, text, _ in SEEDED:
        with open(root / rel, "a") as f:
            f.write(text)
    proc = _port_cli(str(root), "--root", str(root))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    for _, _, named in SEEDED:
        assert named in proc.stdout, named
    assert "chain-lint: FAIL — 4 finding(s) (plan-purity: 1, queue-transition: 1, " \
        "subprocess-hygiene: 1, telemetry-name: 1), 8 baselined" in proc.stdout


# ----------------------------------------------------------------- bufpool


def _counters(registry):
    return {n: registry.sum_series(n) or 0.0 for n in (
        "chain_bufpool_hits_total", "chain_bufpool_misses_total",
        "chain_bufpool_recycled_bytes_total")}


def _pool_sequence(pool):
    a = pool.acquire((8, 16), np.uint8)
    b = pool.acquire((4, 4), np.uint16)
    pool.release(a, b, a[:2])            # the view and the repeat are no-ops
    c = pool.acquire((8, 16), np.uint8)  # recycled
    pool.release(c)
    d = pool.acquire((8, 16), np.uint8)  # recycled again
    e = pool.acquire((4, 4), np.uint16)  # recycled
    f = pool.acquire((4, 4), np.uint16)  # a miss: the free list is empty
    pool.release(d, e, f)
    return pool.stats()


@pytest.fixture
def telemetry_on():
    for pkg in (tm, jtm):
        pkg.reset()
        pkg.enable()
    yield
    for pkg in (tm, jtm):
        pkg.disable()
        pkg.reset()


def test_bufpool_counts_what_the_jax_pool_counts(telemetry_on):
    got = _pool_sequence(BufferPool())
    want = _pool_sequence(JBufferPool())
    assert _counters(tm.REGISTRY) == _counters(jtm.REGISTRY) == {
        "chain_bufpool_hits_total": 3.0, "chain_bufpool_misses_total": 3.0,
        "chain_bufpool_recycled_bytes_total": 2 * 128 + 32.0}
    assert got == want
    assert (got["hits"], got["misses"], got["hit_rate"]) == (3, 3, 0.5)


def test_bufpool_counts_nothing_with_telemetry_off():
    tm.disable()
    tm.reset()
    pool = BufferPool()
    pool.release(pool.acquire((2, 2)))
    pool.acquire((2, 2))
    assert _counters(tm.REGISTRY) == dict.fromkeys(_counters(tm.REGISTRY), 0.0)
    assert (pool.stats()["hits"], pool.stats()["misses"]) == (1, 1)


def test_port_run_report_shows_the_pool_line(tmp_path, telemetry_on):
    _pool_sequence(BufferPool())
    tm.write_outputs(str(tmp_path), "s1")
    lines = treport._host_path_section(treport.load_run(str(tmp_path)))
    assert "  buffer pool: 3 hits / 3 misses (hit rate 0.50), 0.0 MB recycled" in lines
    assert "host frame path:" in treport.render_report(treport.load_run(str(tmp_path)))


# --------------------------------------------------------------- recorders


def test_port_recorders_hold_over_the_serve_wave_path(tmp_path, monkeypatch):
    """The runtime halves of lock-order and plan-purity, on the port's own
    recorders: a fresh recording of one `wave` service round on the CPU is
    acyclic and keeps one plan to one byte stream."""
    monkeypatch.setenv("PC_LOCK_DEBUG", "1")
    monkeypatch.setenv("PC_PLAN_DEBUG", "1")
    saved = plandebug.snapshot_state()
    lockdebug.reset()
    plandebug.reset()
    try:
        svc = ChainServeService(root=str(tmp_path / "serve"), port=0, executor="wave",
                                workers=1, device="cpu").start()
        try:
            acc = svc.submit({"tenant": "lab-a", "database": "P2STR01",
                              "srcs": ["SRC001", "SRC002"], "hrcs": ["HRC001"],
                              "params": {"frames": 6, "src_h": 36, "src_w": 64,
                                         "dst_h": 72, "dst_w": 128}})
            assert svc.wait_request(acc["request"], timeout=60.0) == "done"
        finally:
            svc.stop()
            store_runtime.configure(None)
            tm.disable()
        locks = lockdebug.check()
        plans = plandebug.check()
        assert locks["edges"] > 0 and locks["nodes"] > 1
        assert plans == {"plans": 2, "violations": 0}
    finally:
        lockdebug.reset()
        plandebug.restore_state(saved)


def test_port_lock_recorder_names_an_inversion(monkeypatch):
    monkeypatch.setenv("PC_LOCK_DEBUG", "1")
    lockdebug.reset()
    try:
        a, b = lockdebug.make_lock("inv_a"), lockdebug.make_lock("inv_b")
        with a, b:
            pass
        with b, a:
            pass
        with pytest.raises(lockdebug.LockOrderViolation, match="inv_a"):
            lockdebug.check()
    finally:
        lockdebug.reset()
    assert lockdebug.check()["edges"] == 0
