"""The port's serve-fleet proof harnesses against the reference's: the
request-trace assembly (`telemetry/fleet.resolve_request_ids`,
`assemble_trace`, `chrome_trace`) and `tools trace`, `tools
serve-soak` (its phase percentiles, the pack bench, the soak itself)
and `tools serve-chaos` (the invariant checker, the self-test).

Where a test drives one of the tools' latency gates it passes a budget
a loaded CPU host meets; the tools' own defaults are unchanged."""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from processing_chain_tpu import telemetry as jtm
from processing_chain_tpu.serve.queue import DurableQueue as JaxQueue
from processing_chain_tpu.store import runtime as jstore_runtime
from processing_chain_tpu.telemetry import fleet as jfleet
from processing_chain_tpu.tools import serve_chaos as jchaos
from processing_chain_tpu.tools import serve_soak as jsoak
from processing_chain_tpu.tools import trace_tool as jtrace

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.serve import spans as serve_spans
from processing_chain_tpu_torch.serve.queue import DurableQueue
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.telemetry import fleet
from processing_chain_tpu_torch.tools import serve_chaos, serve_soak, trace_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: warm-request budget of the soaks below: the tool's default is 1000 ms
#: a request; a CPU host running the suite on six workers can take
#: seconds to answer a warm POST, and these tests check counts, not speed
SOAK_WARM_BUDGET_MS = "30000"
#: the self-test's warm-probe p50 budget: the tool's default is 50 ms,
#: which a warm POST to a replica on a loaded CPU host can miss
CHAOS_WARM_BUDGET_MS = "5000"


@pytest.fixture
def clean_packages():
    """Both packages' process-wide serve state reset after the test."""
    yield
    store_runtime.configure(None)
    tm.disable()
    jstore_runtime.configure(None)
    jtm.disable()


@pytest.fixture
def main_log():
    """The messages of the "main" logger both packages write to, read by
    a handler on that logger itself (the reference's
    setup_custom_logger stops it propagating to caplog's root handler)."""
    records: list = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("main")
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


# --------------------------------------------- ports of the reference tests


def test_trace_show_cli_end_to_end(clean_packages, tmp_path, capsys):
    """JAX counterpart: tests/test_fleet_obs.py
    test_trace_show_cli_end_to_end, on the port's service and tool."""
    svc = ChainServeService(root=str(tmp_path / "serve"), port=0, workers=2).start()
    try:
        acc = svc.submit({
            "tenant": "acme", "priority": "interactive",
            "database": "P2STR01", "srcs": ["SRC100"],
            "hrcs": ["HRC100", "HRC101"],
            "params": {"size_bytes": 128},
            "trace": "tr-client-ctx",
        })
        assert acc["trace"] == "tr-client-ctx"  # client context wins
        assert svc.wait_request(acc["request"], timeout=30.0) == "done"
        chrome_path = str(tmp_path / "trace.json")
        rc = trace_tool.main(["show", acc["request"], "--root", svc.root,
                              "--chrome", chrome_path])
        out = capsys.readouterr().out
        assert rc == 0
        assert "tr-client-ctx" in out
        assert "trace: COMPLETE" in out
        assert "enqueue" in out and "claim" in out and "complete" in out
        with open(chrome_path) as f:
            doc = json.load(f)
        assert doc["traceEvents"]
        assert doc["otherData"]["request"] == acc["request"]
        # lookup by trace id resolves to the same request
        assert trace_tool.main(["show", "tr-client-ctx", "--root", svc.root]) == 0
        capsys.readouterr()
        # a gateway trace shared by a second request renders both timelines
        acc2 = svc.submit({
            "tenant": "acme", "priority": "interactive",
            "database": "P2STR01", "srcs": ["SRC101"], "hrcs": ["HRC100"],
            "params": {"size_bytes": 128}, "trace": "tr-client-ctx",
        })
        assert svc.wait_request(acc2["request"], timeout=30.0) == "done"
        assert trace_tool.main(["show", "tr-client-ctx", "--root", svc.root]) == 0
        out = capsys.readouterr().out
        assert acc["request"] in out and acc2["request"] in out
        assert trace_tool.main(["ls", "--root", svc.root]) == 0
        out = capsys.readouterr().out
        assert acc["request"] in out and "tr-client-ctx" in out
        # unknown ref: exit 1
        assert trace_tool.main(["show", "req-nope", "--root", svc.root]) == 1
    finally:
        svc.stop()


def test_soak_phase_percentiles(tmp_path):
    """JAX counterpart: tests/test_fleet_obs.py test_soak_phase_percentiles."""
    assert serve_soak._percentiles_ms([]) is None
    p = serve_soak._percentiles_ms([0.1, 0.2, 0.3, 0.4])
    assert p["n"] == 4 and p["p50"] == 300.0 and p["p99"] == 400.0
    root = str(tmp_path)
    j = serve_spans.SpanJournal(os.path.join(root, "queue", "spans"), "rep-a")
    j.append("claim", job="j1", plan="p", state="running", epoch=1,
             queue_wait_s=0.25)
    j.append("complete", job="j1", plan="p", state="done", epoch=1,
             exec_s=0.5, warm=False)
    j.append("complete", job="j2", plan="q", state="done", epoch=1,
             exec_s=9.0, warm=True)  # warm settles are excluded
    j.close()
    phases = serve_soak.phase_latencies(root, [1.5])
    assert phases["queue_wait_ms"]["p50"] == 250.0
    assert phases["execution_ms"] == {"p50": 500.0, "p95": 500.0,
                                      "p99": 500.0, "n": 1}
    assert phases["e2e_ms"]["p50"] == 1500.0


# ----------------------------------------------------- trace assembly parity


def _request_doc(root: str, request_id: str, trace: str, units: dict,
                 created_at: float) -> None:
    os.makedirs(os.path.join(root, "requests"), exist_ok=True)
    doc = {"request": request_id, "trace": trace, "state": "done",
           "tenant": "acme", "priority": "normal", "created_at": created_at,
           "done_at": created_at + 1.0, "latency_ms": 1000.0,
           "units": {pvs: {"plan": plan} for pvs, plan in units.items()}}
    with open(os.path.join(root, "requests", request_id + ".json"), "w") as f:
        json.dump(doc, f)


def _unit(n: int) -> dict:
    return {"database": "P2STR01", "src": f"SRC{100 + n:03d}", "hrc": "HRC100",
            "params": {}, "pvs_id": f"P2STR01_SRC{100 + n:03d}_HRC100"}


def _steal_and_fence_root(root: str, queue_cls) -> None:
    """One serve root through `queue_cls` (either package's DurableQueue):
    req-1's first unit is claimed by rep-a, stolen by rep-b after rep-a's
    lease lapses, and rep-a's late settle is fenced before rep-b's lands;
    its second unit completes on rep-a alone. req-2 shares req-1's trace
    id; a third plan answers req-1 warm (no queue traffic)."""
    qroot = os.path.join(root, "queue")
    qa = queue_cls(qroot, replica="rep-a", lease_s=0.2)
    qb = queue_cls(qroot, replica="rep-b", lease_s=0.2)
    # (unit, plan, request) of each queued job; unit 5's plan is warm
    jobs = [(0, "ab" * 32, "req-1"), (1, "cd" * 32, "req-1"), (2, "12" * 32, "req-2")]
    warm_plan = "ef" * 32
    try:
        recs = []
        for n, plan, req in jobs:
            rec, _ = qa.enqueue(plan, {"op": "t", "k": plan}, _unit(n), "acme", "normal",
                                req, f"{plan[:8]}.bin", trace_id="tr-shared")
            recs.append(rec)
        assert qa.claim([recs[0].job_id])
        time.sleep(0.3)  # rep-a's lease lapses: it plays the zombie
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not qb.poll()["stolen"]:
            time.sleep(0.05)
        assert qb.claim([recs[0].job_id])
        assert qa.complete(recs[0].job_id) is None  # fenced
        assert qb.complete(recs[0].job_id) is not None
        for rec in recs[1:]:
            assert qa.claim([rec.job_id])
            assert qa.complete(rec.job_id) is not None
    finally:
        qa.close()
        qb.close()
    t0 = time.time()
    _request_doc(root, "req-1", "tr-shared",
                 {_unit(0)["pvs_id"]: jobs[0][1], _unit(1)["pvs_id"]: jobs[1][1],
                  _unit(5)["pvs_id"]: warm_plan}, t0)
    _request_doc(root, "req-2", "tr-shared", {_unit(2)["pvs_id"]: jobs[2][1]}, t0 + 0.5)


def _drop_spans(root: str, drop) -> None:
    """Rewrite every span journal of `root` without the spans `drop` picks."""
    spans_dir = os.path.join(root, "queue", "spans")
    for name in os.listdir(spans_dir):
        path = os.path.join(spans_dir, name)
        with open(path) as f:
            kept = [line for line in f if not drop(json.loads(line))]
        with open(path, "w") as f:
            f.writelines(kept)


def _chrome_events(doc: dict) -> list:
    return sorted(json.dumps(e, sort_keys=True) for e in doc["traceEvents"])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_trace_assembly_equals_the_reference(tmp_path, writer):
    """A root written by either package's queues (a steal, a fenced
    settle, a warm unit, a trace id shared by two requests): both
    packages resolve the same requests and assemble, render and export
    the same trace; the fenced settle and the steal are in it."""
    root = str(tmp_path / "serve")
    _steal_and_fence_root(root, DurableQueue if writer == "port" else JaxQueue)
    assert fleet.resolve_request_ids(root, "tr-shared") == ["req-1", "req-2"]
    assert jfleet.resolve_request_ids(root, "tr-shared") == ["req-1", "req-2"]
    assert fleet.resolve_request_ids(root, "req-2") == ["req-2"]
    assert fleet.resolve_request_ids(root, "tr-none") == \
        jfleet.resolve_request_ids(root, "tr-none") == []
    for req in ("req-1", "req-2", "req-nope"):
        ours = fleet.assemble_trace(root, req)
        ref = jfleet.assemble_trace(root, req)
        assert json.dumps(ours, sort_keys=True) == json.dumps(ref, sort_keys=True), req
        assert trace_tool.render_trace(ours) == jtrace.render_trace(ref), req
        chrome, jchrome = fleet.chrome_trace(ours), jfleet.chrome_trace(ref)
        assert _chrome_events(chrome) == _chrome_events(jchrome), req
        assert chrome["otherData"]["request"] == jchrome["otherData"]["request"] == req
    trace = fleet.assemble_trace(root, "req-1")
    assert trace["complete"] and trace["warm_units"] == 1
    phases = [s["phase"] for chain in trace["jobs"].values() for s in chain]
    assert "steal" in phases and "fenced" in phases
    text = trace_tool.render_trace(trace)
    assert "STOLEN" in text and "FENCED" in text and "trace: COMPLETE" in text
    assert not fleet.assemble_trace(root, "req-nope")["found"]


def test_trace_tool_exit_codes_equal_the_reference(tmp_path, capsys):
    """`tools trace show` in both packages over one root: 0 for a complete
    trace (both requests of a shared trace id rendered, the same text),
    1 for an unknown request, 3 once a terminal unit's claim span is cut
    from the journals; `ls` lists the same rows."""
    root = str(tmp_path / "serve")
    _steal_and_fence_root(root, DurableQueue)
    outs = []
    for tool in (trace_tool, jtrace):
        assert tool.main(["show", "tr-shared", "--root", root]) == 0
        assert tool.main(["show", "req-nope", "--root", root]) == 1
        assert tool.main(["ls", "--root", root, "-n", "5"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "req-1" in outs[0] and "req-2" in outs[0]
    _drop_spans(root, lambda s: s.get("phase") == "claim" and s.get("replica") == "rep-a")
    assert trace_tool.main(["show", "req-1", "--root", root]) == 3
    assert jtrace.main(["show", "req-1", "--root", root]) == 3
    out = capsys.readouterr().out
    assert out.count("trace: INCOMPLETE") == 2


# ------------------------------------------------------- serve-soak parity


def test_phase_latencies_equal_the_reference(tmp_path):
    """One seeded span journal (two replicas, warm and cold settles,
    claims with and without a wait) gives the same percentiles in both
    packages."""
    rng = np.random.default_rng(20261017)
    root = str(tmp_path)
    journals = [serve_spans.SpanJournal(os.path.join(root, "queue", "spans"), rep)
                for rep in ("rep-a", "rep-b")]
    for i in range(60):
        j = journals[i % 2]
        wait = None if i % 7 == 0 else float(rng.exponential(0.3))
        j.append("claim", job=f"j{i}", plan=f"p{i}", state="running", epoch=1,
                 queue_wait_s=wait)
        j.append("complete", job=f"j{i}", plan=f"p{i}", state="done", epoch=1,
                 exec_s=float(rng.exponential(0.1)), warm=bool(i % 5 == 0))
    for j in journals:
        j.close()
    e2e = [float(x) for x in rng.exponential(1.0, size=9)]
    ours = serve_soak.phase_latencies(root, e2e)
    assert ours == jsoak.phase_latencies(root, e2e)
    assert ours["queue_wait_ms"]["n"] == 60 - len(range(0, 60, 7))
    assert ours["execution_ms"]["n"] == 60 - len(range(0, 60, 5))


def test_pack_bench_equals_the_reference(clean_packages, tmp_path):
    """`--pack-bench` in both packages with the same arguments packs the
    same waves: equal wave counts and predicted-seconds means, maxima and
    cvs, cost-aware packing's cv below count packing's, every unit done.
    The e2e times are wall clock and are not compared."""
    reports = {}
    for name, tool in (("port", serve_soak), ("ref", jsoak)):
        out = str(tmp_path / f"{name}.json")
        tool.main(["--pack-bench", "--root", str(tmp_path / name), "--out", out])
        with open(out) as f:
            reports[name] = json.load(f)
    fields = ("waves", "wave_pred_mean_s", "wave_pred_max_s", "wave_pred_cv", "units_done")
    for mode in ("count", "cost"):
        ours, ref = reports["port"]["modes"][mode], reports["ref"]["modes"][mode]
        assert {k: ours[k] for k in fields} == {k: ref[k] for k in fields}, mode
        assert ours["units_done"] == 48
    modes = reports["port"]["modes"]
    assert modes["cost"]["wave_pred_cv"] < modes["count"]["wave_pred_cv"]
    assert reports["port"]["wave_budget_s"] == reports["ref"]["wave_budget_s"]
    # the only gate a loaded host may miss is the wall-clock e2e tail
    assert all("e2e tail" in f for f in reports["port"]["failures"])


def _soak(tool, root: str, *extra) -> tuple:
    out = root + ".json"
    rc = tool.main(["--clients", "4", "--srcs", "3", "--hrcs", "2",
                    "--warm-budget-ms", SOAK_WARM_BUDGET_MS, "--root", root,
                    "--out", out, *extra])
    with open(out) as f:
        return rc, json.load(f)


def test_synthetic_soak_equals_the_reference(clean_packages, tmp_path):
    """A small synthetic soak in each package, with `--calibrate-out`:
    both pass, with the same report keys and the same request, unit, plan
    and execution counts (zero duplicates: jobs planned == unique plans),
    and the same calibration document's keys."""
    rc, ours = _soak(serve_soak, str(tmp_path / "port"),
                     "--calibrate-out", str(tmp_path / "port_cal.json"))
    store_runtime.configure(None)
    tm.disable()
    jrc, ref = _soak(jsoak, str(tmp_path / "ref"),
                     "--calibrate-out", str(tmp_path / "ref_cal.json"))
    assert rc == jrc == 0, (ours["failures"], ref["failures"])
    assert sorted(ours) == sorted(ref)
    counts = ("requests", "units_total", "unique_plans", "jobs_planned",
              "warm_jobs_planned")
    assert {k: ours[k] for k in counts} == {k: ref[k] for k in counts}
    # one shared SRC x 2 HRCs, and each client's own 2 SRCs x 2 HRCs
    assert ours["jobs_planned"] == ours["unique_plans"] == 1 * 2 + 4 * 2 * 2
    assert sorted(ours["latency_phases"]) == sorted(ref["latency_phases"])
    with open(tmp_path / "port_cal.json") as f:
        cal = json.load(f)
    assert cal == ours["calibration"] and sorted(cal) == sorted(ref["calibration"])
    assert cal["fitted"] is not None


def test_wave_soak_on_the_cpu(clean_packages, tmp_path):
    """`--executor wave --device cpu`: the wave executor's plain CPU
    route through the soak, no duplicate execution, every request done,
    and a served artifact equal to the reference executor's bytes."""
    from processing_chain_tpu.serve.api import Unit as JaxUnit
    from processing_chain_tpu.serve.executors import DeviceWaveExecutor as JaxWave

    root = str(tmp_path / "wave")
    rc, report = _soak(serve_soak, root, "--executor", "wave", "--device", "cpu",
                       "--clients", "2", "--srcs", "2")
    assert rc == 0, report["failures"]
    assert report["executor"] == "wave"
    assert report["jobs_planned"] == report["unique_plans"] == 1 * 2 + 2 * 1 * 2
    req = sorted(os.listdir(os.path.join(root, "requests")))[0][:-5]
    with open(os.path.join(root, "requests", req + ".json")) as f:
        pvs, unit = sorted(json.load(f)["units"].items())[0]
    store = store_runtime.configure(os.path.join(root, "store"))
    with open(store.object_path(store.lookup(unit["plan"]).object["sha256"]), "rb") as f:
        served = f.read()
    _, src, hrc = pvs.split("_")
    params = {"geometry": [64, 36], "size_bytes": 2048}
    path = str(tmp_path / "ref.bin")
    JaxWave().run_batch([JaxUnit("P2STR01", src, hrc, params)], [path])
    with open(path, "rb") as f:
        assert served == f.read()


def test_chain_executor_soak_exits_with_item_11(clean_packages, tmp_path, main_log):
    """`--executor chain` waits for ROADMAP Queue A item 11: the soak exits
    nonzero with make_executor's message and imports no media module."""
    before = set(sys.modules)
    assert serve_soak.main(["--executor", "chain", "--root", str(tmp_path / "c")]) == 1
    assert any("Queue A item 11" in m for m in main_log), main_log
    assert not [m for m in set(sys.modules) - before
                if m.startswith("processing_chain_tpu_torch.io")
                and m != "processing_chain_tpu_torch.io.medialib"]


def test_wave_soak_refuses_the_default_device_without_cuda(clean_packages, tmp_path,
                                                           main_log):
    """`--executor wave` runs on `--device cuda:0` by default: without
    CUDA the soak refuses to start, and nothing drops to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device resolves")
    root = str(tmp_path / "w")
    assert serve_soak.main(["--executor", "wave", "--root", root]) == 1
    assert any("CUDA is not available" in m for m in main_log), main_log
    assert not os.path.isdir(os.path.join(root, "queue"))


# ------------------------------------------------------ serve-chaos parity


def _tamper(root: str) -> None:
    """run_self_test's four corruptions, seeded into `root`."""
    records = serve_chaos._load_records(root)
    done = sorted((r for r in records.values() if r.get("state") == "done"),
                  key=lambda r: r["job"])
    docs = serve_chaos._load_requests(root)
    some_req = sorted(docs)[0]
    rec = done[0]
    rec["settledEpoch"] = int(rec.get("epoch", 1)) - 1
    with open(os.path.join(root, "queue", "jobs", rec["job"] + ".json"), "w") as f:
        json.dump(rec, f)
    doc = docs[some_req]
    doc["state"] = "active"
    with open(os.path.join(root, "requests", some_req + ".json"), "w") as f:
        json.dump(doc, f)
    store = store_runtime.configure(os.path.join(root, "store"))
    victim = next(u["plan"] for req, d in sorted(docs.items())
                  if req != some_req and d.get("state") == "done"
                  for u in d["units"].values() if store.lookup(u["plan"]))
    os.unlink(store.object_path(store.lookup(victim).object["sha256"]))
    gap_job = done[-1]["job"]
    _drop_spans(root, lambda s: s.get("job") == gap_job and s.get("phase") == "claim")


def test_check_invariants_equal_the_reference(clean_packages, tmp_path):
    """One serve root (three requests, one of them poisoned) judged by
    both packages' check_invariants: clean, then with the poisoned plans
    left out of the expectation, then tampered as run_self_test tampers
    it. Each time the same violations, and every seeded class flagged."""
    root = str(tmp_path / "serve")
    svc = ChainServeService(root=root, port=0, workers=2, max_attempts=1).start()
    try:
        ok = [svc.submit({"tenant": f"t{i}", "database": "P2STR01",
                          "srcs": [f"SRC10{i}", "SRC110"], "hrcs": ["HRC100", "HRC101"],
                          "params": {"geometry": [64, 36], "size_bytes": 256}})
              for i in range(2)]
        bad = svc.submit({"tenant": "toxic", "database": "P2STR01", "srcs": ["SRC910"],
                          "hrcs": ["HRC100"], "params": {"poison": True}})
        assert [svc.wait_request(a["request"], timeout=30.0) for a in ok] == ["done"] * 2
        assert svc.wait_request(bad["request"], timeout=30.0) == "failed"
        poisoned = {u["plan"] for u in svc.request_status(bad["request"])["units"].values()}
    finally:
        svc.stop()
    expect = {bad["request"]}
    assert serve_chaos.check_invariants(root, poisoned, expect) == []
    assert jchaos.check_invariants(root, poisoned, expect) == []
    wrong = serve_chaos.check_invariants(root, set())
    assert wrong and wrong == jchaos.check_invariants(root, set())
    _tamper(root)
    violations = serve_chaos.check_invariants(root, poisoned, expect)
    assert violations == jchaos.check_invariants(root, poisoned, expect)
    for marker in ("fenced settle was ACCEPTED", "never reached a terminal",
                   "corrupt artifact", "chain has a gap"):
        assert any(marker in v for v in violations), marker


def test_serve_chaos_self_test_end_to_end(tmp_path):
    """`tools serve-chaos --self-test` as a process: one port replica
    (`chain-serve --executor synthetic`) through a clean pass, then the
    four seeded corruptions, each reported. Bounded by its own
    --timeout-s and by the process timeout."""
    root = str(tmp_path / "chaos")
    proc = subprocess.run(
        [sys.executable, "-m", "processing_chain_tpu_torch", "tools", "serve-chaos",
         "--self-test", "--timeout-s", "60", "--warm-budget-ms", CHAOS_WARM_BUDGET_MS,
         "--root", root],
        cwd=ROOT, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["self_test"] is True
    assert report["classes"] == {"fenced": True, "active": True, "artifact": True,
                                 "trace": True}
    logs = os.listdir(os.path.join(root, "logs"))
    assert logs == ["replica-0-g0.log"]
