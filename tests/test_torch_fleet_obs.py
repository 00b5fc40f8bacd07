"""The port's fleet observability (the contracts of
tests/test_fleet_obs.py; its trace-CLI and serve-soak tests are in
tests/test_torch_serve_harness.py): span-journal determinism,
cross-replica trace stitching across a steal, SLO histogram bucket
math, and the fleet view's dead-replica tolerance; then parity with the
reference package on the same replica files.

The replica shape mirrors tests/test_serve_replicas.py: two
DurableQueues over one root stand in for two daemon processes."""

from __future__ import annotations

import json
import os
import time

import pytest

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.serve import spans as serve_spans
from processing_chain_tpu_torch.serve.executors import SyntheticExecutor
from processing_chain_tpu_torch.serve.queue import DurableQueue
from processing_chain_tpu_torch.serve.scheduler import Scheduler
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.telemetry import catalog, fleet
from processing_chain_tpu_torch.tools import fleet_top
from tests._torch_control import drive


def _unit(n=1):
    return {"database": "P2STR01", "src": f"SRC{100 + n:03d}",
            "hrc": "HRC100", "params": {},
            "pvs_id": f"P2STR01_SRC{100 + n:03d}_HRC100"}


def _enqueue(queue, plan_hash, request_id, n=1, trace=None):
    return queue.enqueue(plan_hash, {"op": "t", "k": plan_hash}, _unit(n),
                         "acme", "normal", request_id,
                         f"{plan_hash[:8]}.bin", trace_id=trace)


@pytest.fixture
def serve_factory(tmp_path):
    created = []

    def make(subdir="serve", **kw):
        svc = ChainServeService(
            root=str(tmp_path / subdir), port=0, **kw
        ).start()
        created.append(svc)
        return svc

    yield make
    for svc in created:
        svc.stop()
    store_runtime.configure(None)
    tm.disable()


# ------------------------------------------------------ span journal


def test_span_journal_append_replay_roundtrip(tmp_path):
    """Appended spans replay byte-identically (same fields, same
    order) and merged reads across journals are (ts, replica, seq)
    ordered — the determinism the trace tool depends on."""
    root = str(tmp_path / "spans")
    j = serve_spans.SpanJournal(root, "rep-a", replica_epoch=3)
    j.append("enqueue", job="j1", plan="p" * 64, state="queued",
             epoch=0, requests=["r1"], traces=["tr-1"])
    j.append("claim", job="j1", plan="p" * 64, state="running",
             epoch=1, requests=["r1"], traces=["tr-1"],
             queue_wait_s=0.5)
    j.close()
    out = serve_spans.read_journal(os.path.join(root, "rep-a.jsonl"))
    assert [s["phase"] for s in out] == ["enqueue", "claim"]
    assert [s["seq"] for s in out] == [1, 2]
    assert out[0]["replica"] == "rep-a"
    assert out[0]["replica_epoch"] == 3
    assert out[0]["traces"] == ["tr-1"]
    assert out[1]["queue_wait_s"] == 0.5
    # a second journal merges in wall-clock order
    j2 = serve_spans.SpanJournal(root, "rep-b")
    j2.append("steal", job="j1", plan="p" * 64, state="queued", epoch=2)
    j2.close()
    merged = serve_spans.read_journals(root)
    assert [s["phase"] for s in merged] == ["enqueue", "claim", "steal"]


def test_span_journal_tolerates_torn_tail_and_garbage_names(tmp_path):
    root = str(tmp_path / "spans")
    j = serve_spans.SpanJournal(root, "rep/../weird name")
    j.append("enqueue", job="j1", plan="p", state="queued", epoch=0)
    j.close()
    # the journal name is sanitized into the root, no traversal
    (name,) = os.listdir(root)
    assert "/" not in name and name.endswith(".jsonl")
    path = os.path.join(root, name)
    with open(path, "a") as f:
        f.write('{"phase": "claim", "job": "j1", "trunc')  # torn tail
    out = serve_spans.read_journal(path)
    assert [s["phase"] for s in out] == ["enqueue"]


def test_verify_chain_flags_gaps_and_mismatched_terminals():
    plan = "p" * 64

    def span(phase, epoch, **extra):
        return {"phase": phase, "job": "j1", "plan": plan,
                "epoch": epoch, "ts": 0.0, **extra}

    record = {"job": "j1", "state": "done", "epoch": 3,
              "settledEpoch": 3}
    good = [span("enqueue", 0), span("claim", 1), span("steal", 2),
            span("claim", 3), span("complete", 3)]
    assert serve_spans.verify_chain(good, record) == []
    # missing the steal that introduced epoch 2: a gap
    gap = [good[0], good[1], good[3], good[4]]
    (violation,) = serve_spans.verify_chain(gap, record)
    assert "gap" in violation and "[2]" in violation
    # terminal span disagrees with the record's state
    wrong = good[:-1] + [span("fail", 3)]
    violations = serve_spans.verify_chain(wrong, record)
    assert any("'fail'" in v and "'done'" in v for v in violations)
    # non-terminal records are not judged (their chain is in flight)
    assert serve_spans.verify_chain(
        [good[0]], {"job": "j1", "state": "running", "epoch": 1}) == []
    # a terminal record with no spans at all is the loudest gap
    assert serve_spans.verify_chain([], record)


# ------------------------------------------- cross-replica stitching


def test_trace_stitches_across_a_steal(tmp_path):
    """rep-a claims and dies (close() without settling); rep-b steals,
    re-claims, completes. The merged journal must yield ONE gapless
    chain naming both replicas, and verify_completeness must pass."""
    root = str(tmp_path / "q")
    qa = DurableQueue(root, replica="rep-a", lease_s=0.2)
    qb = DurableQueue(root, replica="rep-b", lease_s=0.2)
    try:
        plan = "ab" * 32
        rec, _ = _enqueue(qa, plan, "req-1", trace="tr-steal")
        assert qa.claim([rec.job_id])
        qa.close()  # the owner dies un-settled
        deadline = time.monotonic() + 5.0
        stolen = 0
        while time.monotonic() < deadline and not stolen:
            stolen = qb.poll()["stolen"]
            time.sleep(0.05)
        assert stolen == 1
        assert qb.claim([rec.job_id])
        assert qb.complete(rec.job_id) is not None
        spans = serve_spans.read_journals(os.path.join(root, "spans"))
        chain = serve_spans.spans_for_job(spans, rec.job_id)
        phases = [(s["phase"], s["replica"]) for s in chain]
        assert ("enqueue", "rep-a") in phases
        assert ("claim", "rep-a") in phases
        assert ("steal", "rep-b") in phases
        assert phases[-1] == ("complete", "rep-b")
        # trace ids survived the ownership change
        assert chain[-1]["traces"] == ["tr-steal"]
        # the serve-root layout verify_completeness expects: <root>/queue
        serve_root = str(tmp_path / "sroot")
        os.makedirs(serve_root)
        os.symlink(root, os.path.join(serve_root, "queue"))
        assert serve_spans.verify_completeness(serve_root) == []
    finally:
        qb.close()


def test_fenced_settle_writes_forensic_span(tmp_path):
    """A zombie's refused settle lands in the journal as a `fenced`
    span — visible in timelines, excluded from chain grading."""
    root = str(tmp_path / "q")
    qa = DurableQueue(root, replica="rep-a", lease_s=0.2)
    qb = DurableQueue(root, replica="rep-b", lease_s=0.2)
    try:
        rec, _ = _enqueue(qa, "cd" * 32, "req-1")
        assert qa.claim([rec.job_id])
        time.sleep(0.3)  # the lease expires; qa plays the zombie
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not qb.poll()["stolen"]:
            time.sleep(0.05)
        assert qb.claim([rec.job_id])
        assert qa.complete(rec.job_id) is None  # fenced
        assert qb.complete(rec.job_id) is not None
        spans = serve_spans.read_journals(os.path.join(root, "spans"))
        fenced = [s for s in spans if s["phase"] == "fenced"]
        assert len(fenced) == 1
        assert fenced[0]["replica"] == "rep-a"
        assert fenced[0]["held_epoch"] == 1
        assert fenced[0]["epoch"] == 3  # the current owner's epoch
    finally:
        qa.close()
        qb.close()


def test_twin_records_for_one_plan_both_settle(tmp_path):
    """Regression: the cross-replica enqueue race can mint TWO records
    for one plan, and wave packing claims both into one dispatch (same
    plan ⟹ same bucket). Both must settle — before the fix the label
    collision left one twin 'running' forever under a renewed lease
    (found by the trace-completeness chaos invariant)."""
    tm.enable()
    root = str(tmp_path / "q")
    store_runtime.configure(str(tmp_path / "store"))
    try:
        qa = DurableQueue(root, replica="rep-a", lease_s=5.0)
        qb = DurableQueue(root, replica="rep-b", lease_s=5.0)
        unit = {"database": "P2STR01", "src": "SRC100", "hrc": "HRC100",
                "params": {"geometry": [16, 9], "size_bytes": 64},
                "pvs_id": "P2STR01_SRC100_HRC100"}
        executor = SyntheticExecutor()
        plan = executor.plan(
            type("U", (), {"database": "P2STR01", "src": "SRC100",
                           "hrc": "HRC100",
                           "params": unit["params"]})())
        plan_hash = store_runtime.active().plan_hash(plan)
        # twins: each replica mints its own record for the same plan
        # (qb enqueues before any poll, inside the dedup race window)
        ra, _ = qa.enqueue(plan_hash, plan, unit, "acme", "normal",
                           "req-a", "twin-a.bin")
        qb._last_refresh = time.time()  # pin the race: no rescan
        rb, _ = qb.enqueue(plan_hash, plan, unit, "acme", "normal",
                           "req-b", "twin-b.bin")
        assert ra.job_id != rb.job_id
        qa.poll()  # now qa sees both twins
        sched = Scheduler(qa, executor, str(tmp_path / "arts"),
                          workers=1, wave_width=4)
        batch = qa.claim([ra.job_id, rb.job_id])
        assert len(batch) == 2
        sched._dispatch(batch)
        for job_id in (ra.job_id, rb.job_id):
            assert qa.record(job_id).state == "done", job_id
        qa.close()
        qb.close()
    finally:
        store_runtime.configure(None)
        tm.disable()


# ------------------------------------------------- SLO bucket math


def test_percentile_and_band_math():
    # cumulative buckets: 10 obs ≤0.1, 90 ≤1.0, 100 ≤+Inf
    buckets = {"0.1": 10, "1.0": 90, "+Inf": 100}
    assert fleet.percentile_from_buckets(buckets, 0.05) == 0.1
    assert fleet.percentile_from_buckets(buckets, 0.50) == 1.0
    # the tail lives past the largest finite bound: clamp to it
    assert fleet.percentile_from_buckets(buckets, 0.99) == 1.0
    assert fleet.percentile_from_buckets({}, 0.5) is None
    assert fleet.percentile_from_buckets({"0.1": 0, "+Inf": 0}, 0.5) \
        is None
    assert fleet.band_fraction(buckets, 0.1) == pytest.approx(0.1)
    assert fleet.band_fraction(buckets, 1.0) == pytest.approx(0.9)
    assert fleet.band_fraction(buckets, 50.0) == pytest.approx(1.0)


def test_prometheus_parse_merge_roundtrip():
    """Two replicas' /metrics renders (the registry's own format) merge
    bucket-wise; the grades come out against catalog.SLO_BANDS."""
    from processing_chain_tpu_torch.telemetry.metrics import MetricsRegistry

    def render(values):
        reg = MetricsRegistry()
        reg.enabled = True
        h = reg.histogram("chain_serve_queue_wait_seconds", "t",
                          ("tenant", "priority"))
        for v in values:
            h.labels(tenant="acme", priority="interactive").observe(v)
        return reg.render_prometheus()

    a = fleet.parse_histograms(render([0.01, 0.2]),
                               fleet.PHASE_METRICS.values())
    b = fleet.parse_histograms(render([0.02, 30.0]),
                               fleet.PHASE_METRICS.values())
    merged = fleet.merge_histograms([a, b])
    (key,) = merged
    assert key[0] == "chain_serve_queue_wait_seconds"
    assert merged[key]["count"] == 4
    assert merged[key]["sum"] == pytest.approx(30.23)
    report = fleet.slo_report(merged)
    cell = report["acme"]["interactive"]["queue_wait_s"]
    assert cell["count"] == 4
    assert cell["band_s"] == catalog.SLO_BANDS["queue_wait_s"]["interactive"]
    # 3 of 4 observations inside the 2.5 s interactive band: 75% < 99%
    assert cell["within_band"] == pytest.approx(0.75)
    assert cell["ok"] is False
    assert cell["p50"] is not None


def test_slo_bands_cover_every_priority_class():
    from processing_chain_tpu_torch.serve.api import PRIORITIES

    largest_bucket = max(catalog.SLO_LATENCY_BUCKETS)
    for phase, bands in catalog.SLO_BANDS.items():
        assert set(bands) == set(PRIORITIES), phase
        assert all(v > 0 for v in bands.values())
        # a band past the largest finite bucket could never report a
        # breach (everything would grade "inside" via the +Inf bucket)
        assert all(v <= largest_bucket for v in bands.values()), phase
    assert 0 < catalog.SLO_TARGET_FRACTION <= 1.0


def test_journal_stats_tail_sampling(tmp_path):
    root = str(tmp_path / "spans")
    j = serve_spans.SpanJournal(root, "rep-a")
    for i in range(50):
        j.append("enqueue", job=f"j{i}", plan="p", state="queued",
                 epoch=0)
    j.close()
    exact = serve_spans.journal_stats(root)
    assert exact["total"] == 50 and not exact["sampled"]
    assert exact["by_phase"] == {"enqueue": 50}
    assert exact["files"] == 1 and exact["bytes"] > 0
    window = serve_spans.journal_stats(root, tail_bytes=400)
    assert window["sampled"] is True
    assert 0 < window["total"] < 50  # recent window only, flagged


def test_request_docs_and_records_carry_trace_ids(serve_factory):
    svc = serve_factory(workers=1)
    acc = svc.submit({
        "tenant": "acme", "database": "P2STR01", "srcs": ["SRC100"],
        "hrcs": ["HRC100"], "params": {"size_bytes": 128},
    })
    assert acc["trace"].startswith("tr-")
    assert svc.wait_request(acc["request"], timeout=30.0) == "done"
    status = svc.request_status(acc["request"])
    assert status["trace"] == acc["trace"]
    with open(os.path.join(svc.requests_dir,
                           acc["request"] + ".json")) as f:
        doc = json.load(f)
    assert doc["trace"] == acc["trace"]
    (record,) = [svc.queue.record(j) for j in [
        json.load(open(os.path.join(svc.root, "queue", "jobs", n)))["job"]
        for n in os.listdir(os.path.join(svc.root, "queue", "jobs"))
        if n.endswith(".json")
    ]]
    assert acc["trace"] in record.trace_ids


# ------------------------------------------------------- fleet view


def test_fleet_view_with_one_dead_replica_renders(serve_factory):
    """Two info files — one live service, one stale claim pointing at
    a dead port. The view must mark the dead one and still merge the
    live one's SLO data; fleet-top must render it without crashing."""
    svc = serve_factory(workers=2)
    acc = svc.submit({
        "tenant": "acme", "priority": "bulk", "database": "P2STR01",
        "srcs": ["SRC100", "SRC101"], "hrcs": ["HRC100"],
        "params": {"size_bytes": 128},
    })
    assert svc.wait_request(acc["request"], timeout=30.0) == "done"
    # a dead peer: its info file survives, its port answers nothing
    with open(os.path.join(svc.root, "replica-dead.json"), "w") as f:
        json.dump({"url": "http://127.0.0.1:9", "replica": "ghost",
                   "pid": 999999, "replica_epoch": 7}, f)
    view = fleet.fleet_view(svc.root, timeout_s=1.0)
    by_name = {r["replica"]: r for r in view["replicas"]}
    assert set(by_name) == {svc.replica, "ghost"}
    assert by_name["ghost"]["alive"] is False
    assert by_name["ghost"]["error"] == "unreachable"
    assert by_name[svc.replica]["alive"] is True
    assert by_name[svc.replica]["replica_epoch"] == \
        svc.queue.replica_epoch
    assert view["alive"] == 1
    assert view["queue"].get("done", 0) >= 2
    assert view["requests"].get("done", 0) >= 1
    cell = view["slo"]["acme"]["bulk"]["e2e_s"]
    assert cell["count"] >= 1 and cell["ok"] in (True, False)
    assert view["spans"]["total"] >= 6
    frame = fleet_top.render(view)
    assert "ghost" in frame and "DEAD" in frame
    assert svc.replica in frame
    assert "acme/bulk" in frame
    # the /fleet endpoint serves the same document
    import urllib.request

    with urllib.request.urlopen(svc.server.url + "/fleet",
                                timeout=10) as resp:
        served = json.load(resp)
    assert {r["replica"] for r in served["replicas"]} == set(by_name)


def test_status_and_chain_top_show_replica_identity(serve_factory):
    from processing_chain_tpu_torch.telemetry import live
    from processing_chain_tpu_torch.tools import chain_top

    svc = serve_factory(workers=1)
    status = live.build_status({})
    serve = status["serve"]
    assert serve["replica"] == svc.replica
    assert serve["replica_epoch"] == svc.queue.replica_epoch
    assert serve["pid"] == os.getpid()
    frame = chain_top.render(status)
    assert f"replica {svc.replica}" in frame
    assert f"epoch {svc.queue.replica_epoch}" in frame


def test_events_carry_trace_fields(serve_factory):
    tm.enable()
    tm.EVENTS.clear()
    svc = serve_factory(workers=1)
    acc = svc.submit({
        "tenant": "acme", "database": "P2STR01", "srcs": ["SRC100"],
        "hrcs": ["HRC100"], "params": {"size_bytes": 128},
    })
    assert svc.wait_request(acc["request"], timeout=30.0) == "done"
    records = tm.EVENTS.records()
    accepted = [r for r in records if r["event"] == "serve_request"]
    assert accepted and accepted[-1]["trace_id"] == acc["trace"]
    done = [r for r in records if r["event"] == "serve_request_done"]
    assert done and done[-1]["trace_id"] == acc["trace"]
    job_starts = [r for r in records if r["event"] == "job_start"
                  and r.get("trace_id")]
    assert job_starts and job_starts[-1]["trace_id"] == acc["trace"]
    assert acc["request"] in job_starts[-1]["request_ids"]


# ------------------------------------------- fleet-merge edge cases


def test_fleet_view_of_an_empty_root(tmp_path):
    """No serve-info files at all: the view still builds (zero
    replicas, empty SLO report, no alerts, no scale signal) and
    fleet-top renders it instead of crashing."""
    root = str(tmp_path / "empty")
    os.makedirs(root)
    view = fleet.fleet_view(root, timeout_s=0.5)
    assert view["replicas"] == [] and view["alive"] == 0
    assert view["slo"] == {} and view["read_slo"] == {}
    assert view["stalls"] == []
    assert view["alerts"]["active"] == []
    assert view["alerts"]["journal"] == {"files": 0, "bytes": 0}
    assert view["scale"] is None
    frame = fleet_top.render(view)
    assert "none discovered" in frame
    assert "no phase observations yet" in frame


def test_merge_histograms_across_catalog_versions():
    """A fleet mid-upgrade: an old replica exposes only the execution
    histograms, a new one also exposes the read-path family. The merge
    must take the union — missing metrics on one replica must neither
    crash nor zero the other's cells."""
    from processing_chain_tpu_torch.telemetry.metrics import MetricsRegistry

    def render(with_read):
        reg = MetricsRegistry()
        reg.enabled = True
        h = reg.histogram("chain_serve_queue_wait_seconds", "t",
                          ("tenant", "priority"))
        h.labels(tenant="acme", priority="interactive").observe(0.01)
        if with_read:
            r = reg.histogram("chain_serve_read_ttfb_seconds", "t",
                              ("tenant", "size_class"))
            r.labels(tenant="acme", size_class="small").observe(0.005)
        return reg.render_prometheus()

    names = [*fleet.PHASE_METRICS.values(),
             *fleet.READ_PHASE_METRICS.values()]
    old = fleet.parse_histograms(render(False), names)
    new = fleet.parse_histograms(render(True), names)
    merged = fleet.merge_histograms([old, new])
    wait = [k for k in merged
            if k[0] == "chain_serve_queue_wait_seconds"]
    ttfb = [k for k in merged
            if k[0] == "chain_serve_read_ttfb_seconds"]
    assert merged[wait[0]]["count"] == 2     # both replicas merged
    assert merged[ttfb[0]]["count"] == 1     # the new replica alone
    assert fleet.slo_report(merged)["acme"]["interactive"][
        "queue_wait_s"]["count"] == 2
    assert fleet.read_slo_report(merged)["acme"]["small"][
        "read_ttfb_s"]["count"] == 1
    # an empty replica set merges to an empty report, not a crash
    assert fleet.merge_histograms([]) == {}
    assert fleet.slo_report({}) == {}


def test_fleet_view_tolerates_torn_journal_tails(tmp_path):
    """A scrape racing a SIGKILLed writer sees half-written final
    lines in the span, heat, and alert journals — every complete
    record must still count."""
    from processing_chain_tpu_torch.store import heat as store_heat
    from processing_chain_tpu_torch.telemetry import alerts

    root = str(tmp_path / "torn")
    spans_dir = os.path.join(root, "queue", "spans")
    j = serve_spans.SpanJournal(spans_dir, "rep-a")
    j.append("enqueue", job="j1", plan="p", state="queued", epoch=0)
    j.close()
    with open(os.path.join(spans_dir, "rep-a.jsonl"), "a") as f:
        f.write('{"phase": "claim", "jo')
    heat_dir = store_heat.heat_dir(os.path.join(root, "store"))
    os.makedirs(heat_dir)
    with open(os.path.join(heat_dir, "rep-a.jsonl"), "w") as f:
        f.write(json.dumps({"kind": "read", "plan": "p", "mode": "full",
                            "bytes": 10, "ts": 1.0}) + "\n")
        f.write('{"kind": "evict", "pl')
    aj = alerts.AlertJournal(alerts.alerts_dir(root), "rep-a")
    aj.append({"kind": "fired", "id": "al-1", "alert": "k", "rule": "r",
               "severity": "page", "labels": {}})
    aj.close()
    with open(os.path.join(alerts.alerts_dir(root),
                           "rep-a.jsonl"), "a") as f:
        f.write('{"kind": "resolved", "id"')
    view = fleet.fleet_view(root, timeout_s=0.5)
    assert view["spans"]["total"] == 1
    assert view["heat"]["reads"] == 1
    assert [a["id"] for a in view["alerts"]["active"]] == ["al-1"]
    frame = fleet_top.render(view)
    assert "ALERTS firing: 1" in frame


def test_fleet_view_grades_dead_replicas_stale(tmp_path):
    """A serve-info registration whose process stopped answering is
    STALE with a last-seen age (the fleet_replica_stale rule's input),
    and fleet-top says when it was last seen."""
    from processing_chain_tpu_torch.telemetry import alerts

    root = str(tmp_path / "stale")
    os.makedirs(root)
    info = os.path.join(root, "serve-info-gone.json")
    with open(info, "w") as f:
        json.dump({"url": "http://127.0.0.1:9", "replica": "gone",
                   "pid": 999999, "replica_epoch": 3}, f)
    past = time.time() - 120.0
    os.utime(info, (past, past))
    view = fleet.fleet_view(root, timeout_s=0.5)
    (entry,) = view["replicas"]
    assert entry["alive"] is False and entry["status"] == "stale"
    assert entry["error"] == "unreachable"
    assert entry["last_seen_s"] == pytest.approx(120.0, abs=30.0)
    frame = fleet_top.render(view)
    assert "DEAD" in frame and "last seen" in frame
    # the stale grade is exactly what the alert rule trips on
    eng = alerts.AlertEngine(root, "grader")
    fired = eng.evaluate(view)["fired"]
    assert [s["rule"] for s in fired] == ["fleet_replica_stale"]
    assert fired[0]["labels"]["replica"] == "gone"
    eng.close()


def test_fleet_view_carries_stalls_and_fleet_top_renders(serve_factory):
    """An alive replica's /status stall episodes surface in the fleet
    doc labelled with the replica, and fleet-top renders the active-
    stalls line."""
    from processing_chain_tpu_torch.telemetry import watchdog

    svc = serve_factory(workers=1)
    stall = {"task": "wave", "stage": "p03", "kind": "task",
             "incident": "stalled", "beat_age_s": 42.0}
    real_active = watchdog.active_stalls
    try:
        watchdog.active_stalls = lambda registry=None: [dict(stall)]
        view = fleet.fleet_view(svc.root, timeout_s=5.0)
    finally:
        watchdog.active_stalls = real_active
    assert view["stalls"] == [{**stall, "replica": svc.replica}]
    frame = fleet_top.render(view)
    assert "active stalls:" in frame
    assert f"{svc.replica}:wave/p03" in frame


# ----------------------------- repairs and parity with the reference


def test_status_sampling_never_imports_torch():
    """Repair: a replica that never touched a device used to import
    torch on its first /status (the device-memory sample), a ~2 s stall
    on a CPU host that made a fresh replica read as unreachable to the
    fleet probe. The sample reads only an already-loaded torch."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from processing_chain_tpu_torch.telemetry import profiling\n"
        "sample = profiling.sample_resources()\n"
        "assert 'torch' not in sys.modules, 'sampling imported torch'\n"
        "assert sample['queues'] == {} and 'device_memory' not in sample\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _volatile_free(view):
    """A fleet view without the fields that depend on when it was
    taken (ages, the generation stamp)."""
    if isinstance(view, dict):
        return {k: _volatile_free(v) for k, v in view.items()
                if k not in ("generated_at", "last_seen_s", "age_s",
                             "info_mtime")}
    if isinstance(view, list):
        return [_volatile_free(v) for v in view]
    return view


@pytest.fixture(scope="module")
def control_roots(tmp_path_factory):
    """One serve root driven by the port's service and one by the
    reference's, through the same control-plane scenario."""
    from processing_chain_tpu.serve.service import (
        ChainServeService as JaxService,
    )

    roots = {"port": str(tmp_path_factory.mktemp("port")),
             "ref": str(tmp_path_factory.mktemp("ref"))}
    try:
        drive(ChainServeService, roots["port"], device="cpu")
        drive(JaxService, roots["ref"])
    finally:
        store_runtime.configure(None)
        tm.disable()
    return roots


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_fleet_merge_of_the_same_root_equals_the_reference(control_roots,
                                                           writer):
    """Both packages' `fleet_view` over one root (its replica now gone,
    its journals and queue on disk) merge to the same document."""
    from processing_chain_tpu.telemetry import fleet as jfleet

    root = control_roots[writer]
    ours = fleet.fleet_view(root, timeout_s=0.5)
    ref = jfleet.fleet_view(root, timeout_s=0.5)
    assert _volatile_free(ours) == _volatile_free(ref)
    assert [r["status"] for r in ours["replicas"]] == ["stale"]
    assert ours["heat"]["regrets"] >= 1


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journals_cross_read_between_packages(control_roots, writer):
    """Each package's readers fold the other's alert, heat, span and
    meshobs journals exactly as the writer's own do: `alerts.fold` and
    `fleet_doctor.gather_planes` are equal, every plane is present, and
    a root written by either package folds to the same alert set."""
    from processing_chain_tpu.parallel import meshobs as jmesh
    from processing_chain_tpu.serve import spans as jspans
    from processing_chain_tpu.store import heat as jheat
    from processing_chain_tpu.telemetry import alerts as jalerts
    from processing_chain_tpu.tools import fleet_doctor as jdoctor

    from processing_chain_tpu_torch.parallel import meshobs
    from processing_chain_tpu_torch.store import heat as store_heat
    from processing_chain_tpu_torch.telemetry import alerts
    from processing_chain_tpu_torch.tools import fleet_doctor

    root = control_roots[writer]
    planes = fleet_doctor.gather_planes(root)
    assert planes == jdoctor.gather_planes(root)
    assert {p["plane"] for p in planes} == {"spans", "heat", "mesh",
                                            "alerts"}
    adir = alerts.alerts_dir(root)
    assert alerts.fold(alerts.read_journals(adir)) == \
        jalerts.fold(jalerts.read_journals(adir))
    spans_dir = os.path.join(root, "queue", "spans")
    assert serve_spans.read_journals(spans_dir) == \
        jspans.read_journals(spans_dir)
    assert meshobs.read_journals(meshobs.mesh_dir(root)) == \
        jmesh.read_journals(jmesh.mesh_dir(root))
    hdir = store_heat.heat_dir(os.path.join(root, "store"))
    assert store_heat.aggregate(hdir) == jheat.aggregate(hdir)


def test_both_writers_fold_to_the_same_alert_set(control_roots):
    """The port's root and the reference's root, driven through one
    scenario, fire the same rules and record the same heat totals. The
    wave-waste rule is set aside: its input is the mesh's shape (one
    slot on the port's CPU mesh, eight on the reference's test mesh),
    not the control plane."""
    from processing_chain_tpu_torch.store import heat as store_heat
    from processing_chain_tpu_torch.telemetry import alerts

    def summary(root):
        folded = alerts.fold(alerts.read_journals(alerts.alerts_dir(root)))
        totals = store_heat.aggregate(store_heat.heat_dir(
            os.path.join(root, "store")))["totals"]
        return ({a["rule"] for a in folded.values()} - {"mesh_waste_high"},
                {k: totals[k] for k in ("regrets", "evictions", "reads")})

    assert summary(control_roots["port"]) == summary(control_roots["ref"])
    rules, totals = summary(control_roots["port"])
    assert "store_eviction_regret" in rules
    assert totals["regrets"] >= 1 and totals["evictions"] >= 1


_CONTROL_TOOLS = ("chain-serve", "serve-admin", "store", "store-admin", "store-heat",
                  "store-tiers", "fleet-doctor", "fleet-top", "queue-crashcheck",
                  "trace", "serve-soak", "serve-chaos")


@pytest.mark.parametrize("tool", _CONTROL_TOOLS)
def test_control_plane_tools_are_registered(tool, capsys):
    """Every control-plane tool answers `python -m processing_chain_tpu_torch
    tools <name> --help` (the reference CLI's names; `store-admin` is kept
    beside the reference's `tools store` as a second name of the same
    tool)."""
    from processing_chain_tpu_torch import __main__ as entry

    with pytest.raises(SystemExit) as exc:
        entry.main(["tools", tool, "--help"])
    assert exc.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_serve_admin_poison_round_trip(tmp_path, capsys):
    """`tools serve-admin` over a serve root: list, show and re-arm a
    poisoned SRC digest, with the same JSON as the reference tool."""
    from processing_chain_tpu.tools import serve_admin as jadmin

    from processing_chain_tpu_torch.tools import serve_admin

    root = str(tmp_path / "serve")
    queue = DurableQueue(os.path.join(root, "queue"))
    digest = "d1" * 32
    queue.poison_src(digest, src="SRC100", error="bad container")
    queue.close()
    assert serve_admin.main(["--root", root, "poison", "ls"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jadmin.main(["--root", root, "poison", "ls"]) == 0
    assert ours == json.loads(capsys.readouterr().out)
    assert ours["count"] == 1 and ours["poisoned"][0]["digest"] == digest
    assert serve_admin.main(["--root", root, "poison", "show", digest]) == 0
    assert json.loads(capsys.readouterr().out)["digest"] == digest
    assert serve_admin.main(["--root", root, "poison", "rearm", digest]) == 0
    capsys.readouterr()
    assert serve_admin.main(["--root", root, "poison", "show", digest]) == 1
    assert serve_admin.main(["--root", root, "poison", "ls"]) == 0
    assert json.loads(capsys.readouterr().out)["count"] == 0
