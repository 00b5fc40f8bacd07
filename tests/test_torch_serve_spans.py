"""The port's span journal (processing_chain_tpu_torch/serve/spans.py):
its writer and readers on their own, across a lease steal between two
queues over one root, and read back after a request the port's service
served. Each test names its JAX counterpart in tests/test_fleet_obs.py;
the service test has none (the reference reads the journal through its
trace tool, which the port does not carry)."""

from __future__ import annotations

import os
import time

import pytest

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.serve import spans as serve_spans
from processing_chain_tpu_torch.serve.queue import DurableQueue
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import runtime as store_runtime


def _unit(n=1):
    return {"database": "P2STR01", "src": f"SRC{100 + n:03d}",
            "hrc": "HRC100", "params": {},
            "pvs_id": f"P2STR01_SRC{100 + n:03d}_HRC100"}


def _enqueue(queue, plan_hash, request_id, n=1, trace=None):
    return queue.enqueue(plan_hash, {"op": "t", "k": plan_hash}, _unit(n),
                         "acme", "normal", request_id,
                         f"{plan_hash[:8]}.bin", trace_id=trace)


def _wait_stolen(queue, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if queue.poll()["stolen"]:
            return True
        time.sleep(0.05)
    return False


def test_span_journal_append_replay_roundtrip(tmp_path):
    """JAX counterpart: tests/test_fleet_obs.py::
    test_span_journal_append_replay_roundtrip."""
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
    j2 = serve_spans.SpanJournal(root, "rep-b")
    j2.append("steal", job="j1", plan="p" * 64, state="queued", epoch=2)
    j2.close()
    merged = serve_spans.read_journals(root)
    assert [s["phase"] for s in merged] == ["enqueue", "claim", "steal"]
    assert [s["phase"] for s in serve_spans.spans_for_request(merged, "r1")] \
        == ["enqueue", "claim"]


def test_span_journal_tolerates_torn_tail_and_garbage_names(tmp_path):
    """JAX counterpart: tests/test_fleet_obs.py::
    test_span_journal_tolerates_torn_tail_and_garbage_names."""
    root = str(tmp_path / "spans")
    j = serve_spans.SpanJournal(root, "rep/../weird name")
    j.append("enqueue", job="j1", plan="p", state="queued", epoch=0)
    j.close()
    (name,) = os.listdir(root)
    assert "/" not in name and name.endswith(".jsonl")
    path = os.path.join(root, name)
    with open(path, "a") as f:
        f.write('{"phase": "claim", "job": "j1", "trunc')  # torn tail
    out = serve_spans.read_journal(path)
    assert [s["phase"] for s in out] == ["enqueue"]


def test_verify_chain_flags_gaps_and_mismatched_terminals():
    """JAX counterpart: tests/test_fleet_obs.py::
    test_verify_chain_flags_gaps_and_mismatched_terminals."""
    plan = "p" * 64

    def span(phase, epoch, **extra):
        return {"phase": phase, "job": "j1", "plan": plan,
                "epoch": epoch, "ts": 0.0, **extra}

    record = {"job": "j1", "state": "done", "epoch": 3, "settledEpoch": 3}
    good = [span("enqueue", 0), span("claim", 1), span("steal", 2),
            span("claim", 3), span("complete", 3)]
    assert serve_spans.verify_chain(good, record) == []
    gap = [good[0], good[1], good[3], good[4]]
    (violation,) = serve_spans.verify_chain(gap, record)
    assert "gap" in violation and "[2]" in violation
    wrong = good[:-1] + [span("fail", 3)]
    violations = serve_spans.verify_chain(wrong, record)
    assert any("'fail'" in v and "'done'" in v for v in violations)
    assert serve_spans.verify_chain(
        [good[0]], {"job": "j1", "state": "running", "epoch": 1}) == []
    assert serve_spans.verify_chain([], record)


def test_trace_stitches_across_a_steal(tmp_path):
    """JAX counterpart: tests/test_fleet_obs.py::
    test_trace_stitches_across_a_steal."""
    root = str(tmp_path / "q")
    qa = DurableQueue(root, replica="rep-a", lease_s=0.2)
    qb = DurableQueue(root, replica="rep-b", lease_s=0.2)
    try:
        rec, _ = _enqueue(qa, "ab" * 32, "req-1", trace="tr-steal")
        assert qa.claim([rec.job_id])
        qa.close()  # the owner dies un-settled
        assert _wait_stolen(qb)
        assert qb.claim([rec.job_id])
        assert qb.complete(rec.job_id) is not None
        spans = serve_spans.read_journals(os.path.join(root, "spans"))
        chain = serve_spans.spans_for_job(spans, rec.job_id)
        phases = [(s["phase"], s["replica"]) for s in chain]
        assert ("enqueue", "rep-a") in phases
        assert ("claim", "rep-a") in phases
        assert ("steal", "rep-b") in phases
        assert phases[-1] == ("complete", "rep-b")
        assert chain[-1]["traces"] == ["tr-steal"]
        serve_root = str(tmp_path / "sroot")
        os.makedirs(serve_root)
        os.symlink(root, os.path.join(serve_root, "queue"))
        assert serve_spans.verify_completeness(serve_root) == []
    finally:
        qb.close()


def test_journal_stats_tail_sampling(tmp_path):
    """JAX counterpart: tests/test_fleet_obs.py::
    test_journal_stats_tail_sampling."""
    root = str(tmp_path / "spans")
    j = serve_spans.SpanJournal(root, "rep-a")
    for i in range(50):
        j.append("enqueue", job=f"j{i}", plan="p", state="queued", epoch=0)
    j.close()
    exact = serve_spans.journal_stats(root)
    assert exact["total"] == 50 and not exact["sampled"]
    assert exact["by_phase"] == {"enqueue": 50}
    assert exact["files"] == 1 and exact["bytes"] > 0
    window = serve_spans.journal_stats(root, tail_bytes=400)
    assert window["sampled"] is True
    assert 0 < window["total"] < 50


@pytest.fixture
def service(tmp_path):
    svc = ChainServeService(root=str(tmp_path / "serve"), port=0,
                            workers=2, device="cpu").start()
    yield svc
    svc.stop()
    store_runtime.configure(None)
    tm.disable()


def test_service_request_spans_read_back_gapless(service):
    """A request the service served reads back from its root's journal:
    every unit has enqueue, claim and complete spans carrying the
    request and its trace id, and every terminal record's chain is
    gapless."""
    acc = service.submit({
        "tenant": "acme", "database": "P2STR01", "srcs": ["SRC100"],
        "hrcs": ["HRC100", "HRC101"], "params": {"size_bytes": 256},
    })
    assert service.wait_request(acc["request"], timeout=60.0) == "done"
    trace = service.request_status(acc["request"])["trace"]
    spans = serve_spans.read_journals(
        os.path.join(service.root, "queue", "spans"))
    mine = serve_spans.spans_for_request(spans, acc["request"])
    jobs = {s["job"] for s in mine}
    assert len(jobs) == 2
    for job in jobs:
        phases = [s["phase"] for s in serve_spans.spans_for_job(mine, job)]
        assert phases[0] == "enqueue" and phases[-1] == "complete"
        assert "claim" in phases
    assert all(trace in s["traces"] for s in mine)
    assert serve_spans.verify_completeness(service.root) == []
    stats = serve_spans.journal_stats(
        os.path.join(service.root, "queue", "spans"))
    assert stats["by_phase"]["complete"] == 2
