"""Multi-replica chain-serve: lease-fenced ownership, failure taxonomy
with backoff, and the durable-write/idle-poll satellites (docs/SERVE.md
"Running multiple replicas").

The replica shape everywhere here is two (or more) DurableQueue
instances over ONE directory — exactly what N daemon processes sharing
a root look like, minus the process boundary (close() releases a
handle's in-process liveness, which is what process death does)."""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.serve.queue import DurableQueue
from processing_chain_tpu_torch.serve.scheduler import (
    Scheduler, classify_failure,
)
from processing_chain_tpu_torch.serve.executors import SyntheticExecutor
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.utils import fsio
from processing_chain_tpu_torch.utils.runner import ChainError


def _unit(n=1):
    return {"database": "P2STR01", "src": f"SRC{100 + n:03d}",
            "hrc": "HRC100", "params": {},
            "pvs_id": f"P2STR01_SRC{100 + n:03d}_HRC100"}


def _enqueue(queue, plan_hash, request_id, n=1):
    return queue.enqueue(plan_hash, {"op": "t", "k": plan_hash}, _unit(n),
                         "acme", "normal", request_id,
                         f"{plan_hash[:8]}.bin")


@pytest.fixture
def two_queues(tmp_path):
    """The replica shape: two queues, one root, independent liveness."""
    root = str(tmp_path / "q")
    qa = DurableQueue(root, replica="rep-a", lease_s=0.25)
    qb = DurableQueue(root, replica="rep-b", lease_s=0.25)
    yield qa, qb
    qa.close()
    qb.close()


# ------------------------------------------------------- lease fencing


def test_concurrent_claim_yields_exactly_one_owner(two_queues):
    """Both replicas race to claim the same job, repeatedly and from
    threads: the flock + disk-truth claim protocol must hand each job
    to exactly one of them."""
    qa, qb = two_queues
    job_ids = []
    for i in range(12):
        rec, _ = _enqueue(qa, f"{i:02d}" * 32, f"req-{i}", n=i)
        job_ids.append(rec.job_id)
    qb.poll()
    wins: dict = {"a": [], "b": []}

    def _claim(q, key):
        for job_id in job_ids:
            wins[key].extend(r.job_id for r in q.claim([job_id]))

    ta = threading.Thread(target=_claim, args=(qa, "a"))
    tb = threading.Thread(target=_claim, args=(qb, "b"))
    ta.start(); tb.start(); ta.join(); tb.join()
    assert sorted(wins["a"] + wins["b"]) == sorted(job_ids)
    assert not set(wins["a"]) & set(wins["b"]), "a job was double-claimed"
    # both replicas settle what they own; everything lands done
    for key, q in (("a", qa), ("b", qb)):
        for job_id in wins[key]:
            assert q.complete(job_id) is not None
    # cross-replica visibility is via poll() (the maintenance tick's
    # sync), not magic: without it qa's view of qb's completions is
    # whatever it absorbed during the claim race — a latent flake
    # whenever qb actually won a job
    qa.poll()
    assert qa.counts().get("done", 0) == len(job_ids)


def test_expired_lease_is_stolen_and_losers_settle_is_fenced(two_queues):
    """The SIGSTOP-zombie story at queue granularity: A claims, stops
    renewing (no heartbeat here), B steals after expiry with the epoch
    bumped, and A's late settle is REFUSED — the record stays exactly
    as B's protocol put it."""
    qa, qb = two_queues
    rec, _ = _enqueue(qa, "a1" * 32, "req-1")
    claimed = qa.claim([rec.job_id])
    assert claimed and claimed[0].epoch == 1
    qb.poll()
    assert qb.record(rec.job_id).state == "running"
    # not yet expired: the live peer's lease is respected
    assert qb.poll()["stolen"] == 0
    time.sleep(0.3)  # outlive lease_s=0.25
    assert qb.poll()["stolen"] == 1
    stolen = qb.record(rec.job_id)
    assert stolen.state == "queued"
    assert stolen.epoch == 2           # ownership moved on
    assert stolen.attempts == 1        # an interrupted execution
    # the zombie's settle attempts are all fenced
    assert qa.complete(rec.job_id) is None
    assert qa.fail(rec.job_id, "late", requeue=False) is None
    disk = qb.record(rec.job_id)
    assert disk.state == "queued" and disk.epoch == 2
    # B executes it for real; its settle carries the epoch it holds
    reclaimed = qb.claim([rec.job_id])
    assert reclaimed and reclaimed[0].epoch == 3
    done = qb.complete(rec.job_id)
    assert done.state == "done"
    assert done.settled_epoch == done.epoch == 3


def test_stable_replica_id_restart_reclaims_own_stale_lease(tmp_path):
    """A daemon restarted with the SAME --replica-id (the documented
    fleet setup) must not trust its previous incarnation's lease just
    because the name matches: the lease is 'ours' only if we hold the
    exact claim it records — a regression pin."""
    root = str(tmp_path / "q")
    first = DurableQueue(root, replica="prod-0", lease_s=60.0)
    rec, _ = _enqueue(first, "ab" * 32, "req-1")
    first.claim([rec.job_id])
    first.close()  # the daemon dies mid-execution, lease far from expiry
    second = DurableQueue(root, replica="prod-0", lease_s=60.0)
    try:
        assert second.recovery["requeued"] == 1
        recovered = second.record(rec.job_id)
        assert recovered.state == "queued"
        assert recovered.epoch == 2  # the dead incarnation is fenced
        # and the record is claimable again right now
        assert second.claim([rec.job_id])
        assert second.complete(rec.job_id).state == "done"
    finally:
        second.close()


def test_heartbeat_keeps_long_executions_owned(tmp_path):
    """With the heartbeat running, a lease outlives its nominal
    duration and peers do NOT steal a live replica's work."""
    root = str(tmp_path / "q")
    qa = DurableQueue(root, replica="rep-a", lease_s=0.2)
    qb = DurableQueue(root, replica="rep-b", lease_s=0.2)
    try:
        qa.start_heartbeat(interval_s=0.05)
        rec, _ = _enqueue(qa, "b2" * 32, "req-1")
        assert qa.claim([rec.job_id])
        time.sleep(0.5)  # several nominal lease lifetimes
        assert qb.poll()["stolen"] == 0
        assert qb.record(rec.job_id).state == "running"
        done = qa.complete(rec.job_id)
        assert done is not None and done.state == "done"
    finally:
        qa.close()
        qb.close()


def test_heartbeat_reports_lost_leases(two_queues):
    """A zombie's own heartbeat, once resumed, discovers the theft
    (serve_lease_lost) instead of silently re-extending a lease it no
    longer owns."""
    qa, qb = two_queues
    tm.enable()
    try:
        rec, _ = _enqueue(qa, "c3" * 32, "req-1")
        qa.claim([rec.job_id])
        time.sleep(0.3)
        assert qb.poll()["stolen"] == 1
        lost = qa.renew_leases()
        assert lost == [rec.job_id]
        # and the lease on disk still belongs to the steal, not to A
        lease_path = os.path.join(qa.jobs_dir,
                                  rec.job_id + ".json.inprogress")
        assert not os.path.isfile(lease_path)
    finally:
        tm.disable()


def test_cross_replica_enqueue_attaches_not_duplicates(two_queues):
    """Dedup reaches across replicas: a request landing on B for a plan
    A already queued ATTACHES (after at most one throttled rescan) —
    the FAST-style reuse the serve layer is built on."""
    qa, qb = two_queues
    rec, outcome = _enqueue(qa, "d4" * 32, "req-a")
    assert outcome == "new"
    time.sleep(0.3)  # past the enqueue-refresh throttle
    rec_b, outcome_b = _enqueue(qb, "d4" * 32, "req-b")
    assert outcome_b == "attached"
    assert rec_b.job_id == rec.job_id
    assert sorted(rec_b.requests) == ["req-a", "req-b"]


# -------------------------------------------------- failure taxonomy


def test_classify_failure_kinds():
    assert classify_failure(ChainError("x", kind="permanent")) == "permanent"
    assert classify_failure(ChainError("x", kind="transient")) == "transient"
    assert classify_failure(OSError(28, "ENOSPC")) == "transient"
    assert classify_failure(MemoryError()) == "transient"
    assert classify_failure(ValueError("bad params")) == "permanent"
    assert classify_failure(RuntimeError("who knows")) == "transient"
    # the kind survives arbitrary wrapping (wave barrier, JobRunner)
    try:
        try:
            raise ChainError("inner", kind="permanent")
        except ChainError as inner:
            raise RuntimeError("wave execution failed") from inner
    except RuntimeError as wrapped:
        assert classify_failure(wrapped) == "permanent"


def test_transient_failure_requeues_with_backoff(two_queues):
    """A transient failure's record is NOT immediately re-claimable:
    not_before gates it (on every replica — it is persisted), so a
    deterministic failure cannot burn its whole attempts budget in
    milliseconds."""
    qa, qb = two_queues
    rec, _ = _enqueue(qa, "e5" * 32, "req-1")
    qa.claim([rec.job_id])
    failed = qa.fail(rec.job_id, "disk full", requeue=True,
                     backoff_s=0.4, kind="transient")
    assert failed.state == "queued"
    assert failed.error_kind == "transient"
    assert failed.not_before > time.time()
    assert qa.queued_snapshot() == []
    assert qa.claim([rec.job_id]) == []
    qb.poll()
    assert qb.queued_snapshot() == []          # the backoff travels
    time.sleep(0.45)
    assert [r.job_id for r in qa.queued_snapshot()] == [rec.job_id]
    assert qa.claim([rec.job_id])
    assert qa.complete(rec.job_id).state == "done"


def test_permanent_failure_quarantines_and_operator_rearms(two_queues):
    """Permanent failures park the plan with forensics; new requests
    are refused (outcome 'quarantined') until rearm clears it with a
    fresh budget."""
    qa, qb = two_queues
    rec, _ = _enqueue(qa, "f6" * 32, "req-1")
    qa.claim([rec.job_id])
    parked = qa.quarantine(rec.job_id, "corrupt SRC header")
    assert parked.state == "quarantined"
    assert parked.error_kind == "permanent"
    assert parked.settled_epoch == parked.epoch
    time.sleep(0.3)
    rec_b, outcome = _enqueue(qb, "f6" * 32, "req-2")
    assert outcome == "quarantined"
    assert rec_b.state == "quarantined"
    assert "req-2" in rec_b.requests           # attached for forensics
    cleared = qb.rearm(rec.job_id)
    assert cleared.state == "queued"
    assert cleared.attempts == 0 and cleared.error is None
    assert cleared.not_before == 0.0


def test_scheduler_quarantines_permanent_failures(tmp_path):
    """End-to-end through the scheduler: a ChainError(kind='permanent')
    lands the record in 'quarantined' on the FIRST attempt — no retry
    burn — and on_failed fires with the quarantined record."""
    # with a store the job runner keys by plan hash (without one it keeps
    # the legacy skip-existing check, as the reference's does)
    store_runtime.configure(str(tmp_path / "store"))
    tm.enable()
    try:
        class Poisoned(SyntheticExecutor):
            calls = 0

            def run_batch(self, units, outputs):
                type(self).calls += 1
                raise ChainError("bad params", kind="permanent")

        failed = []
        queue = DurableQueue(str(tmp_path / "q"))
        _enqueue(queue, "a7" * 32, "req-1")
        sched = Scheduler(queue, Poisoned(), str(tmp_path / "a"),
                          workers=1, max_attempts=3,
                          on_failed=failed.append).start()
        try:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and not failed:
                time.sleep(0.02)
        finally:
            sched.stop()
            queue.close()
        assert len(failed) == 1
        assert failed[0].state == "quarantined"
        assert Poisoned.calls == 1  # permanent = no retry at all
    finally:
        tm.disable()
        store_runtime.configure(None)


def test_scheduler_backoff_delays_transient_retry(tmp_path):
    """Retry pacing through the scheduler: with a transient failure the
    second attempt waits out the exponential backoff instead of
    refiring within milliseconds."""
    # with a store the job runner keys by plan hash (without one it keeps
    # the legacy skip-existing check, as the reference's does)
    store_runtime.configure(str(tmp_path / "store"))
    tm.enable()
    try:
        class Flaky(SyntheticExecutor):
            stamps: list = []

            def run_batch(self, units, outputs):
                type(self).stamps.append(time.monotonic())
                if len(type(self).stamps) == 1:
                    raise ChainError("disk hiccup", kind="transient")
                super().run_batch(units, outputs)

        queue = DurableQueue(str(tmp_path / "q"))
        _enqueue(queue, "b8" * 32, "req-1")
        sched = Scheduler(queue, Flaky(), str(tmp_path / "a"),
                          workers=1, max_attempts=3,
                          retry_base_s=0.4).start()
        try:
            assert sched.wait_idle(timeout=30.0)
        finally:
            sched.stop()
            queue.close()
        assert len(Flaky.stamps) == 2
        # jittered backoff: at least 0.75 * base between the attempts
        assert Flaky.stamps[1] - Flaky.stamps[0] >= 0.3
    finally:
        tm.disable()
        store_runtime.configure(None)


# ------------------------------------------------- service over one root


def test_two_services_one_root_cross_replica_completion(tmp_path):
    """The full replica shape: two ChainServeServices over ONE root.
    The submitting replica's scheduler is stopped, so its requests can
    only complete through the PEER's executions propagated by the
    maintenance sweep."""
    root = str(tmp_path / "fleet")
    svc_a = ChainServeService(
        root=root, port=0, replica="svc-a", lease_s=0.5, poll_s=0.1,
        info_path=os.path.join(root, "info-a.json"),
    ).start()
    svc_b = None
    try:
        svc_a.scheduler.stop()  # A can accept but never execute
        svc_b = ChainServeService(
            root=root, port=0, replica="svc-b", lease_s=0.5, poll_s=0.1,
            info_path=os.path.join(root, "info-b.json"),
        ).start()
        accepted = svc_a.submit({
            "tenant": "acme", "database": "P2STR01",
            "srcs": ["SRC100", "SRC101"], "hrcs": ["HRC100"],
            "params": {"size_bytes": 512},
        })
        assert svc_a.wait_request(accepted["request"], timeout=30.0) \
            == "done"
        doc = svc_a.request_status(accepted["request"])
        assert all(u["state"] == "done" for u in doc["units"].values())
    finally:
        if svc_b is not None:
            svc_b.stop()
        svc_a.stop()
        store_runtime.configure(None)
        tm.disable()


def test_sweep_never_settles_a_waiter_on_an_evicted_done_record(tmp_path):
    """A re-POST of an evicted plan registers its waiter before the
    queue re-arms the plan's done record. A maintenance sweep landing in
    between must not read that stale record as the completion: the
    request reads done only once the plan's bytes are back in the store."""
    from processing_chain_tpu_torch.store import gc as store_gc

    svc = ChainServeService(root=str(tmp_path / "serve"), port=0,
                            replica="svc-e", poll_s=0.1).start()
    try:
        body = {"tenant": "acme", "database": "P2STR01", "srcs": ["SRC100"],
                "hrcs": ["HRC100"], "params": {"size_bytes": 512}}
        first = svc.submit(body)
        assert svc.wait_request(first["request"], timeout=30.0) == "done"
        [unit] = svc.request_status(first["request"])["units"].values()
        assert store_gc.enforce_budget(svc.store, 0)["objects_evicted"] == 1
        assert svc.queue.by_plan(unit["plan"]).state == "done"
        persist = svc._persist_request

        def persist_then_sweep(doc):
            # the tick lands between the waiter's registration and the re-arm
            persist(doc)
            if doc["state"] == "active":
                svc._sweep_remote_settlements()

        svc._persist_request = persist_then_sweep
        again = svc.submit(body)
        assert again["outcomes"]["enqueued"] == 1
        assert svc.wait_request(again["request"], timeout=30.0) == "done"
        assert svc.store.lookup(unit["plan"]) is not None
    finally:
        svc.stop()
        store_runtime.configure(None)
        tm.disable()


def test_service_fails_requests_on_quarantined_plans(tmp_path):
    """Service-level taxonomy: a poisoned plan quarantines, the request
    fails with the forensic error, and a NEW request for the same plan
    fails at submit time (outcome 'quarantined') instead of queueing
    work nothing will run."""
    svc = ChainServeService(
        root=str(tmp_path / "serve"), port=0, replica="svc-q",
        poll_s=0.1, max_attempts=3,
    ).start()
    try:
        body = {
            "tenant": "toxic", "database": "P2STR01",
            "srcs": ["SRC100"], "hrcs": ["HRC100"],
            "params": {"poison": True},
        }
        first = svc.submit(body)
        assert svc.wait_request(first["request"], timeout=30.0) == "failed"
        doc = svc.request_status(first["request"])
        assert "injected permanent failure" in (doc.get("error") or "")
        [unit] = doc["units"].values()
        assert svc.queue.by_plan(unit["plan"]).state == "quarantined"
        # second request against the parked plan: failed at POST time
        second = svc.submit(body)
        assert second["state"] == "failed"
        assert second["outcomes"]["quarantined"] == 1
        # operator re-arm + a fresh (non-poisoned, same-identity) run is
        # out of scope here: rearm-level behavior is pinned above
    finally:
        svc.stop()
        store_runtime.configure(None)
        tm.disable()


def test_orphaned_request_adopted_by_live_peer_tick(tmp_path):
    """A request submitted to a replica that dies UN-restarted must not
    wait for some future startup rescan: the live peer's maintenance
    tick probes the doc's owner stamp, adopts the orphan, and
    finalizes it once the work (stolen or re-enqueued) settles."""
    root = str(tmp_path / "fleet")
    svc_a = ChainServeService(
        root=root, port=0, replica="orph-a", lease_s=0.4, poll_s=0.1,
        info_path=os.path.join(root, "info-a.json"),
    ).start()
    svc_b = None
    try:
        # B is up BEFORE the submit, so only the tick (not B's startup
        # rescan) can adopt
        svc_b = ChainServeService(
            root=root, port=0, replica="orph-b", lease_s=0.4, poll_s=0.1,
            info_path=os.path.join(root, "info-b.json"),
        ).start()
        # A can accept but never execute or finalize
        svc_a.scheduler.stop()
        svc_a._poll_stop.set()
        svc_a._poll_thread.join(timeout=10.0)
        accepted = svc_a.submit({
            "tenant": "acme", "database": "P2STR01",
            "srcs": ["SRC100", "SRC101"], "hrcs": ["HRC100"],
            "params": {"size_bytes": 512},
        })
        req_id = accepted["request"]
        # A dies (liveness released; on-disk doc still 'active', owner
        # stamp now provably dead)
        svc_a.queue.close()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            doc = svc_b.request_status(req_id)
            if doc is not None and doc["state"] == "done":
                break
            time.sleep(0.05)
        doc = svc_b.request_status(req_id)
        assert doc is not None, "peer never adopted the orphan"
        assert doc["state"] == "done"
        assert all(u["state"] == "done" for u in doc["units"].values())
        # the adoption restamped ownership on disk
        with open(os.path.join(root, "requests", req_id + ".json")) as f:
            on_disk = json.load(f)
        assert on_disk["owner"]["replica"] == "orph-b"
        assert on_disk["state"] == "done"
    finally:
        if svc_b is not None:
            svc_b.stop()
        svc_a.stop()
        store_runtime.configure(None)
        tm.disable()


# ------------------------------------------------------ satellites


def test_atomic_write_durable_fsyncs_before_replace(tmp_path, monkeypatch):
    """durable=True must fsync the temp file BEFORE os.replace (and the
    directory after) — the order is the whole point: an fsync after the
    rename cannot un-promote unflushed bytes."""
    calls: list = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync",
                        lambda fd: (calls.append("fsync"),
                                    real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace",
                        lambda a, b: (calls.append("replace"),
                                      real_replace(a, b))[1])
    target = str(tmp_path / "rec.json")
    fsio.atomic_write_json(target, {"x": 1}, durable=True)
    assert calls[0] == "fsync" and "replace" in calls
    assert calls.index("fsync") < calls.index("replace")
    with open(target) as f:
        assert json.load(f) == {"x": 1}
    # the fast default stays fsync-free
    calls.clear()
    fsio.atomic_write_json(str(tmp_path / "fast.json"), {"y": 2})
    assert "fsync" not in calls


def test_claim_revert_emits_catalogued_event(tmp_path, monkeypatch):
    """The claim-revert path is observable: serve_claim_reverted lands
    in the event log (and the counter), not just a module-logger line
    invisible to /status and the chaos assertions."""
    tm.enable()
    try:
        queue = DurableQueue(str(tmp_path / "q"))
        r1, _ = _enqueue(queue, "9a" * 32, "req-1", n=1)
        r2, _ = _enqueue(queue, "9b" * 32, "req-1", n=2)
        real_persist = queue._persist

        def failing(record):
            if record.job_id == r2.job_id and record.state == "running":
                raise OSError("disk full")
            real_persist(record)

        monkeypatch.setattr(queue, "_persist", failing)
        owned = queue.claim([r1.job_id, r2.job_id])
        assert [r.job_id for r in owned] == [r1.job_id]
        events = [e for e in tm.EVENTS.records()
                  if e.get("event") == "serve_claim_reverted"]
        assert len(events) == 1
        assert events[0]["job"] == r2.job_id
        queue.close()
    finally:
        tm.disable()


def test_idle_backoff_decays_and_resets(tmp_path):
    """The worker poll satellite: an idle scheduler decays its wait
    toward the 250 ms ceiling instead of hot-polling the queue lock;
    notify() (new work) snaps it back to fast."""
    from processing_chain_tpu_torch.serve import scheduler as sched_mod

    queue = DurableQueue(str(tmp_path / "q"))
    sched = Scheduler(queue, SyntheticExecutor(), str(tmp_path / "a"),
                      workers=1)
    waits: list = []
    real_wait = sched._wake.wait

    def spy_wait(timeout=None):
        waits.append(timeout)
        return real_wait(timeout=min(timeout or 0.0, 0.01))

    sched._wake.wait = spy_wait
    sched.start()
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(waits) < 8:
            time.sleep(0.01)
    finally:
        sched.stop()
        queue.close()
    assert len(waits) >= 8
    assert waits[0] == pytest.approx(sched_mod._IDLE_MIN_S)
    # strictly doubling toward the ceiling, never past it
    for earlier, later in zip(waits, waits[1:]):
        assert later == pytest.approx(
            min(earlier * 2.0, sched_mod._IDLE_MAX_S))
    assert max(waits) <= sched_mod._IDLE_MAX_S + 1e-9
