"""The artifact-plane flight recorder (docs/STORE.md "Access heat &
eviction forensics"): heat-journal round trips and torn-tail crash
safety (including a real SIGKILLed writer), restart-without-double-
counting, the fleet aggregate and working-set curve, cross-replica
regret detection with its window, GC eviction forensics (per-victim
evidence shared by report/event/journal), the read-path SLO catalog
invariants, and the serve read path end to end: strong ETags, 304
conditional GETs that never open an fd, heat records per read, and
regret after a forced undersized-budget eviction.
"""

import json
import os
import signal
import time
import urllib.error
import urllib.request

import pytest

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.store import gc as store_gc
from processing_chain_tpu_torch.store import heat as store_heat
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.store.store import ArtifactStore
from processing_chain_tpu_torch.telemetry import catalog
from processing_chain_tpu_torch.telemetry import fleet


@pytest.fixture(autouse=True)
def clean_runtime():
    tm.reset()
    yield
    store_runtime.configure(None)
    tm.disable()
    tm.reset()


def write(path, text):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


PLAN_A = "aa" * 32
PLAN_B = "bb" * 32
PLAN_C = "cc" * 32


# ----------------------------------------------------- journal mechanics


def test_heat_journal_roundtrip_and_merge(tmp_path):
    """Per-replica appends replay in order; two replicas' journals merge
    by (ts, replica, seq) like the span journals they are modeled on."""
    root = str(tmp_path / "store")
    a = store_heat.HeatLedger(root, replica="rep-a")
    b = store_heat.HeatLedger(root, replica="rep/../b")  # sanitized
    a.record_read(PLAN_A, 100, mode="full", size=100, size_class="lt1m",
                  tenant="t0", ttfb_s=0.001, dur_s=0.002)
    a.record_read(PLAN_A, 0, mode="not_modified", size=100,
                  size_class="lt1m", tenant="t0")
    b.record_read(PLAN_B, 50, mode="full")
    a.close()
    b.close()
    names = sorted(os.listdir(store_heat.heat_dir(root)))
    assert names == ["rep-a.jsonl", "rep_.._b.jsonl"]  # no traversal
    one = store_heat.read_journal(
        os.path.join(store_heat.heat_dir(root), "rep-a.jsonl"))
    assert [r["seq"] for r in one] == [1, 2]
    assert one[0]["mode"] == "full" and one[1]["mode"] == "not_modified"
    assert one[0]["bytes"] == 100 and one[0]["tenant"] == "t0"
    merged = store_heat.read_journals(store_heat.heat_dir(root))
    assert len(merged) == 3
    assert merged == sorted(
        merged, key=lambda r: (r["ts"], r["replica"], r["seq"]))


def test_torn_tail_is_skipped_and_restart_resumes(tmp_path):
    """The crash-safety contract: a torn final line (the one write a
    SIGKILL can interrupt) is skipped by every reader, and a restarted
    replica appends to the same journal without double-counting what
    the dead incarnation already flushed."""
    root = str(tmp_path / "store")
    ledger = store_heat.HeatLedger(root, replica="rep-a")
    ledger.record_read(PLAN_A, 10)
    ledger.record_read(PLAN_B, 20)
    ledger.close()
    path = os.path.join(store_heat.heat_dir(root), "rep-a.jsonl")
    with open(path, "a") as f:
        f.write('{"kind": "read", "plan": "' + PLAN_C + '", "trunc')
    assert len(store_heat.read_journal(path)) == 2  # tail skipped
    # restart: same replica name, new incarnation
    reborn = store_heat.HeatLedger(root, replica="rep-a")
    reborn.record_read(PLAN_C, 30)
    reborn.close()
    agg = store_heat.aggregate(store_heat.heat_dir(root))
    assert agg["totals"]["reads"] == 3  # 2 old + 1 new, nothing twice
    assert agg["per_plan"][PLAN_A]["reads"] == 1
    assert agg["per_plan"][PLAN_C]["reads"] == 1
    # journal_stats tolerates the torn line too
    stats = store_heat.journal_stats(store_heat.heat_dir(root))
    assert stats["reads"] == 3 and stats["files"] == 1


def test_sigkilled_writer_leaves_readable_journal(tmp_path):
    """A writer process SIGKILLed mid-soak: every line it flushed
    survives (the bytes belong to the kernel once flushed), and readers
    parse the journal without error — at most the final in-flight
    record is lost."""
    root = str(tmp_path / "store")
    ready = os.pipe()
    pid = os.fork()
    if pid == 0:  # child: append forever until killed
        os.close(ready[0])
        ledger = store_heat.HeatLedger(root, replica="victim")
        os.write(ready[1], b"x")
        i = 0
        while True:
            ledger.record_read(PLAN_A, i)
            i += 1
    os.close(ready[1])
    os.read(ready[0], 1)  # first append guaranteed underway
    os.close(ready[0])
    time.sleep(0.2)
    os.kill(pid, signal.SIGKILL)
    os.waitpid(pid, 0)
    path = os.path.join(store_heat.heat_dir(root), "victim.jsonl")
    records = store_heat.read_journal(path)
    assert records, "flushed appends must survive SIGKILL"
    assert all(r["kind"] == "read" for r in records)
    # the survivor resumes on the same journal without re-counting
    survivor = store_heat.HeatLedger(root, replica="victim")
    survivor.record_read(PLAN_B, 1)
    survivor.close()
    agg = store_heat.aggregate(store_heat.heat_dir(root))
    assert agg["per_plan"][PLAN_B]["reads"] == 1
    assert agg["totals"]["reads"] >= len(records)


def test_journal_stats_tail_sampling(tmp_path):
    """Unbounded journals are tail-sampled for the few-seconds-cadence
    fleet view; the `sampled` flag says the counts cover the recent
    window, not all time."""
    root = str(tmp_path / "store")
    ledger = store_heat.HeatLedger(root, replica="rep-a")
    for _ in range(50):
        ledger.record_read(PLAN_A, 100)
    ledger.close()
    exact = store_heat.journal_stats(store_heat.heat_dir(root))
    assert exact["reads"] == 50 and not exact["sampled"]
    window = store_heat.journal_stats(
        store_heat.heat_dir(root), tail_bytes=600)
    assert window["sampled"]
    assert 0 < window["reads"] < 50


# --------------------------------------------------- aggregate and curve


def test_aggregate_totals_equal_per_replica_sums(tmp_path):
    root = str(tmp_path / "store")
    a = store_heat.HeatLedger(root, replica="rep-a")
    b = store_heat.HeatLedger(root, replica="rep-b")
    for _ in range(3):
        a.record_read(PLAN_A, 100, size=100)
    b.record_read(PLAN_A, 0, mode="not_modified", size=100)
    b.record_read(PLAN_B, 1000, size=1000)
    a.close()
    b.close()
    agg = store_heat.aggregate(store_heat.heat_dir(root))
    totals, reps = agg["totals"], agg["by_replica"]
    assert totals["reads"] == sum(r["reads"] for r in reps.values()) == 5
    assert totals["bytes"] == sum(r["bytes"] for r in reps.values()) == 1300
    assert totals["full"] == 4 and totals["not_modified"] == 1
    assert agg["per_plan"][PLAN_A] == {
        "reads": 4, "full": 3, "not_modified": 1, "range": 0,
        "bytes": 300, "last_ts": agg["per_plan"][PLAN_A]["last_ts"],
        "size": 100, "tiers": {},
    }


def test_working_set_curve_is_hottest_first_and_sums_to_one():
    per_plan = {
        PLAN_A: {"reads": 8, "full": 8, "not_modified": 0,
                 "bytes": 800, "last_ts": 0.0, "size": 100},
        PLAN_B: {"reads": 1, "full": 1, "not_modified": 0,
                 "bytes": 900, "last_ts": 0.0, "size": 900},
        PLAN_C: {"reads": 1, "full": 1, "not_modified": 0,
                 "bytes": 0, "last_ts": 0.0, "size": 0},
    }
    curve = store_heat.working_set_curve(per_plan)
    # hottest plan first: 10% of the bytes serve 80% of the reads
    assert curve[0] == {"plans": 1, "reads_frac": 0.8, "bytes_frac": 0.1}
    assert curve[-1]["reads_frac"] == 1.0
    assert curve[-1]["bytes_frac"] == 1.0
    assert [p["reads_frac"] for p in curve] == sorted(
        p["reads_frac"] for p in curve)


# ---------------------------------------------------------------- regret


def test_regret_fires_cross_replica_within_window(tmp_path):
    """Replica A evicts; replica B serves the re-read. B's detector
    must find A's evict record in the shared journal dir and count the
    regret — with the evicting replica named as evidence."""
    root = str(tmp_path / "store")
    a = store_heat.HeatLedger(root, replica="rep-a")
    b = store_heat.HeatLedger(root, replica="rep-b")
    tm.enable()
    try:
        a.record_eviction({"plan": PLAN_A, "reason": "over_budget",
                           "freed_bytes": 100})
        regret = b.note_read_or_rebuild(PLAN_A, via="read")
        assert regret is not None
        assert regret["evicted_by"] == "rep-a"
        assert regret["via"] == "read"
        # never-evicted plans are a plain miss, not regret
        assert b.note_read_or_rebuild(PLAN_B, via="read") is None
        snap = tm.REGISTRY.snapshot()
        series = snap["chain_store_eviction_regret_total"]["series"]
        assert [(s["labels"], s["value"]) for s in series] == [
            ({"via": "read"}, 1.0)]
        # the regret landed in B's journal for the fleet rollup
        agg = store_heat.aggregate(store_heat.heat_dir(root))
        assert agg["totals"]["regrets"] == 1
    finally:
        a.close()
        b.close()


def test_regret_window_expires(tmp_path):
    root = str(tmp_path / "store")
    a = store_heat.HeatLedger(root, replica="rep-a",
                              regret_window_s=0.05)
    a.record_eviction({"plan": PLAN_A, "reason": "over_budget",
                       "freed_bytes": 1})
    time.sleep(0.1)
    assert a.note_read_or_rebuild(PLAN_A, via="read") is None
    a.close()


# --------------------------------------------------- eviction forensics


def _commit_n(store, tmp_path, n, size=100):
    hashes = []
    for i in range(n):
        out = write(str(tmp_path / f"a{i}.txt"), f"{i}" * size)
        ph = store.plan_hash({"op": "t", "i": i})
        store.commit(ph, out)
        stamp = time.time() - (n - i) * 1000
        os.utime(store.manifest_path(ph), (stamp, stamp))
        hashes.append(ph)
    return hashes


def test_gc_attaches_per_victim_evidence(tmp_path):
    """collect() must ship the same evidence dict three ways — the
    report's `victims`, the store_evict event, and the heat journal —
    while `evicted_manifests` keeps its hash-list shape for existing
    consumers."""
    store = ArtifactStore(str(tmp_path / "store"))
    hashes = _commit_n(store, tmp_path, 3, size=100)
    heat = store_heat.HeatLedger(store.root, replica="gc-test")
    for _ in range(5):
        heat.record_read(hashes[0], 100)
    tm.enable()
    try:
        report = store_gc.collect(store, size_budget_bytes=100,
                                  min_object_age_s=0.0, heat=heat)
    finally:
        heat.close()
    events = [r for r in tm.EVENTS.records()
              if r["event"] == "store_evict"]
    # shape compatibility: still the plain hash list
    assert report["evicted_manifests"] == [hashes[0], hashes[1]]
    assert len(report["victims"]) == 2
    v0 = report["victims"][0]
    assert v0["plan"] == hashes[0]
    assert v0["reason"] == "over_budget"
    assert v0["reads"] == 5  # the ledger's recorded history
    assert v0["freed_bytes"] == 100
    assert v0["budget_bytes"] == 100
    assert v0["last_used_age_s"] > 100  # LRU-stamped ~3000s ago
    # event and journal carry the SAME evidence
    assert [rec["plan"] for rec in events] == [hashes[0], hashes[1]]
    assert events[0]["reads"] == 5
    journal = [r for r in store_heat.read_journals(
        store_heat.heat_dir(store.root)) if r["kind"] == "evict"]
    assert [r["plan"] for r in journal] == [hashes[0], hashes[1]]
    assert journal[0]["reads"] == 5


def test_gc_orphan_evidence_and_dry_run_journals_nothing(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    _commit_n(store, tmp_path, 1)
    orphan = write(store.object_path("ab" + "0" * 62), "orphan")
    os.utime(orphan, (time.time() - 7200,) * 2)
    heat = store_heat.HeatLedger(store.root, replica="gc-test")
    dry = store_gc.collect(store, min_object_age_s=3600, dry_run=True,
                           heat=heat)
    assert dry["victims"][0]["reason"] == "orphan"
    assert store_heat.aggregate(
        store_heat.heat_dir(store.root))["totals"]["evictions"] == 0
    report = store_gc.collect(store, min_object_age_s=3600, heat=heat)
    heat.close()
    v = report["victims"][0]
    assert v["reason"] == "orphan"
    assert v["age_s"] >= 3600 and v["freed_bytes"] == 6
    agg = store_heat.aggregate(store_heat.heat_dir(store.root))
    assert agg["totals"]["evictions"] == 1


# ----------------------------------------------------- catalog contracts


def test_read_bands_fit_buckets_and_size_classes():
    """Same invariant the core SLO bands pin: a band past the largest
    finite bucket could never report a breach. And every size class
    must carry a band in every read phase."""
    max_bucket = max(catalog.READ_LATENCY_BUCKETS)
    classes = [label for _, label in catalog.READ_SIZE_CLASSES]
    for phase, bands in catalog.READ_SLO_BANDS.items():
        assert sorted(bands) == sorted(classes), phase
        for label, band_s in bands.items():
            assert band_s <= max_bucket, (phase, label)
    # class boundaries
    assert catalog.read_size_class(0) == "lt1m"
    assert catalog.read_size_class((1 << 20) - 1) == "lt1m"
    assert catalog.read_size_class(1 << 20) == "lt16m"
    assert catalog.read_size_class(16 << 20) == "lt256m"
    assert catalog.read_size_class(1 << 40) == "ge256m"


def test_read_slo_report_grades_against_read_bands():
    """read_slo_report is slo_report's sibling: same cell shape, graded
    per (tenant × size class) against READ_SLO_BANDS."""
    buckets = {"0.0005": 90.0, "0.25": 95.0, "120.0": 100.0,
               "+Inf": 100.0}
    merged = {
        ("chain_serve_read_ttfb_seconds",
         (("size_class", "lt1m"), ("tenant", "t0"))): {
            "labels": {"tenant": "t0", "size_class": "lt1m"},
            "buckets": buckets, "sum": 1.0, "count": 100,
        },
    }
    report = fleet.read_slo_report(merged)
    cell = report["t0"]["lt1m"]["read_ttfb_s"]
    assert cell["count"] == 100
    assert cell["band_s"] == 0.05
    # band 0.05 falls between bucket bounds; band_fraction reads the
    # first bound >= the band (0.25, cum 95) — the documented one-bucket
    # over-estimate
    assert cell["within_band"] == 0.95
    assert cell["ok"] is False  # 0.95 < SLO_TARGET_FRACTION (0.99)


# ----------------------------------------------- serve read path, live


def _get(url, etag=None):
    req = urllib.request.Request(url)
    if etag:
        req.add_header("If-None-Match", etag)
    try:
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        body = exc.read()
        return exc.code, dict(exc.headers), body


def test_service_read_path_etag_heat_and_regret(tmp_path):
    """The read path end to end over a live service: strong ETag on
    200, If-None-Match answered 304 with no body, both recorded in the
    heat ledger with tenant/size class, TTFB/full histograms observed,
    and a forced undersized-budget eviction turning the next read into
    a 404 that counts as eviction regret."""
    from processing_chain_tpu_torch.serve.service import ChainServeService

    root = str(tmp_path / "serve")
    svc = ChainServeService(root=root, port=0, executor="synthetic",
                            workers=2).start()
    try:
        rid = svc.submit({
            "tenant": "t0", "priority": "normal", "database": "P2STR01",
            "srcs": ["SRC100"], "hrcs": ["HRC100"],
            "params": {"geometry": [64, 36], "size_bytes": 2048},
        })["request"]
        assert svc.wait_request(rid, timeout=30.0) == "done"
        plan = next(
            iter(svc.request_status(rid)["units"].values()))["plan"]
        url = f"{svc.server.url}/v1/artifacts/{plan}?tenant=t0"

        status, headers, body = _get(url)
        assert status == 200 and len(body) == 2048
        assert headers["ETag"] == f'"{plan}"'
        assert "immutable" in headers["Cache-Control"]
        status, headers, body = _get(url, etag=headers["ETag"])
        assert status == 304 and body == b""
        assert headers["ETag"] == f'"{plan}"'

        records = [r for r in store_heat.read_journals(
            store_heat.heat_dir(svc.store.root))
            if r["kind"] == "read"]
        assert [r["mode"] for r in records] == ["full", "not_modified"]
        assert all(r["plan"] == plan and r["tenant"] == "t0"
                   and r["size_class"] == "lt1m" for r in records)
        assert records[0]["bytes"] == 2048
        assert records[0]["ttfb_s"] is not None
        assert records[1]["bytes"] == 0  # no fd, no bytes on a 304

        snap = tm.REGISTRY.snapshot()
        labels = {"tenant": "t0", "size_class": "lt1m"}

        def _series(name):
            return {tuple(sorted(s["labels"].items())): s
                    for s in snap[name]["series"]}

        key = tuple(sorted(labels.items()))
        ttfb = _series("chain_serve_read_ttfb_seconds")[key]
        assert ttfb["count"] == 2  # full + 304
        full = _series("chain_serve_read_seconds")[key]
        assert full["count"] == 1  # full only
        reads = _series("chain_store_reads_total")
        assert reads[(("mode", "full"),)]["value"] == 1
        assert reads[(("mode", "not_modified"),)]["value"] == 1

        # undersized budget: force the pressure pass, then re-read
        svc.pressure.budget_bytes = 1
        summary = svc.pressure.maybe_collect(force=True)
        assert plan in summary["evicted_manifests"]
        assert summary["victims"][0]["reason"] == "over_budget"
        status, _, _ = _get(url)
        assert status == 404
        snap = tm.REGISTRY.snapshot()
        regret = {tuple(sorted(s["labels"].items())): s["value"]
                  for s in snap[
                      "chain_store_eviction_regret_total"]["series"]}
        assert regret[(("via", "read"),)] == 1
    finally:
        svc.stop()


def test_heat_journal_keeps_request_order_when_a_stream_completes_late(
        tmp_path):
    """A 200's read record is appended when its stream completes, which
    can be after its client has already had the 304 of its next request
    answered and journalled. The journal orders reads by their arrival,
    so the 200 still comes first: the record's completion is held back
    here until the 304 is in the journal."""
    from processing_chain_tpu_torch.serve.service import ChainServeService

    root = str(tmp_path / "serve")
    svc = ChainServeService(root=root, port=0, executor="synthetic",
                            workers=2).start()
    try:
        rid = svc.submit({
            "tenant": "t0", "priority": "normal", "database": "P2STR01",
            "srcs": ["SRC101"], "hrcs": ["HRC100"],
            "params": {"geometry": [64, 36], "size_bytes": 2048},
        })["request"]
        assert svc.wait_request(rid, timeout=30.0) == "done"
        plan = next(
            iter(svc.request_status(rid)["units"].values()))["plan"]
        url = f"{svc.server.url}/v1/artifacts/{plan}?tenant=t0"
        heat_dir = store_heat.heat_dir(svc.store.root)
        record_read = svc.heat.record_read

        def late_full(*args, **kwargs):
            if kwargs.get("mode") == "full":
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and not any(
                        r.get("mode") == "not_modified"
                        for r in store_heat.read_journals(heat_dir)):
                    time.sleep(0.01)
            record_read(*args, **kwargs)

        svc.heat.record_read = late_full
        status, headers, body = _get(url)
        assert status == 200 and len(body) == 2048
        status, _, body = _get(url, etag=headers["ETag"])
        assert status == 304 and body == b""
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            records = [r for r in store_heat.read_journals(heat_dir)
                       if r["kind"] == "read"]
            if len(records) == 2:
                break
            time.sleep(0.01)
        # the 304 was journalled first, yet reads in request order
        assert [r["mode"] for r in records] == ["full", "not_modified"]
        assert records[0]["seq"] > records[1]["seq"]
    finally:
        svc.stop()


def test_fleet_view_carries_heat_and_read_slo(tmp_path):
    """/fleet must roll the read path up: the tail-sampled heat summary
    (durable — works with every replica dead) and the merged read-SLO
    grades per (tenant × size class)."""
    from processing_chain_tpu_torch.serve.service import ChainServeService

    root = str(tmp_path / "serve")
    svc = ChainServeService(root=root, port=0, executor="synthetic",
                            workers=2).start()
    try:
        rid = svc.submit({
            "tenant": "t0", "priority": "normal", "database": "P2STR01",
            "srcs": ["SRC100"], "hrcs": ["HRC100"],
            "params": {"geometry": [64, 36], "size_bytes": 2048},
        })["request"]
        assert svc.wait_request(rid, timeout=30.0) == "done"
        plan = next(
            iter(svc.request_status(rid)["units"].values()))["plan"]
        _get(f"{svc.server.url}/v1/artifacts/{plan}?tenant=t0")
        view = fleet.fleet_view(root)
        assert view["heat"]["reads"] == 1
        assert view["heat"]["full"] == 1
        assert view["heat"]["bytes_served"] == 2048
        cell = view["read_slo"]["t0"]["lt1m"]["read_ttfb_s"]
        assert cell["count"] == 1 and cell["band_s"] == 0.05
        assert view["read_slo_bands"] == catalog.READ_SLO_BANDS
        # the /fleet endpoint serves the same document
        with urllib.request.urlopen(svc.server.url + "/fleet",
                                    timeout=10.0) as resp:
            doc = json.loads(resp.read().decode())
        assert doc["heat"]["reads"] == view["heat"]["reads"]
        # fleet-top renders the reads line and the read-SLO section
        from processing_chain_tpu_torch.tools import fleet_top

        frame = fleet_top.render(view)
        assert "reads: 1" in frame
        assert "read SLO" in frame
        assert "read_ttfb_s" in frame
    finally:
        svc.stop()


# ---------------------------------------- parity with the reference


def _strip_times(obj):
    """Drop the wall-clock fields (record stamps, ages) so two ledgers
    driven by the same sequence compare exactly."""
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("ts", "last_ts", "evicted_ago_s",
                             "generated_at")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def _drive_heat(mod, root: str, seed: int) -> list:
    """One seeded access sequence through `mod`'s HeatLedger: reads of
    every mode and tier, evictions, and regret checks (reads and
    rebuilds) of evicted and never-evicted plans. Returns the regret
    checks' results."""
    import numpy as np

    rng = np.random.default_rng(seed)
    plans = [f"{i:02x}" * 32 for i in range(8)]
    ledger = mod.HeatLedger(root, replica="rep-a")
    out = []
    for _ in range(120):
        plan = plans[min(int(rng.zipf(1.6)) - 1, len(plans) - 1)]
        roll = rng.random()
        if roll < 0.7:
            size = int(rng.integers(1, 1 << 28))
            mode = str(rng.choice(["full", "range", "not_modified"]))
            nbytes = {"full": size, "range": size // 4,
                      "not_modified": 0}[mode]
            ledger.record_read(
                plan, nbytes, mode=mode, size=size,
                size_class=catalog.read_size_class(size), tenant="acme",
                tier=str(rng.choice(["hot", "warm", "cold"])))
        elif roll < 0.85:
            ledger.record_eviction({
                "plan": plan, "reason": "over_budget",
                "freed_bytes": int(rng.integers(1, 1 << 20)),
                "objects": 1})
        else:
            via = str(rng.choice(["read", "rebuild"]))
            out.append(_strip_times(ledger.note_read_or_rebuild(plan, via)))
    ledger.close()
    return out


def test_heat_ledger_report_equals_the_reference(tmp_path):
    """The same access sequence through both ledgers: equal regret
    verdicts and an equal report (aggregate, working-set curve, journal
    stats) once the wall-clock stamps are set aside; and each package's
    reader folds the other's journal to exactly its own answer."""
    from processing_chain_tpu.store import heat as jheat

    port_root = str(tmp_path / "port")
    ref_root = str(tmp_path / "ref")
    ours = _drive_heat(store_heat, port_root, 31)
    ref = _drive_heat(jheat, ref_root, 31)
    assert ours == ref
    assert any(r is not None for r in ours)    # regret was exercised
    agg = store_heat.aggregate(store_heat.heat_dir(port_root))
    ref_agg = jheat.aggregate(jheat.heat_dir(ref_root))
    assert _strip_times(agg) == _strip_times(ref_agg)
    assert agg["totals"]["regrets"] > 0 and agg["totals"]["evictions"] > 0
    assert store_heat.working_set_curve(agg["per_plan"]) == \
        jheat.working_set_curve(ref_agg["per_plan"])
    for root in (port_root, ref_root):
        hdir = store_heat.heat_dir(root)
        assert store_heat.aggregate(hdir) == jheat.aggregate(hdir)
        assert store_heat.read_journals(hdir) == jheat.read_journals(hdir)
        assert _strip_times(store_heat.journal_stats(hdir)) == \
            _strip_times(jheat.journal_stats(hdir))


def test_store_heat_tool_report_equals_the_reference(tmp_path, capsys):
    """`tools store-heat report --json` of both packages over one store
    root print the same document."""
    from processing_chain_tpu.tools import store_heat as jtool

    from processing_chain_tpu_torch.tools import store_heat as ttool

    root = str(tmp_path / "store")
    _drive_heat(store_heat, root, 32)
    assert ttool.main(["report", root, "--json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jtool.main(["report", root, "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert _strip_times(ours) == _strip_times(ref)
    assert ours["totals"]["reads"] > 0
