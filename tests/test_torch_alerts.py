"""The port's SLO control loop (the contracts of tests/test_alerts.py,
without its bench-history tests, whose tool belongs to the bench
harness the port does not carry yet): burn-rate window math, the
multi-window trip contract, the fire/renotify/resolve lifecycle with
dedup, the cross-plane graders, the autoscale advisor and fleet-doctor's
incident render; then parity with the reference package.

Every engine test drives synthetic fleet-view documents with explicit
`now` timestamps — no sleeping, no live replicas; the live path is the
breach soak (`tools fleet-doctor --soak`), which chip_smoke.py runs and
holds to the invariants of the committed ALERTS_r20.json."""

from __future__ import annotations

import json
import os
import time

import pytest

from processing_chain_tpu_torch.telemetry import alerts, catalog
from processing_chain_tpu_torch.serve.autoscale import AutoscaleAdvisor

BUDGET = 1.0 - catalog.SLO_TARGET_FRACTION


def _slo_view(count, within_band, tenant="acme", cls="interactive",
              phase="queue_wait_s"):
    return {"slo": {tenant: {cls: {phase: {
        "count": count, "within_band": within_band}}}}}


def _engine(tmp_path, **kw):
    return alerts.AlertEngine(str(tmp_path), "rep-a", **kw)


# ----------------------------------------------------- FlowWindow math


def test_flow_window_burn_math():
    w = alerts.FlowWindow()
    assert w.burn(100.0, 60.0) is None          # no history
    w.add(0.0, 0.0, None)
    assert w.burn(100.0, 60.0) is None          # one snapshot
    w.add(60.0, 100.0, 0.9)                      # 10% errors
    assert w.burn(60.0, 120.0) == pytest.approx(0.1 / BUDGET)
    # no NEW observations in the window -> None, not 0.0
    w.add(120.0, 100.0, 0.9)
    assert w.burn(120.0, 30.0) is None
    # windowed: only the delta since the window's far edge counts —
    # the 100 new in-band obs, not the older error mass
    w.add(150.0, 200.0, 0.95)                    # cumulative in-band 190
    assert w.burn(150.0, 50.0) == pytest.approx(0.0)


def test_flow_window_short_history_grades_over_what_exists():
    w = alerts.FlowWindow()
    w.add(0.0, 0.0, None)
    w.add(10.0, 100.0, 0.5)
    # 3600 s window, 10 s of history: grade anyway (the engine would
    # otherwise be blind for the first hour of every incident)
    assert w.burn(10.0, 3600.0) == pytest.approx(0.5 / BUDGET)


def test_flow_window_prune_keeps_far_edge():
    w = alerts.FlowWindow()
    for t in range(0, 100, 10):
        w.add(float(t), float(t), None)
    w.prune(100.0, 30.0)
    # one snapshot OLDER than the horizon survives as the far edge
    assert w.snaps[0][0] <= 70.0
    assert len(w.snaps) < 10


def test_flow_window_sparse_evaluations_grade_against_the_one_before():
    """Evaluations sparser than the window leave only the newest
    snapshot inside it. The port grades against the evaluation before
    (the reference returns None there and never sees the step)."""
    from processing_chain_tpu.telemetry import alerts as jalerts

    ours, ref = alerts.FlowWindow(), jalerts.FlowWindow()
    for w in (ours, ref):
        w.add(0.0, 0.0, None)
        w.add(100.0, 100.0, 0.5)
    assert ours.far_edge(100.0, 30.0) == (0.0, 0.0, 0.0)
    assert ours.burn(100.0, 30.0) == pytest.approx(0.5 / BUDGET)
    assert ref.burn(100.0, 30.0) is None
    # a snapshot inside the window besides the newest: the same edge
    # as the reference's
    for w in (ours, ref):
        w.add(110.0, 200.0, 0.75)
    assert ours.burn(110.0, 30.0) == ref.burn(110.0, 30.0)


def test_regret_step_between_sparse_evaluations_fires(tmp_path):
    """A regret step between two evaluations farther apart than the
    fast window fires once and resolves at the next evaluation; the
    reference's engine grades the same views silent."""
    from processing_chain_tpu.telemetry import alerts as jalerts

    short = catalog.BURN_RATE_WINDOWS["fast"]["short_s"]
    ours = _engine(tmp_path / "port")
    ref = jalerts.AlertEngine(str(tmp_path / "ref"), "rep-a")
    views = [(100.0, 0), (100.0 + 1.5 * short, 4), (100.0 + 3 * short, 4)]
    got = {"port": [], "ref": []}
    for now, regrets in views:
        for name, eng in (("port", ours), ("ref", ref)):
            r = eng.evaluate({"heat": {"regrets": regrets}}, now=now)
            got[name].append(([s["rule"] for s in r["fired"]],
                              len(r["resolved"])))
    assert got["port"] == [([], 0), (["store_eviction_regret"], 0), ([], 1)]
    assert got["ref"] == [([], 0), ([], 0), ([], 0)]
    ours.close()
    ref.close()


# ------------------------------------------------- burn rules + dedup


def test_burn_rule_fires_renotifies_resolves(tmp_path):
    eng = _engine(tmp_path, renotify_s=5.0)
    t0 = 1000.0
    # first pass only snapshots (no delta yet): nothing fires
    r = eng.evaluate(_slo_view(10, 1.0), now=t0)
    assert r["fired"] == [] and r["active"] == []
    # ~55% of the new observations err >> the 14.4x fast burn
    # threshold on both windows
    r = eng.evaluate(_slo_view(100, 0.5), now=t0 + 10)
    assert len(r["fired"]) == 1
    state = r["fired"][0]
    assert state["rule"] == "slo_burn_queue_wait"
    assert state["labels"] == {"tenant": "acme", "class": "interactive",
                               "phase": "queue_wait_s"}
    assert state["alert"] == ("slo_burn_queue_wait{class=interactive,"
                              "phase=queue_wait_s,tenant=acme}")
    assert state["value"] >= catalog.BURN_RATE_WINDOWS["fast"]["burn_rate"]
    # the condition holding is ONE incident: no second fire, renotify
    # only on the throttle
    r = eng.evaluate(_slo_view(150, 0.5), now=t0 + 12)
    assert r["fired"] == [] and len(r["active"]) == 1
    r = eng.evaluate(_slo_view(200, 0.5), now=t0 + 20)
    assert r["fired"] == []
    # past every window: the stale snapshots age out, burn -> None
    t_late = t0 + catalog.BURN_RATE_WINDOWS["slow"]["long_s"] + 100
    r = eng.evaluate(_slo_view(300, 0.99), now=t_late)
    assert len(r["resolved"]) == 1 and r["active"] == []
    assert r["resolved"][0]["id"] == state["id"]
    # the journal carries the full lifecycle under one id
    records = alerts.read_journals(alerts.alerts_dir(str(tmp_path)))
    kinds = [rec["kind"] for rec in records
             if rec.get("id") == state["id"]]
    assert kinds[0] == "fired" and kinds[-1] == "resolved"
    assert "renotify" in kinds
    assert kinds.count("fired") == 1          # dedup: exactly one fire
    eng.close()


def test_one_bad_window_does_not_trip(tmp_path):
    """A pair trips only when BOTH windows burn: a short error burst
    inside an otherwise-healthy long window must not page."""
    eng = _engine(tmp_path)
    t0 = 1000.0
    # a long healthy history spanning the long windows...
    eng.evaluate(_slo_view(100, 0.999), now=t0)
    eng.evaluate(_slo_view(5_000, 0.999), now=t0 + 600)
    eng.evaluate(_slo_view(10_000, 0.999), now=t0 + 3000)
    # ...then a short burst of errors: the fast-short window burns but
    # every long window (diluted by the healthy mass) stays under
    r = eng.evaluate(_slo_view(10_050, 0.994), now=t0 + 3060)
    assert r["fired"] == [] and r["active"] == []
    eng.close()


def test_window_scale_compresses_uniformly(tmp_path):
    eng = _engine(tmp_path, window_scale=0.001, renotify_s=5.0)
    assert eng.renotify_s == pytest.approx(0.005)
    t0 = 1000.0
    eng.evaluate(_slo_view(10, 1.0), now=t0)
    # 0.2 s later: inside the scaled fast-short window (0.3 s)
    r = eng.evaluate(_slo_view(100, 0.5), now=t0 + 0.2)
    assert len(r["fired"]) == 1
    # 25 s >> every scaled window (slow long = 21.6 s): resolves
    r = eng.evaluate(_slo_view(110, 0.99), now=t0 + 25.0)
    assert len(r["resolved"]) == 1
    eng.close()


def test_engine_never_raises_on_malformed_view(tmp_path):
    eng = _engine(tmp_path)
    r = eng.evaluate({}, now=1.0)
    assert r == {"active": [], "fired": [], "resolved": []}
    r = eng.evaluate({"slo": {"t": {"interactive": {"queue_wait_s":
                                                    "garbage"}}},
                      "stalls": [None], "heat": {"regrets": "x"},
                      "mesh": {"buckets": "nope"},
                      "replicas": "also nope"}, now=2.0)
    assert r["fired"] == []
    eng.close()


# ------------------------------------------------- cross-plane graders


def test_stall_rules_match_their_incident(tmp_path):
    eng = _engine(tmp_path)
    stall = {"replica": "rep-b", "task": "wave", "stage": "p03",
             "incident": "stalled", "beat_age_s": 42.0, "kind": "task"}
    hard = dict(stall, task="ingest", incident="hard_timeout")
    r = eng.evaluate({"stalls": [stall, hard]}, now=10.0)
    rules = sorted(s["rule"] for s in r["fired"])
    assert rules == ["watchdog_hard_timeout", "watchdog_task_stalled"]
    by_rule = {s["rule"]: s for s in r["fired"]}
    assert by_rule["watchdog_task_stalled"]["labels"]["task"] == "wave"
    assert by_rule["watchdog_hard_timeout"]["labels"]["task"] == "ingest"
    # the episode ending resolves both
    r = eng.evaluate({"stalls": []}, now=20.0)
    assert len(r["resolved"]) == 2
    eng.close()


def test_heat_regret_rule_is_delta_based_and_monotonic(tmp_path):
    eng = _engine(tmp_path)
    # a fleet that ALWAYS had 5 regrets on record must not fire on the
    # first scrape — only fresh regret inside the fast window counts
    r = eng.evaluate({"heat": {"regrets": 5}}, now=100.0)
    assert r["fired"] == []
    r = eng.evaluate({"heat": {"regrets": 7}}, now=110.0)
    assert [s["rule"] for s in r["fired"]] == ["store_eviction_regret"]
    assert r["fired"][0]["value"] == 2
    # tail-sampled stats can slide DOWN; the clamp keeps a slide from
    # reading as fresh regret (or as recovery noise)
    t_late = 110.0 + catalog.BURN_RATE_WINDOWS["fast"]["short_s"] + 60
    r = eng.evaluate({"heat": {"regrets": 3}}, now=t_late)
    assert r["fired"] == [] and len(r["resolved"]) == 1
    eng.close()


def test_mesh_waste_rule_needs_waves_and_threshold(tmp_path):
    from processing_chain_tpu_torch.telemetry.profiling import (
        FRAGMENTATION_WASTE_THRESHOLD,
    )

    eng = _engine(tmp_path)
    buckets = {
        "64x36": {"waves": 10,
                  "waste_fraction": FRAGMENTATION_WASTE_THRESHOLD + 0.1},
        "young": {"waves": 2, "waste_fraction": 0.9},   # too few waves
        "tight": {"waves": 50, "waste_fraction": 0.01},  # no waste
    }
    r = eng.evaluate({"mesh": {"buckets": buckets}}, now=5.0)
    assert [s["labels"]["bucket"] for s in r["fired"]] == ["64x36"]
    eng.close()


def test_stale_replica_rule_grades_last_seen_age(tmp_path):
    eng = _engine(tmp_path)
    reps = [
        {"replica": "ok-a", "status": "ok"},
        {"replica": "young", "status": "stale", "last_seen_s": 5.0},
        {"replica": "gone", "status": "stale", "last_seen_s": 45.0},
    ]
    r = eng.evaluate({"replicas": reps}, now=50.0)
    assert [s["labels"]["replica"] for s in r["fired"]] == ["gone"]
    assert r["fired"][0]["severity"] == "page"
    # the registration disappearing (or the replica answering again)
    # resolves it
    r = eng.evaluate({"replicas": [reps[0]]}, now=60.0)
    assert [s["labels"]["replica"] for s in r["resolved"]] == ["gone"]
    eng.close()


# ----------------------------------------------------- journal + fold


def test_alert_journal_seals_torn_tail(tmp_path):
    root = str(tmp_path / "alerts")
    j = alerts.AlertJournal(root, "rep-a")
    j.append({"kind": "fired", "id": "al-1", "alert": "k"})
    j.close()
    path = os.path.join(root, "rep-a.jsonl")
    with open(path, "a") as f:
        f.write('{"kind": "fired", "id": "al-2", "al')   # torn write
    j2 = alerts.AlertJournal(root, "rep-a")
    j2.append({"kind": "resolved", "id": "al-1", "alert": "k"})
    j2.close()
    records = alerts.read_journal(path)
    assert [r["kind"] for r in records] == ["fired", "resolved"]
    # merged readers order by (ts, replica, seq) across replicas
    jb = alerts.AlertJournal(root, "rep/b")   # unsafe name sanitized
    jb.append({"kind": "fired", "id": "al-9", "alert": "x"})
    jb.close()
    merged = alerts.read_journals(root)
    assert len(merged) == 3
    assert {r["replica"] for r in merged} == {"rep-a", "rep/b"}
    stats = alerts.journal_stats(root)
    assert stats["files"] == 2 and stats["bytes"] > 0


def test_fold_reopens_episodes_and_reports(tmp_path):
    root = str(tmp_path)
    j = alerts.AlertJournal(alerts.alerts_dir(root), "rep-a")
    j.append({"kind": "fired", "id": "al-1", "alert": "k", "rule": "r",
              "severity": "page", "labels": {}, "ts": 10.0})
    j.append({"kind": "resolved", "id": "al-1", "alert": "k",
              "rule": "r", "duration_s": 5.0, "ts": 15.0})
    j.append({"kind": "fired", "id": "al-2", "alert": "k", "rule": "r",
              "severity": "page", "labels": {}, "ts": 20.0})
    j.append({"kind": "scale", "desired": 2, "current": 1, "ts": 21.0})
    j.close()
    folded = alerts.fold(alerts.read_journals(alerts.alerts_dir(root)))
    assert folded["k"]["state"] == "firing"
    assert folded["k"]["id"] == "al-2"          # the re-fire episode
    assert folded["k"]["episodes"] == 2
    active = alerts.active_alerts(root)
    assert [a["id"] for a in active] == ["al-2"]
    report = alerts.alerts_report(root)
    assert report["schema"] == 1
    assert report["rules"] == sorted(catalog.ALERT_RULES)
    assert [a["id"] for a in report["active"]] == ["al-2"]
    assert report["counts"]["fired"] == 2
    scale = alerts.latest_scale(root)
    assert scale["desired"] == 2 and scale["kind"] == "scale"
    # find_alert resolves by episode id or dedup key
    assert alerts.find_alert(root, "al-1")["alert"] == "k"
    assert alerts.find_alert(root, "k")["id"] == "al-2"
    assert alerts.find_alert(root, "nope") is None


# --------------------------------------------------------- autoscale


def _advisor(tmp_path, **kw):
    journal = alerts.AlertJournal(alerts.alerts_dir(str(tmp_path)),
                                  "rep-a")
    kw.setdefault("workers", 1)
    return AutoscaleAdvisor(journal, "rep-a", **kw), journal


def test_autoscale_steady_and_backlog_pressure(tmp_path):
    adv, journal = _advisor(tmp_path)
    sig = adv.evaluate(current_replicas=1, backlog={}, outstanding_s=0.0,
                       active_alerts=[], now=100.0)
    assert sig["replicas_desired"] == 1
    assert "steady" in sig["reasons"]
    assert "cold_cost_model" in sig["reasons"]
    # interactive backlog must drain inside its 2.5 s queue-wait band
    band = catalog.SLO_BANDS["queue_wait_s"]["interactive"]
    sig = adv.evaluate(
        current_replicas=1,
        backlog={"interactive": {"count": 10, "cost_s": 50.0}},
        outstanding_s=50.0, active_alerts=[], now=101.0)
    assert sig["inputs"]["horizon_s"] == band
    assert sig["replicas_desired"] == -(-50.0 // band)  # ceil
    assert "backlog_pressure" in sig["reasons"]
    # bulk-only backlog gets the loose horizon
    sig = adv.evaluate(
        current_replicas=1,
        backlog={"bulk": {"count": 4, "cost_s": 50.0}},
        outstanding_s=50.0, active_alerts=[], now=102.0)
    assert sig["inputs"]["horizon_s"] == \
        catalog.SLO_BANDS["queue_wait_s"]["bulk"]
    journal.close()


def test_autoscale_burn_hold_and_journal(tmp_path):
    adv, journal = _advisor(tmp_path, scale_down_hold_s=100.0)
    burn = [{"rule": "slo_burn_queue_wait", "alert": "k"}]
    sig = adv.evaluate(current_replicas=4, backlog={}, outstanding_s=0.0,
                       active_alerts=burn, now=10.0)
    assert sig["replicas_desired"] == 6          # current + current//2
    assert "queue_wait_burn" in sig["reasons"]
    assert sig["inputs"]["burning_alerts"] == ["k"]
    # a non-burn alert (e.g. mesh waste) is NOT scale-up evidence
    sig = adv.evaluate(current_replicas=4, backlog={}, outstanding_s=0.0,
                       active_alerts=[{"rule": "mesh_waste_high"}],
                       now=11.0)
    assert "queue_wait_burn" not in sig["reasons"]
    # ...and that quiet moment starts the hold: desired stays pinned
    # at current until the calm is sustained
    assert sig["replicas_desired"] == 4
    assert "scale_down_hold" in sig["reasons"]
    sig = adv.evaluate(current_replicas=4, backlog={}, outstanding_s=0.0,
                       active_alerts=[], now=112.0)   # past the hold
    assert sig["replicas_desired"] == 1
    assert "idle_capacity" in sig["reasons"]
    assert adv.latest() == sig
    journal.close()
    # journaled only when the desired count MOVED: 1 -> 6 -> (held) -> 1
    scales = [r for r in alerts.read_journals(
        alerts.alerts_dir(str(tmp_path))) if r["kind"] == "scale"]
    assert [r["desired"] for r in scales] == [6, 4, 1]
    assert all(r["replica"] == "rep-a" for r in scales)


def test_autoscale_confidence_and_ceiling(tmp_path):
    adv, journal = _advisor(tmp_path, max_replicas=4)
    sig = None
    for i in range(3):
        sig = adv.evaluate(current_replicas=1, backlog={},
                           outstanding_s=0.0, active_alerts=[],
                           calibrated=True, now=float(i))
    assert "cold_cost_model" not in sig["reasons"]
    assert sig["confidence"] > 0.7
    # the ceiling clamps and says so
    sig = adv.evaluate(
        current_replicas=1,
        backlog={"interactive": {"count": 100, "cost_s": 1000.0}},
        outstanding_s=1000.0, active_alerts=[], now=4.0)
    assert sig["replicas_desired"] == 4
    assert "max_ceiling" in sig["reasons"]
    journal.close()


# ------------------------------------------- fleet-doctor correlation


def test_render_incident_joins_planes(tmp_path):
    from processing_chain_tpu_torch.serve import spans as serve_spans
    from processing_chain_tpu_torch.tools import fleet_doctor

    root = str(tmp_path)
    now = 1_000_000.0
    aj = alerts.AlertJournal(alerts.alerts_dir(root), "rep-a")
    aj.append({"kind": "fired", "id": "al-rep-a-0001", "alert": "k{}",
               "rule": "slo_burn_queue_wait", "severity": "page",
               "labels": {}, "reason": "burning", "ts": now})
    aj.append({"kind": "resolved", "id": "al-rep-a-0001", "alert": "k{}",
               "rule": "slo_burn_queue_wait", "duration_s": 4.0,
               "ts": now + 4.0})
    aj.close()
    sj = serve_spans.SpanJournal(os.path.join(root, "queue", "spans"),
                                 "rep-a")
    sj.append("enqueue", job="j1", plan="p", state="queued", epoch=0,
              ts=now + 1.0)
    sj.close()
    # a span far outside the window must NOT render
    sj2 = serve_spans.SpanJournal(os.path.join(root, "queue", "spans"),
                                  "rep-b")
    sj2.append("enqueue", job="far", plan="p", state="queued", epoch=0,
               ts=now + 9999.0)
    sj2.close()
    incident = fleet_doctor.render_incident(root, "al-rep-a-0001",
                                            window_s=10.0)
    assert incident is not None
    assert incident["planes"] == ["alerts", "spans"]
    assert "FIRED slo_burn_queue_wait" in incident["text"]
    assert "j1" in incident["text"] and "far" not in incident["text"]
    # the dedup key resolves to the same incident; garbage does not
    assert fleet_doctor.render_incident(root, "k{}") is not None
    assert fleet_doctor.render_incident(root, "al-nope") is None
    trace = fleet_doctor.chrome_trace(incident)
    names = {e["ph"] for e in trace["traceEvents"]}
    assert {"i", "X", "M"} <= names
    episode = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert episode[0]["dur"] == pytest.approx(4.0 * 1e6)


# ------------------------------------------------------ catalog sanity


def test_alert_rules_catalog_sanity():
    sources = {"slo", "read_slo", "stalls", "heat", "mesh", "replicas"}
    for rule, spec in catalog.ALERT_RULES.items():
        assert spec["source"] in sources, rule
        assert spec.get("severity") in ("page", "ticket"), rule
        if spec["source"] == "slo":
            assert spec["phase"] in catalog.SLO_BANDS, rule
        if spec["source"] == "read_slo":
            assert spec["phase"] in catalog.READ_SLO_BANDS, rule
    for w in catalog.BURN_RATE_WINDOWS.values():
        assert 0 < w["short_s"] < w["long_s"]
        assert w["burn_rate"] > 1.0
    fast = catalog.BURN_RATE_WINDOWS["fast"]
    slow = catalog.BURN_RATE_WINDOWS["slow"]
    assert fast["short_s"] < slow["short_s"]
    assert fast["burn_rate"] > slow["burn_rate"]
    # the reference's chain-lint drift checker parses the same names by
    # AST, from the port's catalog and from the reference's
    from processing_chain_tpu.tools.chainlint.telemetry_names import (
        load_catalog,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, _, rules = load_catalog(os.path.join(
        repo, "processing_chain_tpu_torch", "telemetry", "catalog.py"))
    _, _, ref_rules = load_catalog(os.path.join(
        repo, "processing_chain_tpu", "telemetry", "catalog.py"))
    assert rules == set(catalog.ALERT_RULES) == ref_rules


# ---------------------------------------- parity with the reference


def _seeded_views(seed: int, steps: int = 40) -> list:
    """A seeded run of fleet views: a healthy stretch, a breach of the
    queue-wait and read-TTFB bands, stalls, fresh eviction regret, a
    wasteful wave bucket and a replica going stale, then recovery."""
    import numpy as np

    rng = np.random.default_rng(seed)
    count = within = rcount = rwithin = regrets = 0
    views = []
    for k in range(steps):
        breach = 12 <= k < 24
        n = int(rng.integers(5, 60))
        count += n
        within += int(n * rng.uniform(0.0, 0.4)) if breach else n
        rn = int(rng.integers(1, 20))
        rcount += rn
        rwithin += int(rn * rng.uniform(0.0, 0.5)) if breach else rn
        if breach and rng.random() < 0.5:
            regrets += int(rng.integers(1, 3))
        stall = {"replica": "rep-b", "task": "wave", "stage": "serve",
                 "incident": "stalled" if rng.random() < 0.7
                 else "hard_timeout",
                 "beat_age_s": float(rng.uniform(10, 90)), "kind": "task"}
        views.append({
            "slo": {"acme": {"interactive": {"queue_wait_s": {
                "count": count, "within_band": within / count}}}},
            "read_slo": {"acme": {"ge256m": {"read_ttfb_s": {
                "count": rcount, "within_band": rwithin / rcount}}}},
            "stalls": [stall] if breach and rng.random() < 0.4 else [],
            "heat": {"regrets": regrets},
            "mesh": {"buckets": {"2160x3840": {
                "waves": k + 1,
                "waste_fraction": float(rng.uniform(0.3, 0.6))
                if breach else 0.0}}},
            "replicas": [
                {"replica": "rep-a", "status": "ok"},
                {"replica": "rep-b", "status": "stale",
                 "last_seen_s": float(rng.uniform(31, 60))}
                if breach else {"replica": "rep-b", "status": "ok"}],
        })
    return views


def test_alert_engine_transitions_equal_the_reference(tmp_path):
    """The same views at the same clock through both engines: equal
    fired/resolved/active transitions at every step (exact), and every
    rule family fires and resolves on the way."""
    from processing_chain_tpu.telemetry import alerts as jalerts

    ours = alerts.AlertEngine(str(tmp_path / "port"), "rep-a",
                              window_scale=0.01)
    ref = jalerts.AlertEngine(str(tmp_path / "ref"), "rep-a",
                              window_scale=0.01)
    fired = set()
    for k, view in enumerate(_seeded_views(20)):
        now = 1_000_000.0 + 2.0 * k
        a = ours.evaluate(json.loads(json.dumps(view)), now=now)
        b = ref.evaluate(json.loads(json.dumps(view)), now=now)
        assert a == b, k
        fired.update(s["rule"] for s in a["fired"])
    ours.close()
    ref.close()
    assert {"slo_burn_queue_wait", "slo_burn_read_ttfb",
            "store_eviction_regret", "mesh_waste_high",
            "fleet_replica_stale"} <= fired
    assert ours.active() == [] and ref.active() == []


def test_alert_journals_cross_read_between_packages(tmp_path):
    """A port engine's journal folded by the reference's reader equals
    the port's own fold, and the other way round."""
    from processing_chain_tpu.telemetry import alerts as jalerts

    roots = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    engines = {"port": alerts.AlertEngine(roots["port"], "rep-a",
                                          window_scale=0.01),
               "ref": jalerts.AlertEngine(roots["ref"], "rep-a",
                                          window_scale=0.01)}
    for k, view in enumerate(_seeded_views(21)):
        for eng in engines.values():
            eng.evaluate(json.loads(json.dumps(view)),
                         now=1_000_000.0 + 2.0 * k)
    for eng in engines.values():
        eng.close()
    folds = {}
    for name, root in roots.items():
        adir = alerts.alerts_dir(root)
        ours = alerts.fold(alerts.read_journals(adir))
        ref = jalerts.fold(jalerts.read_journals(adir))
        assert ours == ref and ours, name
        report = alerts.alerts_report(root)
        ref_report = jalerts.alerts_report(root)
        report.pop("generated_at")
        ref_report.pop("generated_at")
        assert report == ref_report, name
        folds[name] = ours
    assert folds["port"] == folds["ref"]


def test_autoscale_signal_equals_the_reference(tmp_path):
    """The same seeded inputs through both advisors: equal signals at
    every step (exact), including the scale-down hold."""
    import numpy as np

    from processing_chain_tpu.serve.autoscale import (
        AutoscaleAdvisor as JAdvisor,
    )
    from processing_chain_tpu.telemetry import alerts as jalerts

    ours_j = alerts.AlertJournal(alerts.alerts_dir(str(tmp_path / "p")),
                                 "rep-a")
    ref_j = jalerts.AlertJournal(jalerts.alerts_dir(str(tmp_path / "r")),
                                 "rep-a")
    ours = AutoscaleAdvisor(ours_j, "rep-a", workers=2,
                            scale_down_hold_s=30.0, window_scale=0.1)
    ref = JAdvisor(ref_j, "rep-a", workers=2, scale_down_hold_s=30.0,
                   window_scale=0.1)
    rng = np.random.default_rng(5)
    desired = set()
    for k in range(60):
        cls = str(rng.choice(["interactive", "normal", "bulk"]))
        n = int(rng.integers(0, 40)) if k < 40 else 0
        cost_s = float(rng.uniform(0, 400)) if n else 0.0
        burn = ([{"rule": "slo_burn_queue_wait", "alert": f"k{k % 3}"}]
                if 10 <= k < 25 else [])
        kw = dict(current_replicas=int(rng.integers(1, 6)),
                  backlog={cls: {"count": n, "cost_s": cost_s}} if n else {},
                  outstanding_s=cost_s, active_alerts=burn,
                  calibrated=bool(k % 2), now=100.0 + k)
        a = ours.evaluate(**kw)
        b = ref.evaluate(**kw)
        assert a == b, k
        desired.add(a["replicas_desired"])
    ours_j.close()
    ref_j.close()
    assert len(desired) > 2
    assert alerts.latest_scale(str(tmp_path / "p")) == \
        jalerts.latest_scale(str(tmp_path / "r"))


def test_breach_soak_sees_its_alerts_with_slow_evaluations(tmp_path,
                                                          monkeypatch):
    """`tools fleet-doctor --soak` with every fleet view 0.2 s slower,
    so that the control ticks come farther apart than the soak's 0.3 s
    fast window: the eviction regret, a step between two ticks, still
    fires, with the other two expected alerts, and all resolve."""
    import types

    from processing_chain_tpu_torch.telemetry import fleet
    from processing_chain_tpu_torch.tools import fleet_doctor

    view = fleet.fleet_view

    def slow_view(*args, **kwargs):
        time.sleep(0.2)
        return view(*args, **kwargs)

    monkeypatch.setattr(fleet, "fleet_view", slow_view)
    out = tmp_path / "soak.json"
    rc = fleet_doctor.run_soak(types.SimpleNamespace(
        root=str(tmp_path / "soak"), out=str(out)))
    report = json.loads(out.read_text())
    assert rc == 0 and report["failures"] == []
    assert set(report["alerts"]["fired"]) == {
        "slo_burn_queue_wait", "store_eviction_regret",
        "fleet_replica_stale"}
    assert all(v["state"] == "resolved"
               for v in report["alerts"]["lifecycle"].values())
