"""The serve predicted-cost model (serve/cost.py): formula
monotonicity, admission control, cost-aware wave packing, the
observed-vs-predicted feedback loop, and the fleet-wide accounting
merge (docs/SERVE.md "Cost-aware scheduling & admission")."""

from __future__ import annotations

import json
import os
import urllib.request

import pytest

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.serve import cost
from processing_chain_tpu_torch.serve.executors import SyntheticExecutor
from processing_chain_tpu_torch.serve.queue import DurableQueue
from processing_chain_tpu_torch.serve.scheduler import Scheduler
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.telemetry import fleet


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


def _post(url: str, payload: dict):
    import urllib.error

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


# ------------------------------------------------------------- formula


def test_cost_monotone_in_frames_bitrate_and_complexity():
    """The predicted cost must rank units the way the hardware does:
    more frame-megapixels, more output bytes, heavier codecs and more
    complex content all cost MORE — the relative ranking is what wave
    packing and admission run on."""
    base = {"enc_fmpix": 10.0, "out_bytes": 1e6, "codec": "h264",
            "complexity": 5.0}
    c0 = cost.cost_from_features(base)
    assert c0 > 0
    assert cost.cost_from_features({**base, "enc_fmpix": 20.0}) > c0
    assert cost.cost_from_features({**base, "out_bytes": 1e8}) > c0
    assert cost.cost_from_features({**base, "complexity": 7.0}) > c0
    assert cost.cost_from_features({**base, "codec": "libx265"}) > c0
    assert cost.cost_from_features({**base, "dev_fmpix": 50.0}) > c0
    assert cost.cost_from_features({**base, "cpvs_fmpix": 50.0}) > c0
    assert cost.cost_from_features({**base, "fixed_s": 3.0}) > c0
    # work_s is declared cost verbatim (the synthetic executor's lane)
    assert cost.cost_from_features({"work_s": 2.0}) >= 2.0


def test_complexity_multiplier_neutral_and_clamped():
    assert cost.complexity_multiplier(None) == 1.0
    assert cost.complexity_multiplier(cost.COMPLEXITY_REF) == \
        pytest.approx(1.0)
    lo, hi = cost.COMPLEXITY_MULT_RANGE
    assert cost.complexity_multiplier(-1e9) == lo
    assert cost.complexity_multiplier(1e9) == hi
    assert cost.complexity_multiplier(float("nan")) == 1.0


def test_predict_unit_cost_is_total():
    """A raising or absent feature hook must degrade to the default
    cost, never propagate — prediction runs at the POST front door and
    in the scheduler's packing pass."""

    class Raises:
        def cost_features(self, record_unit):
            raise RuntimeError("boom")

    class NoHook:
        pass

    class ReturnsGarbage:
        def cost_features(self, record_unit):
            return {"work_s": "not a number"}

    unit = {"database": "P2STR01", "src": "SRC100", "hrc": "HRC100",
            "params": {}}
    assert cost.predict_unit_cost(Raises(), unit) == cost.DEFAULT_COST_S
    assert cost.predict_unit_cost(NoHook(), unit) == cost.DEFAULT_COST_S
    assert cost.predict_unit_cost(ReturnsGarbage(), unit) == \
        cost.DEFAULT_COST_S
    # the synthetic executor's declared cost flows through
    synth = cost.predict_unit_cost(
        SyntheticExecutor(),
        {**unit, "params": {"work_ms": 500, "size_bytes": 2048}},
    )
    assert synth == pytest.approx(
        0.5 + cost.BASE_S + 2048 * cost.BYTES_S)


# ----------------------------------------------------------- admission


def test_admission_rejects_over_request_budget():
    tm.enable()
    units = [("u1", 3.0), ("u2", 4.0)]
    with pytest.raises(cost.AdmissionError) as err:
        cost.check_admission("acme", units, request_budget_s=5.0,
                             tenant_budget_s=None,
                             tenant_outstanding_s=0.0)
    assert err.value.retryable is False
    doc = err.value.doc
    assert doc["reason"] == "request_budget"
    assert doc["predicted_s"] == pytest.approx(7.0)
    assert doc["budget_s"] == 5.0
    # heaviest units named, heaviest first — the forensic body
    assert doc["heaviest"][0]["pvs"] == "u2"
    assert doc["retryable"] is False


def test_admission_rejects_over_tenant_budget_retryable():
    tm.enable()
    with pytest.raises(cost.AdmissionError) as err:
        cost.check_admission("acme", [("u1", 2.0)], request_budget_s=None,
                             tenant_budget_s=10.0,
                             tenant_outstanding_s=9.0)
    assert err.value.retryable is True
    assert err.value.doc["reason"] == "tenant_budget"
    assert err.value.doc["outstanding_s"] == pytest.approx(9.0)


def test_admission_within_budget_returns_total():
    assert cost.check_admission(
        "acme", [("u1", 2.0), ("u2", 1.5)], request_budget_s=10.0,
        tenant_budget_s=100.0, tenant_outstanding_s=50.0,
    ) == pytest.approx(3.5)
    # budgets of None disable the gates entirely
    assert cost.check_admission(
        "acme", [("u1", 1e9)], None, None, 1e12,
    ) == pytest.approx(1e9)


def test_http_admission_is_a_429_with_forensics(serve_factory):
    """An over-budget POST answers 429 with the forensic body and
    leaves NO durable state — no request doc, no queue record."""
    svc = serve_factory(admission_budget_s=0.1)
    code, doc = _post(svc.server.url + "/v1/requests", {
        "tenant": "acme", "database": "P2STR01",
        "srcs": ["SRC100", "SRC101"], "hrcs": ["HRC100"],
        "params": {"work_ms": 400},
    })
    assert code == 429
    assert doc["reason"] == "request_budget"
    assert doc["retryable"] is False
    assert doc["predicted_s"] > 0.1
    assert len(doc["heaviest"]) == 2
    assert svc.queue.counts() == {}
    assert not any(
        f.endswith(".json") for f in os.listdir(svc.requests_dir)
    )
    # under budget passes: same grid, trivial work
    code, doc = _post(svc.server.url + "/v1/requests", {
        "tenant": "acme", "database": "P2STR01",
        "srcs": ["SRC100"], "hrcs": ["HRC100"], "params": {},
    })
    assert code == 202
    assert svc.wait_request(doc["request"], 30.0) == "done"


def test_tenant_budget_gates_on_outstanding_queue_cost(tmp_path):
    """The tenant gate reads the DURABLE queue's predicted backlog, so
    it sees work admitted before a restart (and, eventually, by peer
    replicas)."""
    tm.enable()
    queue = DurableQueue(str(tmp_path / "q"))
    try:
        queue.enqueue("a" * 64, {"op": "x"}, {"pvs_id": "u1"}, "acme",
                      "normal", "req-1", "u1.bin", cost_s=8.0)
        queue.enqueue("b" * 64, {"op": "y"}, {"pvs_id": "u2"}, "other",
                      "normal", "req-2", "u2.bin", cost_s=100.0)
        assert queue.outstanding_cost("acme") == pytest.approx(8.0)
        assert queue.outstanding_cost() == pytest.approx(108.0)
        with pytest.raises(cost.AdmissionError):
            cost.check_admission(
                "acme", [("u3", 3.0)], None, tenant_budget_s=10.0,
                tenant_outstanding_s=queue.outstanding_cost("acme"),
            )
    finally:
        queue.close()


# -------------------------------------------------------- wave packing


def test_cost_aware_packing_balances_predicted_seconds(tmp_path):
    """With a wave budget, the fill skips units that would overshoot
    and picks lighter same-bucket ones further down the queue — waves
    become '~budget seconds', not 'N units'."""
    tm.enable()
    unit = {"database": "P2STR01", "src": "SRC100", "hrc": "HRC100",
            "pvs_id": "u", "params": {"geometry": [64, 36]}}
    costs = [5.0, 5.0, 0.5, 0.5, 5.0, 0.5]

    def fill(root):
        queue = DurableQueue(root)
        for i, cost_s in enumerate(costs):
            queue.enqueue(f"{i:064d}", {"op": "x", "i": i},
                          {**unit, "pvs_id": f"u{i}"}, "acme", "normal",
                          f"req-{i}", f"u{i}.bin", cost_s=cost_s)
        return queue

    queue = fill(str(tmp_path / "q"))
    queue2 = fill(str(tmp_path / "q2"))
    try:
        sched = Scheduler(
            queue, SyntheticExecutor(), str(tmp_path / "art"),
            wave_width=4, wave_budget_s=6.5,
        )
        batch = [r.cost_s for r in sched._next_batch()]
        # seed (5.0) + the three 0.5s that fit; the heavy 5.0s are
        # skipped in favor of lighter same-bucket units further on
        assert batch == [5.0, 0.5, 0.5, 0.5]
        assert sum(batch) <= 6.5
        # count-based packing (no budget) takes the first four straight
        sched2 = Scheduler(
            queue2, SyntheticExecutor(), str(tmp_path / "art2"),
            wave_width=4,
        )
        batch2 = [r.cost_s for r in sched2._next_batch()]
        assert batch2 == [5.0, 5.0, 0.5, 0.5]
    finally:
        queue.close()
        queue2.close()


# ------------------------------------------------- accounting/feedback


def test_ledger_accounting_sums_match_settled_records(serve_factory):
    """Per-tenant accounting: admitted prediction equals the sum of the
    unit predictions, observed seconds appear for every real execution,
    warm re-runs count as warm units and admit ~zero new cost."""
    svc = serve_factory(workers=2)
    body = {"tenant": "acme", "database": "P2STR01",
            "srcs": ["SRC100", "SRC101"], "hrcs": ["HRC100"],
            "params": {"work_ms": 40}}
    accepted = svc.submit(body)
    assert svc.wait_request(accepted["request"], 60.0) == "done"
    doc = svc.request_status(accepted["request"])
    unit_costs = [u for u in doc["units"]]
    assert len(unit_costs) == 2
    report = svc.cost_ledger.report()
    entry = report["tenants"]["acme"]
    assert entry["predicted_s"] == pytest.approx(
        doc["predicted_cost_s"], abs=1e-3)
    assert entry["settled_units"] == 2
    assert entry["observed_s"] >= 2 * 0.04  # at least the slept work
    assert report["model_error"] is not None
    assert report["model_error"]["n"] == 2
    # warm pass: no new predicted cost, warm units counted
    accepted2 = svc.submit(body)
    assert svc.wait_request(accepted2["request"], 30.0) == "done"
    report2 = svc.cost_ledger.report()
    entry2 = report2["tenants"]["acme"]
    assert entry2["predicted_s"] == pytest.approx(entry["predicted_s"])
    assert entry2["warm_units"] == 2
    # nothing outstanding once everything settled
    assert svc.queue.outstanding_cost() == pytest.approx(0.0)
    # the /status serve section surfaces the same report
    section = svc._status_section({})
    assert section["cost"]["tenants"]["acme"]["settled_units"] == 2


def test_each_execution_settles_its_cost_once(serve_factory):
    """The scheduler's callback and the maintenance sweep can both hand
    the service one done record: its cost settles once, and a later
    execution of the same plan (a new epoch) settles again."""
    import dataclasses

    svc = serve_factory(subdir="serve-once", workers=1)
    body = {"tenant": "acme", "database": "P2STR01",
            "srcs": ["SRC100", "SRC101"], "hrcs": ["HRC100"],
            "params": {"work_ms": 10}}
    accepted = svc.submit(body)
    assert svc.wait_request(accepted["request"], 60.0) == "done"
    units = svc.request_status(accepted["request"])["units"]
    records = [svc.queue.by_plan(u["plan"]) for u in units.values()]
    assert all(r.state == "done" and r.owner == svc.replica for r in records)
    assert len(svc.cost_ledger.ratios()) == 2
    for record in records:
        svc._on_job_done(record)  # the sweep's sighting of the same records
    assert len(svc.cost_ledger.ratios()) == 2
    assert svc.cost_ledger.report()["tenants"]["acme"]["settled_units"] == 2
    svc._on_job_done(dataclasses.replace(records[0], epoch=records[0].epoch + 1))
    assert len(svc.cost_ledger.ratios()) == 3


def test_request_doc_carries_unit_and_request_cost(serve_factory):
    svc = serve_factory()
    accepted = svc.submit({
        "tenant": "acme", "database": "P2STR01",
        "srcs": ["SRC100"], "hrcs": ["HRC100"],
        "params": {"work_ms": 10},
    })
    assert svc.wait_request(accepted["request"], 30.0) == "done"
    doc = svc.request_status(accepted["request"])
    assert doc["predicted_cost_s"] > 0
    # the durable record carried the unit's prediction
    plan_hash = next(iter(doc["units"].values()))["plan"]
    record = svc.queue.by_plan(plan_hash)
    assert record is not None and record.cost_s > 0


# ------------------------------------------------------- fleet merge


def test_fleet_cost_merge_math():
    """parse_counters/merge_counters/cost_report over synthetic
    /metrics renders: per-tenant sums add across replicas, rejections
    aggregate by reason, model error comes from the merged ratio
    histogram."""
    prom_a = "\n".join([
        'chain_serve_cost_predicted_seconds_total{tenant="acme"} 10.5',
        'chain_serve_cost_observed_seconds_total{tenant="acme"} 12.0',
        'chain_serve_cost_rejected_total{reason="request_budget"} 2',
    ])
    prom_b = "\n".join([
        'chain_serve_cost_predicted_seconds_total{tenant="acme"} 4.5',
        'chain_serve_cost_predicted_seconds_total{tenant="beta"} 1.0',
        'chain_serve_cost_rejected_total{reason="request_budget"} 1',
        'chain_serve_cost_error_ratio_bucket{le="0.9"} 1',
        'chain_serve_cost_error_ratio_bucket{le="1.1"} 3',
        'chain_serve_cost_error_ratio_bucket{le="+Inf"} 4',
        'chain_serve_cost_error_ratio_sum 4.4',
        'chain_serve_cost_error_ratio_count 4',
    ])
    counters = fleet.merge_counters([
        fleet.parse_counters(prom_a, fleet.COST_COUNTERS),
        fleet.parse_counters(prom_b, fleet.COST_COUNTERS),
    ])
    hists = fleet.merge_histograms([
        fleet.parse_histograms(prom_b, [fleet.COST_ERROR_METRIC]),
    ])
    report = fleet.cost_report(counters, hists)
    assert report["tenants"]["acme"]["predicted_s"] == pytest.approx(15.0)
    assert report["tenants"]["acme"]["observed_s"] == pytest.approx(12.0)
    assert report["tenants"]["beta"]["predicted_s"] == pytest.approx(1.0)
    assert report["rejected"] == {"request_budget": 3}
    assert report["model_error"]["n"] == 4
    assert report["model_error"]["ratio_p50"] == pytest.approx(1.1)


def test_fleet_view_carries_cost_section(serve_factory):
    svc = serve_factory(workers=2)
    accepted = svc.submit({
        "tenant": "acme", "database": "P2STR01",
        "srcs": ["SRC100"], "hrcs": ["HRC100"],
        "params": {"work_ms": 30},
    })
    assert svc.wait_request(accepted["request"], 30.0) == "done"
    view = fleet.fleet_view(svc.root)
    assert "cost" in view
    acme = view["cost"]["tenants"].get("acme")
    assert acme is not None and acme["predicted_s"] > 0
    # fleet-top renders the section without blowing up
    from processing_chain_tpu_torch.tools.fleet_top import render

    frame = render(view)
    assert "cost (predicted vs observed" in frame


def test_admission_does_not_double_charge_attached_plans(serve_factory):
    """A request that would ATTACH to in-flight work (singleflight)
    creates no new execution — it must not be priced against the
    tenant budget a second time, or the overlapping-grid workload the
    serve layer exists to dedup is exactly the one that gets 429'd."""
    svc = serve_factory(tenant_budget_s=0.8, workers=1)
    svc.scheduler.stop()  # hold the unit in 'queued'
    body = {"tenant": "acme", "database": "P2STR01",
            "srcs": ["SRC100"], "hrcs": ["HRC100"],
            "params": {"work_ms": 500}}  # predicted ~0.52s
    first = svc.submit(body)
    outstanding = svc.queue.outstanding_cost("acme")
    assert outstanding > 0.5
    # same grid again: 0.52 (attach) + 0.52 (outstanding) would breach
    # the 0.8s budget — but the attach is free, so it must be admitted
    second = svc.submit(body)
    assert second["outcomes"]["attached"] == 1
    # and the ledger charged the execution once, not twice
    report = svc.cost_ledger.report()
    assert report["tenants"]["acme"]["predicted_s"] == pytest.approx(
        svc.request_status(first["request"])["predicted_cost_s"],
        abs=1e-3)
    # a genuinely NEW unit on top of the outstanding one still breaches
    with pytest.raises(cost.AdmissionError):
        svc.submit({**body, "srcs": ["SRC101"]})


def test_attach_stamps_cost_on_prefix_era_records(tmp_path):
    """A record minted without a prediction (older build, recovered
    doc) picks up the caller's cost_s when a new request attaches —
    wave packing and outstanding_cost must not treat a known-heavy
    in-flight unit as free."""
    tm.enable()
    queue = DurableQueue(str(tmp_path / "q"))
    try:
        record, outcome = queue.enqueue(
            "c" * 64, {"op": "x"}, {"pvs_id": "u1"}, "acme", "normal",
            "req-1", "u1.bin")  # no cost_s: pre-cost-model record
        assert outcome == "new" and record.cost_s == 0.0
        record, outcome = queue.enqueue(
            "c" * 64, {"op": "x"}, {"pvs_id": "u1"}, "acme", "normal",
            "req-2", "u1.bin", cost_s=5.0)
        assert outcome == "attached"
        assert record.cost_s == pytest.approx(5.0)
        assert queue.outstanding_cost("acme") == pytest.approx(5.0)
        # the stamp is durable, not just in-memory
        reread = queue.record(record.job_id)
        assert reread.cost_s == pytest.approx(5.0)
    finally:
        queue.close()


# ------------------------------------------------- per-host calibration


@pytest.fixture(autouse=True)
def _reset_calibration():
    cost.reset_calibration()
    yield
    cost.reset_calibration()


def test_fit_scale_median_clamp_and_min_samples():
    # median, robust against the warm-adjacent tail
    fitted = cost.fit_scale([0.5, 0.5, 0.5, 40.0], min_samples=4)
    assert fitted == {"scale": 0.5, "n": 4}
    # too thin a ring: refuse to fit
    assert cost.fit_scale([1.0] * 3, min_samples=4) is None
    # non-finite / non-positive samples are discarded before the gate
    assert cost.fit_scale([float("nan"), -1.0, 0.0, 2.0],
                          min_samples=2) is None
    # clamp: one pathological soak cannot 100x the admission gate
    assert cost.fit_scale([1000.0] * 8, min_samples=8)["scale"] == 10.0
    assert cost.fit_scale([1e-6] * 8, min_samples=8)["scale"] == 0.1


def test_calibration_scales_every_prediction():
    ex = SyntheticExecutor()
    unit = {"params": {"work_ms": 1000}}
    base = cost.predict_unit_cost(ex, unit)
    cost.set_calibration(2.0, n=64)
    assert cost.predict_unit_cost(ex, unit) == pytest.approx(2.0 * base)
    assert cost.calibration() == {"scale": 2.0, "n": 64}
    cost.reset_calibration()
    assert cost.predict_unit_cost(ex, unit) == pytest.approx(base)


def test_ledger_calibrate_composes_with_the_scale_in_force():
    """The ring's ratios were observed against predictions that already
    carried the current scale, so a refit composes multiplicatively —
    a perfectly calibrated host (median ratio 1) is a fixed point."""
    ledger = cost.CostLedger()
    for _ in range(40):
        ledger.observed("t", predicted_s=1.0, exec_s=2.0)
    doc = ledger.calibrate(min_samples=32)
    assert doc["scale"] == pytest.approx(2.0)
    # second round: the hardware did not change, ratios now ~1
    ledger2 = cost.CostLedger()
    for _ in range(40):
        ledger2.observed("t", predicted_s=2.0, exec_s=2.0)
    doc = ledger2.calibrate(min_samples=32)
    assert doc["scale"] == pytest.approx(2.0)  # fixed point
    # a thin ring refuses and keeps the scale put
    assert cost.CostLedger().calibrate() is None
    assert cost.calibration()["scale"] == pytest.approx(2.0)


def test_ledger_calibrate_drains_the_ring_no_compounding():
    """A successful refit consumes its ratios: they were observed
    against the PREVIOUS scale, and the periodic --cost-calibrate tick
    re-fitting the same ring would compound the same correction every
    second (2.0 -> 4.0 -> 8.0 -> clamp) until fresh samples trickled
    in. After a refit the next tick must be a no-op until min_samples
    new observations arrive."""
    ledger = cost.CostLedger()
    for _ in range(40):
        ledger.observed("t", predicted_s=1.0, exec_s=2.0)
    doc = ledger.calibrate(min_samples=32)
    assert doc["scale"] == pytest.approx(2.0)
    # the tick fires again before any new unit settles: no compounding
    assert ledger.calibrate(min_samples=32) is None
    assert cost.calibration()["scale"] == pytest.approx(2.0)
    assert ledger.ratios() == []
    # fresh post-refit observations re-arm the refit and compose
    for _ in range(40):
        ledger.observed("t", predicted_s=2.0, exec_s=3.0)
    doc = ledger.calibrate(min_samples=32)
    assert doc["scale"] == pytest.approx(3.0)


def test_service_reports_calibration_and_tick_refits(serve_factory):
    svc = serve_factory(subdir="serve-cal", cost_calibrate=True)
    for _ in range(cost.CALIBRATION_MIN_SAMPLES):
        svc.cost_ledger.observed("t", predicted_s=1.0, exec_s=3.0)
    doc = svc.cost_ledger.calibrate()
    assert doc is not None and doc["scale"] == pytest.approx(3.0)
    body = json.loads(urllib.request.urlopen(
        svc.server.url + "/status").read().decode())
    cal = body["serve"]["cost"]["calibration"]
    assert cal["enabled"] is True
    assert cal["scale"] == pytest.approx(3.0)


# ---------------------------------------- parity with the reference


def _seeded_records(seed: int, n: int, kind: str) -> list:
    """n unit records of `kind` ("synthetic" or "wave") with seeded
    params, plus a few the feature hooks cannot parse."""
    import numpy as np

    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        if kind == "synthetic":
            params = {"work_ms": int(rng.integers(0, 5000)),
                      "size_bytes": int(rng.integers(1, 1 << 26))}
        else:
            params = {"frames": int(rng.integers(1, 600)),
                      "src_h": int(rng.choice([144, 360, 720, 1080])),
                      "src_w": int(rng.choice([256, 640, 1280, 1920])),
                      "dst_h": int(rng.choice([360, 1080, 2160])),
                      "dst_w": int(rng.choice([640, 1920, 3840]))}
        records.append({"pvs_id": f"P2STR01_SRC{i:03d}_HRC100",
                        "params": params})
    records += [{"pvs_id": "bad1", "params": {"frames": "many"}},
                {"pvs_id": "bad2", "params": None},
                {"pvs_id": "bad3"}]
    return records


def _executors(kind: str):
    from processing_chain_tpu.serve import executors as jexec

    from processing_chain_tpu_torch.serve import executors as texec

    if kind == "synthetic":
        return texec.SyntheticExecutor(), jexec.SyntheticExecutor()
    return texec.DeviceWaveExecutor(device="cpu"), jexec.DeviceWaveExecutor()


@pytest.mark.parametrize("kind", ["synthetic", "wave"])
@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_predict_unit_cost_equals_the_reference(kind, scale):
    """Exact equality: the port's coefficients are the reference's, and
    each executor's cost features are the reference executor's; under a
    calibration scale in force the products are equal too."""
    from processing_chain_tpu.serve import cost as jcost

    ours_exec, ref_exec = _executors(kind)
    cost.set_calibration(scale, n=40)
    jcost.set_calibration(scale, n=40)
    try:
        for record in _seeded_records(12, 40, kind):
            assert ours_exec.cost_features(record) == \
                ref_exec.cost_features(record), record
            assert cost.predict_unit_cost(ours_exec, record) == \
                jcost.predict_unit_cost(ref_exec, record), record
    finally:
        jcost.reset_calibration()


@pytest.mark.parametrize("kind", ["synthetic", "wave"])
def test_check_admission_equals_the_reference(kind):
    """The same costed units against the same budgets: equal totals
    when admitted, and an equal 429 body (reason, predicted seconds,
    budget, heaviest units, retryable) when refused."""
    import numpy as np

    from processing_chain_tpu.serve import cost as jcost

    ours_exec, ref_exec = _executors(kind)
    rng = np.random.default_rng(7)
    records = _seeded_records(3, 24, kind)
    outcomes = set()
    for trial in range(40):
        pick = rng.choice(len(records), size=int(rng.integers(1, 10)),
                          replace=False)
        ours_units = [(records[i]["pvs_id"],
                       cost.predict_unit_cost(ours_exec, records[i]))
                      for i in pick]
        ref_units = [(records[i]["pvs_id"],
                      jcost.predict_unit_cost(ref_exec, records[i]))
                     for i in pick]
        assert ours_units == ref_units
        total = sum(c for _, c in ours_units)
        request_budget = [None, total * 0.5, total * 2.0][trial % 3]
        tenant_budget = [None, total * 1.5][trial % 2]
        outstanding = float(rng.uniform(0.0, total))
        args = ("acme", request_budget, tenant_budget, outstanding)

        def run(mod, units):
            try:
                return "ok", mod.check_admission(
                    args[0], units, *args[1:])
            except mod.AdmissionError as exc:
                return "refused", (str(exc), exc.doc, exc.retryable)

        ours = run(cost, ours_units)
        ref = run(jcost, ref_units)
        assert ours == ref, trial
        outcomes.add(ours[0] if ours[0] == "ok" else ours[1][1]["reason"])
    # the seeded trials reach every branch
    assert outcomes == {"ok", "request_budget", "tenant_budget"}
