"""The port's serve path against the JAX package's: the wave executor's
plans, hashes and artifact bytes, and the `tests/test_serve.py` contracts
of the durable queue, the scheduler and the HTTP service, on the CPU.

Each test names its JAX counterpart. The port's service runs its `wave`
executor with `device="cpu"` (the plain CPU route of the wave step);
the JAX executor runs as the JAX package's own tests run it, on the
suite's 8 virtual CPU devices.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from processing_chain_tpu.serve import executors as jexec
from processing_chain_tpu.serve.service import ChainServeService as JaxService
from processing_chain_tpu.store import keys as jkeys
from processing_chain_tpu.store import runtime as jstore_runtime
from processing_chain_tpu import telemetry as jtm
from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.engine.jobs import Job, JobRunner
from processing_chain_tpu_torch.serve import api
from processing_chain_tpu_torch.serve import executors as texec
from processing_chain_tpu_torch.serve.executors import SyntheticExecutor
from processing_chain_tpu_torch.serve.queue import DurableQueue, JobRecord
from processing_chain_tpu_torch.serve.scheduler import Scheduler, StridePicker
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import keys as tkeys
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.utils import lockdebug
from processing_chain_tpu_torch.utils.runner import ChainError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the wave parity geometries: an upscale (every plan of it takes the
#: `resize_ring` kernel on a card) and a downscale (`resize_stream`)
WAVE_GEOMETRIES = [
    {"frames": 12, "src_h": 36, "src_w": 64, "dst_h": 72, "dst_w": 128},
    {"frames": 12, "src_h": 72, "src_w": 128, "dst_h": 36, "dst_w": 64},
]


@pytest.fixture
def serve_factory(tmp_path):
    """Port services rooted in tmp dirs; teardown stops them and clears
    the process-global store slot and telemetry enablement."""
    created = []

    def make(subdir="serve", **kw):
        kw.setdefault("device", "cpu")
        svc = ChainServeService(root=str(tmp_path / subdir), port=0, **kw).start()
        created.append(svc)
        return svc

    yield make
    for svc in created:
        svc.stop()
    store_runtime.configure(None)
    tm.disable()


@pytest.fixture
def active_store(tmp_path):
    """The store the service would configure: jobs run against one."""
    yield store_runtime.configure(str(tmp_path / "store"))
    store_runtime.configure(None)


def _post(url: str, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def _get(url: str, headers: dict | None = None) -> tuple[int, bytes, dict]:
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), dict(exc.headers)


def _body(tenant="acme", priority="normal", srcs=("SRC100",),
          hrcs=("HRC100",), **params) -> dict:
    return {
        "tenant": tenant, "priority": priority, "database": "P2STR01",
        "srcs": list(srcs), "hrcs": list(hrcs),
        "params": {"size_bytes": 512, **params},
    }


def _wave_body(geo: dict, tenant="lab-a", srcs=("SRC001", "SRC002"),
               hrcs=("HRC001",)) -> dict:
    return {"tenant": tenant, "database": "P2STR01", "srcs": list(srcs),
            "hrcs": list(hrcs), "params": dict(geo)}


def _planned_serve_jobs() -> int:
    metric = tm.REGISTRY.snapshot().get("chain_jobs_planned_total")
    if not metric:
        return 0
    return int(sum(
        s["value"] for s in metric["series"]
        if s["labels"].get("runner") == "serve"
    ))


def _waves() -> int:
    metric = tm.REGISTRY.snapshot().get("chain_serve_waves_total")
    return int(sum(s["value"] for s in metric["series"])) if metric else 0


# ------------------------------------------------------ wave parity with JAX


def _units(geo: dict, pairs) -> list:
    return [api.Unit(database="P2STR01", src=s, hrc=h, params=dict(geo))
            for s, h in pairs]


@pytest.mark.parametrize("geo", WAVE_GEOMETRIES,
                         ids=lambda g: f"{g['src_h']}x{g['src_w']}-{g['dst_h']}x{g['dst_w']}")
def test_wave_executor_matches_jax_plans_names_and_bytes(tmp_path, geo):
    """JAX counterpart: serve/executors.DeviceWaveExecutor.run_batch (no
    JAX test drives it alone). Two units in one batch through both
    executors: equal plans, plan hashes, artifact names and bytes."""
    units = _units(geo, [("SRC001", "HRC001"), ("SRC002", "HRC002")])
    port = texec.DeviceWaveExecutor(device="cpu")
    ref = jexec.DeviceWaveExecutor()
    outs = {}
    for name, ex in (("port", port), ("jax", ref)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = [str(d / f"{u.pvs_id}.bin") for u in units]
        ex.run_batch(units, outs[name])
    for i, unit in enumerate(units):
        assert port.plan(unit) == ref.plan(unit)
        assert tkeys.canonical_json(port.plan(unit)) == \
            jkeys.canonical_json(ref.plan(unit))
        h = tkeys.plan_hash(port.plan(unit))
        assert h == jkeys.plan_hash(ref.plan(unit))
        assert port.output_name(unit, h) == ref.output_name(unit, h)
        with open(outs["port"][i], "rb") as f:
            got = f.read()
        with open(outs["jax"][i], "rb") as f:
            want = f.read()
        n, dh, dw = geo["frames"], geo["dst_h"], geo["dst_w"]
        assert len(got) == n * dh * dw * 3 // 2
        assert got == want
    # written through temp names: only the outputs are left
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.path.basename(p) for p in outs["port"])


def test_wave_executor_lanes_of_other_lengths_match_jax(tmp_path):
    """JAX counterpart: DeviceWaveExecutor.run_batch with lanes of unequal
    length in one bucket (a tail block padded by its last frame, an
    exhausted lane riding the wave): bytes equal per unit."""
    geo = dict(WAVE_GEOMETRIES[0])
    units = [api.Unit("P2STR01", "SRC001", "HRC001", {**geo, "frames": 5}),
             api.Unit("P2STR01", "SRC002", "HRC001", {**geo, "frames": 19})]
    for name, ex in (("port", texec.DeviceWaveExecutor(device="cpu")),
                     ("jax", jexec.DeviceWaveExecutor())):
        d = tmp_path / name
        d.mkdir()
        ex.run_batch(units, [str(d / f"{u.pvs_id}.bin") for u in units])
    for u in units:
        assert (tmp_path / "port" / f"{u.pvs_id}.bin").read_bytes() == \
            (tmp_path / "jax" / f"{u.pvs_id}.bin").read_bytes()


def test_wave_service_matches_jax_service(tmp_path):
    """JAX counterpart: the JAX ChainServeService with executor="wave".
    One request through both services: the same plan per unit, and the
    port's artifact fetched over HTTP equals the JAX service's."""
    geo = WAVE_GEOMETRIES[0]
    body = _wave_body(geo, srcs=("SRC001", "SRC002"), hrcs=("HRC001",))
    svc = ChainServeService(root=str(tmp_path / "port"), port=0,
                            executor="wave", workers=1, device="cpu").start()
    try:
        acc = svc.submit(body)
        assert svc.wait_request(acc["request"], timeout=60.0) == "done"
        port_units = svc.request_status(acc["request"])["units"]
        port_bytes = {pvs: _get(svc.server.url + u["artifact"])[1]
                      for pvs, u in port_units.items()}
    finally:
        svc.stop()
        store_runtime.configure(None)
        tm.disable()
    ref = JaxService(root=str(tmp_path / "jax"), port=0, executor="wave",
                     workers=1).start()
    try:
        acc = ref.submit(body)
        assert ref.wait_request(acc["request"], timeout=120.0) == "done"
        ref_units = ref.request_status(acc["request"])["units"]
        ref_bytes = {pvs: _get(ref.server.url + u["artifact"])[1]
                     for pvs, u in ref_units.items()}
    finally:
        ref.stop()
        jstore_runtime.configure(None)
        jtm.disable()
    assert {p: u["plan"] for p, u in port_units.items()} == \
        {p: u["plan"] for p, u in ref_units.items()}
    assert port_bytes == ref_bytes
    assert all(len(b) == geo["frames"] * geo["dst_h"] * geo["dst_w"] * 3 // 2
               for b in port_bytes.values())


def test_wave_executor_writes_through_and_cleans_up_on_failure(tmp_path, monkeypatch):
    """No JAX counterpart (the JAX executor collects every block before it
    writes): a failure inside run_bucket leaves no output and no temp."""
    from processing_chain_tpu_torch.parallel import p03_batch

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(p03_batch, "run_bucket", boom)
    ex = texec.DeviceWaveExecutor(device="cpu")
    units = _units(WAVE_GEOMETRIES[0], [("SRC001", "HRC001")])
    with pytest.raises(RuntimeError, match="device fault"):
        ex.run_batch(units, [str(tmp_path / "x.bin")])
    assert os.listdir(tmp_path) == []


def test_wave_executor_refuses_a_short_or_long_lane(tmp_path, monkeypatch):
    """No JAX counterpart (the JAX executor concatenates the blocks, so a
    short lane gives it a short file): the port writes each block at its
    final offset, so a lane that emits fewer (or more) frames than its
    unit's count fails the batch instead of committing a file whose
    gaps read back as zeros."""
    ex = texec.DeviceWaveExecutor(device="cpu")
    full = ex.source_planes
    units = _units(WAVE_GEOMETRIES[0], [("SRC001", "HRC001")])
    frames = ex._geometry(units[0].params)["frames"]
    for delta in (-3, 3):
        def resized(unit, d=delta):
            planes = full(unit)
            if d < 0:
                return [p[:d] for p in planes]
            return [np.concatenate([p, p[:d]]) for p in planes]

        monkeypatch.setattr(ex, "source_planes", resized)
        with pytest.raises(ChainError, match=f"{frames}"):
            ex.run_batch(units, [str(tmp_path / "x.bin")])
        assert os.listdir(tmp_path) == []


# ------------------------------------------------------------- request API


def test_validate_request_rejects_bad_documents():
    """JAX counterpart: tests/test_serve.py::
    test_validate_request_rejects_bad_documents."""
    good = _body()
    assert api.validate_request(good)["tenant"] == "acme"
    for mutate in (
        {"tenant": "bad tenant!"},
        {"tenant": ""},
        {"priority": "asap"},
        {"database": "NOTADB"},
        {"srcs": ["SRC1"]},
        {"srcs": []},
        {"hrcs": ["HRC1"]},
        {"params": "not-a-dict"},
    ):
        with pytest.raises(api.RequestError):
            api.validate_request({**good, **mutate})
    with pytest.raises(api.RequestError):
        api.validate_request("not an object")
    with pytest.raises(api.RequestError):
        api.validate_request({**good, "srcs": None})


def test_executor_param_validation_and_total_bucket_key():
    """JAX counterpart: tests/test_serve.py::
    test_executor_param_validation_and_total_bucket_key."""
    syn = SyntheticExecutor()
    syn.validate_params({"geometry": [64, 36], "work_ms": 5,
                         "size_bytes": 128})
    for bad in ({"geometry": "1080p"}, {"geometry": 5},
                {"geometry": [64, "x"]}, {"work_ms": "fast"},
                {"size_bytes": []}):
        with pytest.raises(ValueError):
            syn.validate_params(bad)
    assert syn.bucket_key({"params": {"geometry": "1080p"}}) is None
    assert syn.bucket_key({"params": {"geometry": 5}}) is None
    assert syn.bucket_key({"params": None}) is None
    assert syn.bucket_key({"params": {"geometry": [64, 36]}}) is not None

    wave = texec.DeviceWaveExecutor(device="cpu")
    wave.validate_params({"frames": 4, "src_h": 36})
    for bad in ({"src_h": "1080p"}, {"frames": 0}, {"dst_w": None}):
        with pytest.raises(ValueError):
            wave.validate_params(bad)
    assert wave.bucket_key({"params": {"src_h": "1080p"}}) is None
    assert wave.bucket_key({"params": None}) is None
    assert wave.bucket_key({"params": {}}) is not None
    assert wave.bucket_key({"params": {}}) == \
        jexec.DeviceWaveExecutor().bucket_key({"params": {}})


def test_make_executor_kinds():
    """JAX counterpart: serve/executors.make_executor. The `chain` kind
    waits for the port's file-level readers and says so."""
    assert texec.make_executor("synthetic").kind == "synthetic"
    assert texec.make_executor("wave", device="cpu").kind == "wave"
    with pytest.raises(ValueError, match=r"Queue A item 11\)"):
        texec.make_executor("chain")
    with pytest.raises(ValueError, match="unknown serve executor"):
        texec.make_executor("nope")


def test_expand_units_is_the_grid_and_caps():
    """JAX counterpart: tests/test_serve.py::
    test_expand_units_is_the_grid_and_caps."""
    norm = api.validate_request(_body(
        srcs=("SRC100", "SRC101"), hrcs=("HRC100", "HRC101", "HRC102"),
    ))
    units = api.expand_units(norm)
    assert len(units) == 6
    assert units[0].pvs_id == "P2STR01_SRC100_HRC100"
    assert len({u.pvs_id for u in units}) == 6
    big = _body(
        srcs=tuple(f"SRC{i:03d}" for i in range(100, 200)),
        hrcs=tuple(f"HRC{i:03d}" for i in range(100, 170)),
    )
    with pytest.raises(api.RequestError):
        api.validate_request(big)


def test_synthetic_artifacts_match_jax():
    """JAX counterpart: serve/executors.SyntheticExecutor: the same plan
    and the same deterministic bytes for one unit."""
    unit = api.Unit("P2STR01", "SRC100", "HRC100", {"size_bytes": 100})
    assert SyntheticExecutor().plan(unit) == jexec.SyntheticExecutor().plan(unit)
    assert tkeys.plan_hash(SyntheticExecutor().plan(unit)) == \
        jkeys.plan_hash(jexec.SyntheticExecutor().plan(unit))


# ---------------------------------------------------------- durable queue


def _enqueue(queue, plan_hash, request_id, tenant="acme", priority="normal"):
    unit = {"database": "P2STR01", "src": "SRC100", "hrc": "HRC100",
            "params": {}, "pvs_id": "P2STR01_SRC100_HRC100"}
    return queue.enqueue(
        plan_hash, {"op": "t", "k": plan_hash}, unit, tenant, priority,
        request_id, f"{plan_hash[:8]}.bin",
    )


def test_queue_dedup_attaches_overlapping_requests(tmp_path):
    """JAX counterpart: tests/test_serve.py::
    test_queue_dedup_attaches_overlapping_requests."""
    queue = DurableQueue(str(tmp_path / "q"))
    rec1, outcome1 = _enqueue(queue, "p" * 64, "req-1")
    assert outcome1 == "new"
    rec2, outcome2 = _enqueue(queue, "p" * 64, "req-2")
    assert outcome2 == "attached"
    assert rec2.job_id == rec1.job_id
    assert rec2.requests == ["req-1", "req-2"]
    _, outcome3 = _enqueue(queue, "q" * 64, "req-2")
    assert outcome3 == "new"
    assert len(queue.queued_snapshot()) == 2
    queue.close()


def test_queue_recovery_requeues_interrupted_jobs(tmp_path):
    """JAX counterpart: tests/test_serve.py::
    test_queue_recovery_requeues_interrupted_jobs."""
    root = str(tmp_path / "q")
    queue = DurableQueue(root)
    rec_a, _ = _enqueue(queue, "a" * 64, "req-1")
    rec_b, _ = _enqueue(queue, "b" * 64, "req-1")
    rec_c, _ = _enqueue(queue, "c" * 64, "req-1")
    claimed = queue.claim([rec_a.job_id])
    assert [r.job_id for r in claimed] == [rec_a.job_id]
    queue.complete(rec_c.job_id)
    assert os.path.isfile(os.path.join(root, "jobs", rec_a.job_id + ".json.inprogress"))
    queue.close()
    reloaded = DurableQueue(root)
    assert reloaded.recovery["requeued"] == 1
    rec_a2 = reloaded.record(rec_a.job_id)
    assert rec_a2.state == "queued"
    assert rec_a2.attempts == 1
    assert reloaded.record(rec_b.job_id).state == "queued"
    assert reloaded.record(rec_c.job_id).state == "done"
    assert not os.path.isfile(os.path.join(root, "jobs", rec_a.job_id + ".json.inprogress"))
    _, outcome = _enqueue(reloaded, "a" * 64, "req-9")
    assert outcome == "attached"
    rec_d, _ = _enqueue(reloaded, "d" * 64, "req-9")
    assert rec_d.job_id not in {rec_a.job_id, rec_b.job_id, rec_c.job_id}
    reloaded.close()


def test_daemon_recovery_requeues_with_attempt_bump(tmp_path):
    """JAX counterpart: tests/test_serve.py::
    test_daemon_recovery_requeues_with_attempt_bump."""
    root = str(tmp_path / "q")
    queue = DurableQueue(root)
    rec, _ = _enqueue(queue, "k" * 64, "req-1")
    claimed_epoch = queue.claim([rec.job_id])[0].epoch
    queue.close()
    del queue
    reloaded = DurableQueue(root)
    assert reloaded.recovery == {"jobs": 1, "requeued": 1, "done": 0,
                                 "failed": 0, "quarantined": 0, "peer": 0}
    recovered = reloaded.record(rec.job_id)
    assert recovered.state == "queued"
    assert recovered.epoch > claimed_epoch
    assert reloaded.queued_snapshot()[0].attempts == 1
    reloaded.close()


def test_queue_claim_disk_failure_reverts_instead_of_stranding(tmp_path, monkeypatch):
    """JAX counterpart: tests/test_serve.py::
    test_queue_claim_disk_failure_reverts_instead_of_stranding."""
    queue = DurableQueue(str(tmp_path / "q"))
    r1, _ = _enqueue(queue, "1" * 64, "req-1")
    r2, _ = _enqueue(queue, "2" * 64, "req-1")
    real_persist = queue._persist

    def failing(record):
        if record.job_id == r2.job_id and record.state == "running":
            raise OSError("disk full")
        real_persist(record)

    monkeypatch.setattr(queue, "_persist", failing)
    owned = queue.claim([r1.job_id, r2.job_id])
    assert [r.job_id for r in owned] == [r1.job_id]
    assert queue.record(r2.job_id).state == "queued"
    assert r2.job_id in {r.job_id for r in queue.queued_snapshot()}
    assert not os.path.isfile(os.path.join(
        str(tmp_path / "q"), "jobs", r2.job_id + ".json.inprogress"))
    queue.close()


# ------------------------------------------------------------- fairness


def _records(tenant, priority, n, t0=0.0):
    return [
        JobRecord(
            job_id=f"{tenant}-{priority}-{i}", plan_hash=f"{tenant}{i}",
            plan={}, unit={}, tenant=tenant, priority=priority,
            output="x", enqueued_at=t0 + i,
        )
        for i in range(n)
    ]


def _drain(picker, queued, n):
    order = []
    pool = list(queued)
    for _ in range(n):
        pick = picker.pick(pool)
        order.append(pick)
        pool.remove(pick)
    return order


def test_stride_picker_weighted_tenant_fairness():
    """JAX counterpart: tests/test_serve.py::
    test_stride_picker_weighted_tenant_fairness."""
    picker = StridePicker(tenant_weights={"heavy": 4.0, "light": 1.0})
    queued = _records("heavy", "normal", 50) + _records("light", "normal", 50)
    first = _drain(picker, queued, 50)
    assert sum(1 for r in first if r.tenant == "heavy") == 40
    assert any(r.tenant == "light" for r in first[:6])


def test_stride_picker_priority_classes():
    """JAX counterpart: tests/test_serve.py::
    test_stride_picker_priority_classes."""
    picker = StridePicker()
    queued = _records("t", "interactive", 40) + _records("t2", "bulk", 40)
    first = _drain(picker, queued, 17)
    assert sum(1 for r in first if r.priority == "interactive") == 16


def test_stride_picker_idle_flow_rejoins_at_vtime_no_burst():
    """JAX counterpart: tests/test_serve.py::
    test_stride_picker_idle_flow_rejoins_at_vtime_no_burst."""
    picker = StridePicker()
    a = _records("a", "normal", 30)
    b = _records("b", "normal", 60)
    assert picker.pick(a[:1] + b).tenant == "a"
    for _ in range(50):
        picker.pick(b)
    order = _drain(picker, a[1:] + b, 20)
    assert 8 <= sum(1 for r in order if r.tenant == "a") <= 12


def test_stride_picker_same_order_as_jax():
    """JAX counterpart: serve/scheduler.StridePicker: the same dispatch
    order over a mixed (tenant x priority) backlog."""
    from processing_chain_tpu.serve.queue import JobRecord as JRecord
    from processing_chain_tpu.serve.scheduler import StridePicker as JPicker

    def mixed(cls):
        out = []
        for t, p, n in (("a", "normal", 12), ("b", "bulk", 12),
                        ("c", "interactive", 12), ("a", "bulk", 6)):
            out += [cls(job_id=f"{t}-{p}-{i}", plan_hash=f"{t}{p}{i}", plan={},
                        unit={}, tenant=t, priority=p, output="x",
                        enqueued_at=float(i)) for i in range(n)]
        return out

    weights = {"a": 2.0}
    got = [r.job_id for r in _drain(StridePicker(weights), mixed(JobRecord), 40)]
    want = [r.job_id for r in _drain(JPicker(weights), mixed(JRecord), 40)]
    assert got == want


# -------------------------------------------------- engine satellite


def test_jobrunner_write_write_same_label_different_plans(tmp_path):
    """JAX counterpart: tests/test_serve.py::
    test_jobrunner_write_write_same_label_different_plans. The port's
    jobs always carry a plan and run against a store, so the reference's
    planless label-compare case becomes two labels with plans."""
    out = str(tmp_path / "x.bin")
    store_runtime.configure(str(tmp_path / "store"))
    try:
        runner = JobRunner(name="t")
        runner.add(Job(label="j", output_path=out, fn=lambda: None,
                       plan={"op": "a", "v": 1}))
        runner.add(Job(label="j", output_path=out, fn=lambda: None,
                       plan={"v": 1, "op": "a"}))
        assert len(runner.jobs) == 1
        with pytest.raises(ChainError, match="DIFFERENT plans"):
            runner.add(Job(label="j", output_path=out, fn=lambda: None,
                           plan={"op": "a", "v": 2}))
        runner2 = JobRunner(name="t2")
        runner2.add(Job(label="k", output_path=out, fn=lambda: None,
                        plan={"op": "k"}))
        runner2.add(Job(label="k", output_path=out, fn=lambda: None,
                        plan={"op": "k"}))
        assert len(runner2.jobs) == 1
        with pytest.raises(ChainError, match="write-write"):
            runner2.add(Job(label="other", output_path=out, fn=lambda: None,
                            plan={"op": "k"}))
    finally:
        store_runtime.configure(None)


def test_job_serves_committed_plan_from_store(tmp_path):
    """JAX counterpart: tests/test_store.py::
    test_corrupt_store_object_triggers_exactly_one_rebuild. A job whose
    plan the store holds is skipped and its output materialized; a
    same-size corruption of the object is a miss that reruns the job.
    Without an active store a job keeps the legacy skip-existing
    semantics, as in the JAX package: it runs while its output is
    missing."""
    out = str(tmp_path / "art" / "x.bin")
    os.makedirs(os.path.dirname(out))

    def write():
        with open(out, "wb") as f:
            f.write(b"artifact")

    def job():
        return Job(label="j", output_path=out, fn=write, plan={"op": "w"})

    legacy = JobRunner(name="none")
    legacy.add(job())
    assert len(legacy.jobs) == 1 and store_runtime.active() is None
    store = store_runtime.configure(str(tmp_path / "store"))
    try:
        runner = JobRunner(name="cold")
        runner.add(job())
        assert len(runner.jobs) == 1
        runner.run()
        manifest = store.lookup(store.plan_hash({"op": "w"}))
        assert manifest is not None and manifest.object["size"] == 8
        assert not os.path.exists(out + ".inprogress")
        os.unlink(out)
        warm, warm_job = JobRunner(name="warm"), job()
        warm.add(warm_job)
        assert warm.jobs == [] and warm_job.skip_reason == "store_hit"
        with open(out, "rb") as f:
            assert f.read() == b"artifact"
        obj = store.object_path(manifest.object["sha256"])
        os.unlink(out)  # drop the hardlink so the object can be altered alone
        os.chmod(obj, 0o644)
        with open(obj, "wb") as f:
            f.write(b"garbage!")
        again = JobRunner(name="again")
        again.add(job())
        assert len(again.jobs) == 1
        assert store.lookup(manifest.plan_hash) is None
    finally:
        store_runtime.configure(None)


# ------------------------------------------------------------- scheduler


def test_scheduler_packs_cross_request_units_into_waves(tmp_path, active_store):
    """JAX counterpart: tests/test_serve.py::
    test_scheduler_packs_cross_request_units_into_waves."""
    tm.enable()
    try:
        batches: list[int] = []

        class Recording(SyntheticExecutor):
            def run_batch(self, units, outputs):
                batches.append(len(units))
                super().run_batch(units, outputs)

        queue = DurableQueue(str(tmp_path / "q"))
        unit = {"database": "P2STR01", "src": "SRC100", "hrc": "HRC100",
                "params": {"geometry": [64, 36], "size_bytes": 128}}
        for i in range(5):
            queue.enqueue(
                f"{i:064d}", {"op": "t", "i": i},
                {**unit, "pvs_id": f"P2STR01_SRC10{i}_HRC100"},
                f"tenant{i % 2}", "normal", f"req-{i % 2}", f"u{i}.bin",
            )
        sched = Scheduler(queue, Recording(), str(tmp_path / "a"),
                          workers=1, wave_width=4).start()
        try:
            assert sched.wait_idle(timeout=30.0)
        finally:
            sched.stop()
        assert sum(batches) == 5
        assert max(batches) == 4
        queue.close()
    finally:
        tm.disable()
        store_runtime.configure(None)


def test_scheduler_survives_poisoned_queue_record(tmp_path, active_store):
    """JAX counterpart: tests/test_serve.py::
    test_scheduler_survives_poisoned_queue_record."""
    tm.enable()
    try:
        unit = {"database": "P2STR01", "src": "SRC100", "hrc": "HRC100",
                "params": {"geometry": "1080p", "size_bytes": 64},
                "pvs_id": "P2STR01_SRC100_HRC100"}
        queue = DurableQueue(str(tmp_path / "q"))
        queue.enqueue("0" * 64, {"op": "t", "v": 0}, unit,
                      "acme", "normal", "req-bad", "bad.bin")
        good = {**unit, "params": {"geometry": [64, 36], "size_bytes": 64},
                "pvs_id": "P2STR01_SRC101_HRC100", "src": "SRC101"}
        queue.enqueue("1" * 64, {"op": "t", "v": 1}, good,
                      "acme", "normal", "req-good", "good.bin")
        sched = Scheduler(queue, SyntheticExecutor(), str(tmp_path / "a"),
                          workers=2).start()
        try:
            assert sched.wait_idle(timeout=30.0)
        finally:
            sched.stop()
        assert queue.counts() == {"done": 2}
        queue.close()
    finally:
        tm.disable()
        store_runtime.configure(None)


def test_scheduler_retries_then_fails_permanently(tmp_path, active_store):
    """JAX counterpart: tests/test_serve.py::
    test_scheduler_retries_then_fails_permanently."""
    tm.enable()
    try:
        class Failing(SyntheticExecutor):
            calls = 0

            def run_batch(self, units, outputs):
                type(self).calls += 1
                raise RuntimeError("boom")

        failed = []
        unit = {"database": "P2STR01", "src": "SRC100", "hrc": "HRC100",
                "params": {}, "pvs_id": "P2STR01_SRC100_HRC100"}
        queue = DurableQueue(str(tmp_path / "q"))
        queue.enqueue("f" * 64, {"op": "t"}, unit, "acme", "normal",
                      "req-1", "f.bin")
        sched = Scheduler(queue, Failing(), str(tmp_path / "a"), workers=1,
                          max_attempts=2, on_failed=failed.append).start()
        try:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and not failed:
                time.sleep(0.02)
        finally:
            sched.stop()
        assert len(failed) == 1
        assert failed[0].state == "failed"
        assert failed[0].attempts == 1
        assert Failing.calls == 2
        assert "boom" in failed[0].error
        rearmed, outcome = queue.enqueue("f" * 64, {"op": "t"}, unit, "acme",
                                         "normal", "req-2", "f.bin")
        assert outcome == "new"
        assert rearmed.state == "queued"
        assert rearmed.attempts == 0
        queue.close()
    finally:
        tm.disable()
        store_runtime.configure(None)


def test_wave_failure_in_the_scheduler_fails_the_request(serve_factory, monkeypatch):
    """JAX counterpart: serve/scheduler.classify_failure over a wave
    executor error. A device fault inside run_batch (a kernel that does
    not build or launch) fails the request, and the HTTP side answers."""
    from processing_chain_tpu_torch.parallel import p03_batch

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(p03_batch, "run_bucket", boom)
    svc = serve_factory(executor="wave", workers=1, max_attempts=2)
    acc = svc.submit(_wave_body(WAVE_GEOMETRIES[0], srcs=("SRC001",)))
    assert svc.wait_request(acc["request"], timeout=60.0) == "failed"
    doc = svc.request_status(acc["request"])
    assert "kernel launch failed" in doc["error"]
    assert _get(svc.server.url + "/healthz")[0] == 200


# ------------------------------------------------------------- service


def test_service_overlapping_requests_execute_each_plan_once(serve_factory):
    """JAX counterpart: tests/test_serve.py::
    test_service_overlapping_requests_execute_each_plan_once."""
    svc = serve_factory(workers=3, wave_width=4)
    planned0 = _planned_serve_jobs()
    grids = [("SRC100", "SRC101"), ("SRC101", "SRC102"), ("SRC100", "SRC102")]
    results = [None] * len(grids)

    def client(i):
        results[i] = svc.submit(_body(
            tenant=f"t{i}", srcs=grids[i], hrcs=("HRC100", "HRC101"),
            geometry=[64, 36],
        ))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(grids))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    plans = set()
    for r in results:
        assert svc.wait_request(r["request"], timeout=60.0) == "done"
        doc = svc.request_status(r["request"])
        plans.update(u["plan"] for u in doc["units"].values())
    assert len(plans) == 6
    assert _planned_serve_jobs() - planned0 == 6


def test_service_wave_requests_share_plans_and_answer_warm(serve_factory):
    """JAX counterpart: tests/test_serve.py::
    test_service_overlapping_requests_execute_each_plan_once and
    test_service_warm_requests_answer_in_milliseconds, on the wave
    executor (the card phase's request mix at a small size): two
    overlapping requests run 5 plans once each; the warm re-POST runs no
    new wave."""
    svc = serve_factory(executor="wave", workers=1, wave_width=4)
    geo = WAVE_GEOMETRIES[0]
    planned0, waves0 = _planned_serve_jobs(), _waves()
    a = _wave_body(geo, "lab-a", ("SRC001", "SRC002"), ("HRC001", "HRC002"))
    b = _wave_body(geo, "lab-b", ("SRC002",), ("HRC002", "HRC003"))
    acc_a, acc_b = svc.submit(a), svc.submit(b)
    assert svc.wait_request(acc_a["request"], timeout=60.0) == "done"
    assert svc.wait_request(acc_b["request"], timeout=60.0) == "done"
    assert _planned_serve_jobs() - planned0 == 5
    waves = _waves()
    warm = svc.submit(a)
    assert warm["state"] == "done" and warm["outcomes"]["warm"] == 4
    assert _waves() == waves and _planned_serve_jobs() - planned0 == 5
    for req in (acc_a, acc_b):
        for pvs, u in svc.request_status(req["request"])["units"].items():
            code, data, _ = _get(svc.server.url + u["artifact"])
            assert code == 200
            assert len(data) == geo["frames"] * geo["dst_h"] * geo["dst_w"] * 3 // 2
    # the wave journal: every record's slots add up
    from processing_chain_tpu_torch.parallel import meshobs

    records = meshobs.read_journals(meshobs.mesh_dir(svc.root))
    waves_rec = [r for r in records if r.get("kind") == "wave"]
    assert len(waves_rec) >= 5 * 2  # 5 lanes of 12 frames, 8-frame blocks
    for r in waves_rec:
        assert r["valid"] + r["pad_tail"] + r["pad_exhausted"] + r["pad_mesh"] \
            == r["dispatched"]


def test_service_warm_requests_answer_in_milliseconds(serve_factory):
    """JAX counterpart: tests/test_serve.py::
    test_service_warm_requests_answer_in_milliseconds."""
    svc = serve_factory()
    body = _body(srcs=("SRC100", "SRC101"), hrcs=("HRC100",))
    first = svc.submit(body)
    assert svc.wait_request(first["request"], timeout=60.0) == "done"
    planned = _planned_serve_jobs()
    t0 = time.perf_counter()
    warm = svc.submit(body)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert warm["state"] == "done"
    assert warm["outcomes"]["warm"] == 2
    assert warm["latency_ms"] is not None and warm["latency_ms"] < 1000.0
    assert wall_ms < 1000.0
    assert _planned_serve_jobs() == planned


@pytest.mark.parametrize("warm_units", [2, 1], ids=["all_warm", "one_cold"])
def test_submit_persists_a_warm_request_once_as_done(serve_factory, monkeypatch,
                                                     warm_units):
    """An all-warm request reaches the disk once, already done, before
    submit answers; a request with a cold unit is on disk as active first
    (a peer adopts it if this replica dies), then as done."""
    svc = serve_factory()
    first = svc.submit(_body(srcs=("SRC100", "SRC101")))
    assert svc.wait_request(first["request"], timeout=60.0) == "done"
    written = []
    persist = svc._persist_request

    def record(doc):
        written.append(doc["state"])
        persist(doc)

    monkeypatch.setattr(svc, "_persist_request", record)
    srcs = ("SRC100", "SRC101") if warm_units == 2 else ("SRC100", "SRC102")
    again = svc.submit(_body(srcs=srcs))
    assert again["outcomes"]["warm"] == warm_units
    if warm_units == 2:
        assert again["state"] == "done" and written == ["done"]
    else:
        assert written[0] == "active"
        assert svc.wait_request(again["request"], timeout=60.0) == "done"
        assert written[-1] == "done"
    with open(os.path.join(svc.requests_dir, again["request"] + ".json")) as f:
        assert json.load(f)["state"] == "done"


def test_submit_reads_the_backlog_only_for_a_tenant_budget(serve_factory, monkeypatch):
    """Without a tenant budget, admission never reads the queue's backlog
    (its lock is held across the workers' fsyncs); with one, a tenant over
    budget is still refused."""
    free = serve_factory("free")

    def no_backlog(tenant=None):
        raise AssertionError("outstanding_cost read without a tenant budget")

    monkeypatch.setattr(free.queue, "outstanding_cost", no_backlog)
    assert free.submit(_body())["outcomes"]["enqueued"] == 1
    budgeted = serve_factory("budgeted", tenant_budget_s=1.0)
    monkeypatch.setattr(budgeted.queue, "outstanding_cost", lambda tenant=None: 5.0)
    with pytest.raises(Exception, match="tenant budget"):
        budgeted.submit(_body(srcs=("SRC300",)))


def test_service_http_api_end_to_end(serve_factory):
    """JAX counterpart: tests/test_serve.py::
    test_service_http_api_end_to_end."""
    svc = serve_factory()
    url = svc.server.url
    code, acc = _post(url + "/v1/requests", _body())
    assert code == 202
    assert svc.wait_request(acc["request"], timeout=60.0) == "done"
    code, payload, _ = _get(url + acc["url"])
    doc = json.loads(payload)
    assert code == 200 and doc["state"] == "done"
    (unit,) = doc["units"].values()
    assert unit["state"] == "done"
    code, data, _ = _get(url + unit["artifact"])
    assert code == 200 and len(data) == 512
    assert _get(url + unit["artifact"])[1] == data
    code, listing, _ = _get(url + "/v1/requests")
    assert code == 200
    assert any(r["request"] == acc["request"]
               for r in json.loads(listing)["requests"])
    code, status, _ = _get(url + f"/status?request={acc['request']}")
    section = json.loads(status)["serve"]
    assert section["request"]["request"] == acc["request"]
    assert section["queue"].get("done", 0) >= 1
    assert _get(url + "/metrics")[0] == 200


def test_service_http_artifact_etag_and_range(serve_factory):
    """JAX counterpart: serve/service.ChainServeService._h_artifact (ETag,
    If-None-Match, Range, If-Range)."""
    svc = serve_factory()
    url = svc.server.url
    acc = svc.submit(_body())
    assert svc.wait_request(acc["request"], timeout=60.0) == "done"
    (unit,) = svc.request_status(acc["request"])["units"].values()
    art = url + unit["artifact"]
    code, full, headers = _get(art)
    etag = headers["ETag"]
    assert code == 200 and etag == f'"{unit["plan"]}"'
    assert _get(art, {"If-None-Match": etag})[0] == 304
    code, part, headers = _get(art, {"Range": "bytes=10-19"})
    assert code == 206 and part == full[10:20]
    assert headers["Content-Range"] == f"bytes 10-19/{len(full)}"
    assert _get(art, {"Range": "bytes=-8"})[1] == full[-8:]
    assert _get(art, {"Range": "bytes=9999-"})[0] == 416
    assert _get(art, {"Range": "bytes=0-3", "If-Range": '"other"'})[1] == full


def test_service_http_rejections(serve_factory):
    """JAX counterpart: tests/test_serve.py::test_service_http_rejections
    and test_service_http_rejects_unparseable_executor_params."""
    svc = serve_factory()
    url = svc.server.url
    code, err = _post(url + "/v1/requests", {"tenant": "x y"})
    assert code == 400 and "error" in err
    req = urllib.request.Request(url + "/v1/requests", data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req)
    assert exc_info.value.code == 400
    assert _get(url + "/v1/requests/req-nope")[0] == 404
    assert _get(url + "/v1/artifacts/deadbeef")[0] == 400
    assert _get(url + "/v1/artifacts/" + "0" * 64)[0] == 404
    req = urllib.request.Request(url + "/v1/requests", method="DELETE")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req)
    assert exc_info.value.code == 405
    for bad in ({"geometry": "1080p"}, {"geometry": 5}, {"work_ms": "fast"}):
        code, err = _post(url + "/v1/requests", {**_body(), "params": bad})
        assert code == 400 and "error" in err, bad
    assert svc.queue.counts() == {}


def test_service_drain_and_resume(serve_factory):
    """JAX counterpart: serve/service.ChainServeService.drain/resume and
    POST /v1/drain: a draining replica stays healthy and claims nothing
    until it resumes."""
    svc = serve_factory()
    url = svc.server.url
    code, doc = _post(url + "/v1/drain", {})
    assert code == 200 and doc["state"] == "draining"
    assert json.loads(_get(url + "/healthz")[1])["status"] == "draining"
    acc = svc.submit(_body())
    assert svc.wait_request(acc["request"], timeout=0.5) == "active"
    code, doc = _post(url + "/v1/drain", {"resume": True})
    assert code == 200 and doc["state"] == "ok"
    assert svc.wait_request(acc["request"], timeout=60.0) == "done"


def test_recovery_rearms_failed_and_evicted_records(tmp_path):
    """JAX counterpart: tests/test_serve.py::
    test_recovery_rearms_failed_and_evicted_records."""
    root = str(tmp_path / "serve")
    svc = ChainServeService(root=root, port=0, workers=1)
    try:
        acc_f = svc.submit(_body(srcs=("SRC100",), hrcs=("HRC100",)))
        acc_e = svc.submit(_body(srcs=("SRC101",), hrcs=("HRC100",)))
        rec_f, rec_e = svc.queue.queued_snapshot()
        svc.queue.claim([rec_f.job_id, rec_e.job_id])
        svc.queue.fail(rec_f.job_id, error="crashed", requeue=False)
        svc.queue.complete(rec_e.job_id)
    finally:
        svc.stop()
        store_runtime.configure(None)
    svc2 = ChainServeService(root=root, port=0, workers=1).start()
    try:
        assert svc2.wait_request(acc_f["request"], timeout=60.0) == "done"
        assert svc2.wait_request(acc_e["request"], timeout=60.0) == "done"
        assert svc2.queue.counts() == {"done": 2}
    finally:
        svc2.stop()
        store_runtime.configure(None)
        tm.disable()


def test_service_restart_resumes_unfinished_requests(tmp_path):
    """JAX counterpart: tests/test_serve.py::
    test_service_restart_resumes_unfinished_requests, here with the wave
    executor: the recovered request's artifacts are the wave bytes."""
    root = str(tmp_path / "serve")
    geo = WAVE_GEOMETRIES[0]
    svc = ChainServeService(root=root, port=0, workers=1, executor="wave",
                            device="cpu")
    try:
        acc = svc.submit(_wave_body(geo, srcs=("SRC001", "SRC002")))
        assert acc["state"] == "active"
    finally:
        svc.stop()
        store_runtime.configure(None)
    svc2 = ChainServeService(root=root, port=0, workers=1, executor="wave",
                             device="cpu").start()
    try:
        assert svc2.wait_request(acc["request"], timeout=60.0) == "done"
        doc = svc2.request_status(acc["request"])
        assert all(u["state"] == "done" for u in doc["units"].values())
        for u in doc["units"].values():
            code, data, _ = _get(svc2.server.url + u["artifact"])
            assert code == 200 and len(data) == geo["frames"] * geo["dst_h"] * geo["dst_w"] * 3 // 2
    finally:
        svc2.stop()
        store_runtime.configure(None)
        tm.disable()


def test_cli_daemon_serves_wave_requests_on_the_cpu(tmp_path):
    """JAX counterpart: tests/test_serve.py's `_spawn_daemon` (`tools
    chain-serve` as a subprocess). The port's CLI with `--device cpu
    --executor wave` answers a request and stops on SIGTERM."""
    root = str(tmp_path / "serve")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "processing_chain_tpu_torch", "tools",
         "chain-serve", "--root", root, "--port", "0", "--executor", "wave",
         "--device", "cpu", "--workers", "1"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        info_path = os.path.join(root, "serve-info.json")
        deadline = time.monotonic() + 90.0
        info = None
        while time.monotonic() < deadline and info is None:
            assert proc.poll() is None, proc.stderr.read().decode()
            try:
                with open(info_path) as f:
                    doc = json.load(f)
                info = doc if doc.get("pid") == proc.pid else None
            except (OSError, ValueError):
                time.sleep(0.1)
        assert info is not None and info["executor"] == "wave"
        url = info["url"]
        code, acc = _post(url + "/v1/requests", _wave_body(WAVE_GEOMETRIES[1], srcs=("SRC001",)))
        assert code == 202
        deadline = time.monotonic() + 90.0
        doc = None
        while time.monotonic() < deadline:
            doc = json.loads(_get(url + acc["url"])[1])
            if doc["state"] != "active":
                break
            time.sleep(0.1)
        assert doc["state"] == "done"
        (unit,) = doc["units"].values()
        code, data, _ = _get(url + unit["artifact"])
        geo = WAVE_GEOMETRIES[1]
        assert code == 200 and len(data) == geo["frames"] * geo["dst_h"] * geo["dst_w"] * 3 // 2
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0


def test_port_lock_order_is_acyclic():
    """JAX counterpart: tests/conftest.py's end-of-suite lock-order gate
    (utils/lockdebug.check), on the port's own recorder after this
    file's services, queues and schedulers ran."""
    summary = lockdebug.check()
    if lockdebug.enabled():
        assert summary["nodes"] > 0
