"""Tiered artifact store: pluggable CAS backends, hot/warm/cold
placement, read fall-through with read-through promotion, GC's
demote-before-evict discipline, crash-safe placement moves (SIGKILLed
mid-move), the HTTP Range read surface, and the drain/join lifecycle
(docs/STORE.md "Tier hierarchy", docs/SERVE.md "Draining a replica").

The compatibility pin leads the file: a bare flat store root must open
as a single-tier config with byte-identical behavior — the tier layer
is strictly additive.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import signal
import time
import urllib.error
import urllib.request

import pytest

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.serve.pressure import StorePressure
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import backends as store_backends
from processing_chain_tpu_torch.store import gc as store_gc
from processing_chain_tpu_torch.store import heat as store_heat
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.store.backends import (
    BackendIntegrityError,
    DirObjectClient,
    LocalBackend,
    ObjectBackend,
    SharedBackend,
)
from processing_chain_tpu_torch.store.store import ArtifactStore
from processing_chain_tpu_torch.store.tiers import (
    TierSpecError,
    parse_budget,
    parse_tier_spec,
)
from processing_chain_tpu_torch.tools import store_admin
from tests._torch_control import gc_outcome, seeded_store_state


@pytest.fixture(autouse=True)
def clean_runtime():
    tm.reset()
    yield
    store_backends.CRASH_HOOK = None
    store_runtime.configure(None)
    tm.disable()
    tm.reset()


def write(path, text):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _spec(tmp_path, hot=None, warm=None) -> str:
    parts = []
    if hot is not None:
        parts.append(f"hot@{hot}")
    warm_part = f"shared={tmp_path / 'warm'}"
    if warm is not None:
        warm_part += f"@{warm}"
    parts.append(warm_part)
    parts.append(f"object={tmp_path / 'cold'}")
    return ",".join(parts)


def _commit_n(store, tmp_path, n, size=100):
    """n manifests with distinct single-object artifacts, LRU-stamped
    oldest-first; returns (plan hashes, object shas)."""
    hashes, shas = [], []
    for i in range(n):
        out = write(str(tmp_path / f"a{i}.txt"), f"{i}" * size)
        ph = store.plan_hash({"op": "t", "i": i})
        m = store.commit(ph, out)
        stamp = time.time() - (n - i) * 1000
        os.utime(store.manifest_path(ph), (stamp, stamp))
        hashes.append(ph)
        shas.append(m.object["sha256"])
    return hashes, shas


# ------------------------------------------------- the compatibility pin


def test_flat_root_opens_as_single_tier(tmp_path):
    """A bare store root is a one-tier config: no spec, no migration,
    no behavior change — the tier layer must be invisible."""
    store = ArtifactStore(str(tmp_path / "store"))
    assert not store.tiers.multi
    assert [t.name for t in store.tiers.tiers] == ["hot"]
    out = write(str(tmp_path / "a.txt"), "flat bytes")
    ph = store.plan_hash({"op": "t"})
    m = store.commit(ph, out)
    sha = m.object["sha256"]
    # classic layout, classic accounting
    assert os.path.isfile(store.object_path(sha))
    assert store.locate_tier(sha) == "hot"
    assert list(store.iter_objects()) == [(sha, len("flat bytes"))]
    assert "tiers" not in store.stats()
    # the serving read resolves hot with a real fd path
    hit, path, f, size = store.open_object_read(sha)
    body = f.read()
    f.close()
    assert (hit, path, body, size) == (
        "hot", store.object_path(sha), b"flat bytes", len("flat bytes"))
    # a pre-tier root reopens identically
    again = ArtifactStore(str(tmp_path / "store"))
    assert again.lookup(ph) is not None
    os.unlink(out)
    assert again.serve_hit(again.lookup(ph), out) is True


# ------------------------------------------------------ backend protocol


def test_backend_protocol_roundtrip(tmp_path):
    data = b"backend bytes " * 64
    sha = _sha(data)
    backends = (
        LocalBackend(str(tmp_path / "l" / "objects"),
                     str(tmp_path / "l" / "tmp")),
        SharedBackend(str(tmp_path / "s")),
        ObjectBackend(DirObjectClient(str(tmp_path / "o"))),
    )
    for backend in backends:
        assert backend.head(sha) is None
        assert backend.put_stream(io.BytesIO(data), sha) == len(data)
        assert backend.head(sha) == len(data)
        with backend.open_read(sha) as f:
            assert f.read() == data
        assert (sha, len(data)) in list(backend.list())
        # a wrong-keyed stream must abort before becoming visible
        bogus = _sha(b"the real content")
        with pytest.raises(BackendIntegrityError):
            backend.put_stream(io.BytesIO(b"not the real content"), bogus)
        assert backend.head(bogus) is None
        for tmp_dir in backend.tmp_dirs():
            assert os.listdir(tmp_dir) == []  # no torn scratch left
        assert backend.delete(sha) is True
        assert backend.head(sha) is None
        assert backend.delete(sha) is False
    # fd-pinnable tiers have paths; the cold tier never does
    assert backends[0].local_path(sha) is not None
    assert backends[2].local_path(sha) is None


def test_parse_tier_spec_grammar(tmp_path):
    assert parse_budget("64M") == 64 << 20
    assert parse_budget("1.5k") == 1536
    assert parse_budget("2G") == 2 << 30
    with pytest.raises(TierSpecError):
        parse_budget("lots")
    # warm sorts before cold regardless of spec order; names by kind
    hot_budget, tiers = parse_tier_spec(
        f"object={tmp_path / 'c'};hot@1M;shared={tmp_path / 'w'}@2G;"
        f"local={tmp_path / 'w2'}")
    assert hot_budget == 1 << 20
    assert [t.name for t in tiers] == ["warm", "warm2", "cold"]
    assert tiers[0].budget_bytes == 2 << 30
    assert tiers[2].backend.kind == "object"
    with pytest.raises(TierSpecError):
        parse_tier_spec("banana")
    with pytest.raises(TierSpecError):
        parse_tier_spec("local=")
    with pytest.raises(TierSpecError):
        parse_tier_spec(f"local={tmp_path / 'x'}@zz")


# ------------------------------------------- fall-through and promotion


def test_reads_fall_through_and_promote(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"),
                          tier_spec=_spec(tmp_path))
    out = write(str(tmp_path / "a.txt"), "x" * 500)
    ph = store.plan_hash({"op": "t"})
    sha = store.commit(ph, out).object["sha256"]
    store.tiers.demote(sha, store.tiers.hot, store.tiers.tier("warm"))
    store.tiers.demote(sha, store.tiers.tier("warm"),
                       store.tiers.tier("cold"))
    assert store.locate_tier(sha) == "cold"
    assert not os.path.isfile(store.object_path(sha))

    hit, path, f, size = store.open_object_read(sha)
    body = f.read()
    f.close()
    assert hit == "cold" and body == b"x" * 500 and size == 500
    # read-through promotion: the NEXT read is a hot fd
    assert store.locate_tier(sha) == "hot"
    hit2, path2, f2, _ = store.open_object_read(sha)
    f2.close()
    assert hit2 == "hot" and path2 == store.object_path(sha)
    assert store.tiers.promote(sha) is None  # already hot: a no-op

    # with promotion disabled the bytes stay where they are
    store.tiers.demote(sha, store.tiers.hot, store.tiers.tier("warm"))
    store.tiers.promote_on_read = False
    hit3, _, f3, _ = store.open_object_read(sha)
    assert f3.read() == b"x" * 500
    f3.close()
    assert hit3 == "warm" and store.locate_tier(sha) == "warm"


def test_corrupt_cold_copy_is_refused_at_the_boundary(tmp_path):
    """Integrity verification lives at the tier boundary the bytes
    cross: a corrupted cold copy must never materialize hot, and the
    serve path converts it to the rebuild signal."""
    store = ArtifactStore(str(tmp_path / "store"),
                          tier_spec=_spec(tmp_path))
    out = write(str(tmp_path / "a.txt"), "good cold bytes")
    ph = store.plan_hash({"op": "t"})
    m = store.commit(ph, out)
    sha = m.object["sha256"]
    store.tiers.demote(sha, store.tiers.hot, store.tiers.tier("warm"))
    store.tiers.demote(sha, store.tiers.tier("warm"),
                       store.tiers.tier("cold"))
    cold_copy = tmp_path / "cold" / sha  # DirObjectClient flat key
    with open(cold_copy, "r+") as f:
        f.write("BAD")  # same-size flip: only the digest can catch it

    with pytest.raises(BackendIntegrityError):
        store.tiers.promote(sha)
    assert not os.path.isfile(store.object_path(sha))  # nothing torn hot

    os.unlink(out)
    assert store.serve_hit(m, out) is False  # corruption -> rebuild
    assert store.lookup(ph) is None
    assert store.tiers.locate(sha) is None  # bad bytes dropped everywhere
    assert not os.path.exists(out)


# --------------------------------------------------- GC: demote > evict


def test_gc_demotes_before_evicting(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"),
                          tier_spec=_spec(tmp_path, hot=300))
    hashes, shas = _commit_n(store, tmp_path, 5, size=150)

    report = store_gc.collect(store)
    assert len(report["demotions"]) == 3  # 750 -> 300 at 150 B each
    assert report["demoted_bytes"] == 450
    assert not report["evicted_manifests"] and not report["victims"]
    assert store.tiers.hot.bytes_held() <= 300
    for ev in report["demotions"]:
        assert ev["op"] == "demote"
        assert (ev["from_tier"], ev["to_tier"]) == ("hot", "warm")
        assert "reads" in ev and "last_used_age_s" in ev
    # coldest (oldest LRU stamp) demoted first, hottest stays hot
    assert store.locate_tier(shas[0]) == "warm"
    assert store.locate_tier(shas[-1]) == "hot"

    # dry-run synthesizes the same evidence without moving bytes
    dry = store_gc.collect(store, dry_run=True, size_budget_bytes=200)
    assert store.locate_tier(shas[0]) == "warm"
    assert all(store.lookup(h) is not None for h in hashes)
    assert dry["evicted_manifests"]  # it would evict...
    assert all(store.lookup(h) is not None for h in hashes)  # ...didn't


def test_gc_eviction_names_the_tier_the_bytes_left(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"),
                          tier_spec=_spec(tmp_path, hot=300))
    hashes, shas = _commit_n(store, tmp_path, 5, size=150)
    store_gc.collect(store)  # demote the 3 coldest to warm

    report = store_gc.collect(store, size_budget_bytes=200)
    evicted = report["evicted_manifests"]
    assert evicted == hashes[:4]  # oldest-first LRU until 750 -> 150
    tiers_left = [v["tier"] for v in report["victims"]
                  if v.get("reason") == "over_budget"]
    assert tiers_left == ["warm", "warm", "warm", "hot"]
    for sha in shas[:4]:
        assert store.tiers.locate(sha) is None  # gone from EVERY tier
    assert store.locate_tier(shas[4]) == "hot"


def test_pressure_demotes_with_no_total_budget(tmp_path):
    """Per-tier overflow alone must trigger the serve pressure pass —
    demotion pressure exists even when no total budget is set."""
    store = ArtifactStore(str(tmp_path / "store"),
                          tier_spec=_spec(tmp_path, hot=300))
    _commit_n(store, tmp_path, 5, size=150)
    pressure = StorePressure(store, None, lambda: set())
    summary = pressure.maybe_collect(force=True)
    assert summary is not None
    assert summary["demotions"] and not summary["evicted_manifests"]
    assert store.tiers.hot.bytes_held() <= 300


# ------------------------------------------------- crash-safe placement


def _crash_child(store_root, spec, hook_name, move):
    """Fork a child that installs a SIGKILL crash hook at `hook_name`
    and runs `move(store, ledger)`; returns after proving the child died
    by SIGKILL (i.e. the hook actually fired)."""
    pid = os.fork()
    if pid == 0:  # pragma: no cover - dies by SIGKILL
        try:
            def hook(name):
                if name == hook_name:
                    os.kill(os.getpid(), signal.SIGKILL)

            store_backends.CRASH_HOOK = hook
            child = ArtifactStore(store_root, tier_spec=spec)
            ledger = store_heat.HeatLedger(store_root, replica="crash")
            move(child, ledger)
        finally:
            os._exit(1)  # reached only if the hook never fired
    _, status = os.waitpid(pid, 0)
    assert os.WIFSIGNALED(status) and os.WTERMSIG(status) == signal.SIGKILL


def test_sigkill_mid_promotion_tears_nothing(tmp_path):
    """SIGKILL at the promotion's pre-commit boundary (destination tmp
    durable, rename pending): no torn hot object, the cold source
    survives, the crashed move is never heat-counted, and the retry
    completes counting exactly once."""
    spec = _spec(tmp_path)
    root = str(tmp_path / "store")
    store = ArtifactStore(root, tier_spec=spec)
    out = write(str(tmp_path / "a.txt"), "promotable bytes")
    ph = store.plan_hash({"op": "t"})
    sha = store.commit(ph, out).object["sha256"]
    store.tiers.demote(sha, store.tiers.hot, store.tiers.tier("warm"))
    store.tiers.demote(sha, store.tiers.tier("warm"),
                       store.tiers.tier("cold"))

    _crash_child(root, spec, "pre_commit",
                 lambda s, ledger: s.tiers.promote(
                     sha, plan=ph, heat=ledger))

    assert not os.path.isfile(store.object_path(sha))  # no torn object
    assert store.locate_tier(sha) == "cold"  # the only copy survives
    store.verify_object(store.lookup(ph).object)
    totals = store_heat.aggregate(store_heat.heat_dir(root))["totals"]
    assert totals["promotions"] == 0  # crashed move never counted
    # the stranded scratch is ordinary GC food
    swept = store_gc.collect(store, tmp_max_age_s=0.0)
    assert swept["tmp_removed"] >= 1

    # the retry completes and counts exactly once
    ledger = store_heat.HeatLedger(root, replica="retry")
    assert store.tiers.promote(sha, plan=ph, heat=ledger) is not None
    ledger.close()
    assert store.locate_tier(sha) == "hot"
    totals = store_heat.aggregate(store_heat.heat_dir(root))["totals"]
    assert totals["promotions"] == 1
    assert store_admin.main(
        ["verify", "--store", root, "--tiers", spec]) == 0


def test_sigkill_mid_demotion_keeps_the_source(tmp_path):
    """SIGKILL at the demotion's pre-delete boundary (destination commit
    durable, source not yet deleted): a harmless both-tiers duplicate
    that dedupes to the hotter copy, zero heat count, and a retry that
    finishes the move counting exactly once."""
    spec = _spec(tmp_path)
    root = str(tmp_path / "store")
    store = ArtifactStore(root, tier_spec=spec)
    out = write(str(tmp_path / "a.txt"), "demotable bytes")
    ph = store.plan_hash({"op": "t"})
    m = store.commit(ph, out)
    sha = m.object["sha256"]

    _crash_child(root, spec, "pre_delete",
                 lambda s, ledger: s.tiers.demote(
                     sha, s.tiers.hot, s.tiers.tier("warm"),
                     plan=ph, heat=ledger))

    # both tiers hold the bytes; accounting dedupes to the hotter copy
    assert store.tiers.hot.backend.head(sha) is not None
    assert store.tiers.tier("warm").backend.head(sha) is not None
    assert list(store.iter_objects()) == [(sha, m.object["size"])]
    assert store.locate_tier(sha) == "hot"
    store.verify_object(m.object)
    totals = store_heat.aggregate(store_heat.heat_dir(root))["totals"]
    assert totals["demotions"] == 0  # crashed move never counted

    # the retry skips the copy (already committed) and deletes the source
    ledger = store_heat.HeatLedger(root, replica="retry")
    ev = store.tiers.demote(sha, store.tiers.hot,
                            store.tiers.tier("warm"), plan=ph,
                            heat=ledger)
    ledger.close()
    assert ev["bytes"] == m.object["size"]
    assert store.tiers.hot.backend.head(sha) is None
    assert store.locate_tier(sha) == "warm"
    totals = store_heat.aggregate(store_heat.heat_dir(root))["totals"]
    assert totals["demotions"] == 1
    assert store_admin.main(
        ["verify", "--store", root, "--tiers", spec]) == 0


# ---------------------------------------------------- tier admin surface


def test_store_admin_tier_commands(tmp_path, capsys):
    spec = _spec(tmp_path)
    root = str(tmp_path / "store")
    store = ArtifactStore(root, tier_spec=spec)
    out = write(str(tmp_path / "a.txt"), "admin bytes")
    ph = store.plan_hash({"op": "t"})
    sha = store.commit(ph, out).object["sha256"]

    assert store_admin.main(
        ["tier", "ls", "--store", root, "--tiers", spec]) == 0
    rendered = capsys.readouterr().out
    for name in ("hot", "warm", "cold"):
        assert name in rendered

    assert store_admin.main(
        ["tier", "demote", ph, "--store", root, "--tiers", spec]) == 0
    assert store.locate_tier(sha) == "warm"
    # a bare object sha is accepted too
    assert store_admin.main(
        ["tier", "promote", sha, "--store", root, "--tiers", spec]) == 0
    assert store.locate_tier(sha) == "hot"
    # admin moves are journaled like any other placement move
    totals = store_heat.aggregate(store_heat.heat_dir(root))["totals"]
    assert totals == {**totals, "promotions": 1, "demotions": 1}


# --------------------------------------------------- heat: tier ledger


def test_heat_ledger_aggregates_tiers_and_moves(tmp_path):
    root = str(tmp_path / "store")
    plan = "p" * 64
    ledger = store_heat.HeatLedger(root, replica="r0")
    ledger.record_read(plan, 100, mode="full", tier="hot")
    ledger.record_read(plan, 10, mode="range", tier="warm")
    ledger.record_move({"object": "x" * 64, "op": "promote",
                        "from_tier": "warm", "to_tier": "hot",
                        "bytes": 100, "plan": plan})
    ledger.record_move({"object": "x" * 64, "op": "demote",
                        "from_tier": "hot", "to_tier": "warm",
                        "bytes": 100, "plan": plan})
    ledger.close()
    agg = store_heat.aggregate(store_heat.heat_dir(root))
    assert agg["totals"]["reads"] == 2
    assert agg["totals"]["range"] == 1
    assert agg["totals"]["promotions"] == 1
    assert agg["totals"]["demotions"] == 1
    assert agg["by_tier"]["hot"] == {"reads": 1, "bytes": 100}
    assert agg["by_tier"]["warm"] == {"reads": 1, "bytes": 10}
    assert agg["per_plan"][plan]["tiers"] == {"hot": 1, "warm": 1}
    assert agg["per_plan"][plan]["range"] == 1


# ----------------------------------------- serve: Range reads and drain


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


def _body(tenant="acme", priority="normal", srcs=("SRC100",),
          hrcs=("HRC100",), **params) -> dict:
    return {
        "tenant": tenant, "priority": priority, "database": "P2STR01",
        "srcs": list(srcs), "hrcs": list(hrcs),
        "params": {"size_bytes": 4096, **params},
    }


def _get_h(url, headers=None):
    req = urllib.request.Request(url)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        body = exc.read()
        return exc.code, body, dict(exc.headers)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.load(resp)


def _one_plan(svc, **params) -> str:
    acc = svc.submit(_body(**params))
    assert svc.wait_request(acc["request"], timeout=60.0) == "done"
    doc = svc.request_status(acc["request"])
    return next(iter(doc["units"].values()))["plan"]


def test_artifact_range_reads(serve_factory):
    svc = serve_factory(workers=1)
    plan = _one_plan(svc)
    url = f"{svc.server.url}/v1/artifacts/{plan}?tenant=acme"

    status, full, headers = _get_h(url)
    assert status == 200 and headers.get("Accept-Ranges") == "bytes"
    size, etag = len(full), headers["ETag"]

    # RFC 9110 single ranges: explicit, open-ended, suffix
    status, body, headers = _get_h(url, {"Range": "bytes=0-99"})
    assert (status, body) == (206, full[:100])
    assert headers["Content-Range"] == f"bytes 0-99/{size}"
    assert int(headers["Content-Length"]) == 100
    status, body, headers = _get_h(url, {"Range": f"bytes={size - 96}-"})
    assert (status, body) == (206, full[-96:])
    status, body, headers = _get_h(url, {"Range": "bytes=-100"})
    assert (status, body) == (206, full[-100:])
    assert headers["Content-Range"] == \
        f"bytes {size - 100}-{size - 1}/{size}"
    # an end past EOF clamps, per the spec
    status, body, _ = _get_h(url, {"Range": f"bytes=10-{size * 2}"})
    assert (status, body) == (206, full[10:])

    # unsatisfiable -> 416 with the size the client should retry against
    status, _, headers = _get_h(url, {"Range": f"bytes={size}-"})
    assert status == 416
    assert headers["Content-Range"] == f"bytes */{size}"

    # multi-range, other units, malformed: ignored -> full 200
    for bad in ("bytes=0-1,3-4", "chunks=0-1", "bytes=abc", "bytes=9-2"):
        status, body, _ = _get_h(url, {"Range": bad})
        assert (status, body) == (200, full), bad

    # If-Range: strong match honors the range, anything else full-bodies
    status, body, _ = _get_h(url, {"Range": "bytes=0-9",
                                   "If-Range": etag})
    assert (status, body) == (206, full[:10])
    status, body, _ = _get_h(url, {"Range": "bytes=0-9",
                                   "If-Range": '"stale-etag"'})
    assert (status, body) == (200, full)

    # If-None-Match still wins over Range: 304, no body
    status, body, _ = _get_h(url, {"Range": "bytes=0-9",
                                   "If-None-Match": etag})
    assert (status, body) == (304, b"")

    # ranged reads are their own heat-journal mode, tier attributed
    records = [r for r in store_heat.read_journals(
        store_heat.heat_dir(svc.store.root))
        if r.get("kind") == "read" and r.get("mode") == "range"]
    assert len(records) == 5  # 0-99, open-ended, suffix, clamped, If-Range
    assert all(r.get("tier") == "hot" for r in records)
    assert sum(r["bytes"] for r in records) == 100 + 96 + 100 + (
        size - 10) + 10


def test_drain_and_resume_over_the_wire(serve_factory):
    svc = serve_factory(workers=1)
    _one_plan(svc)  # the service is demonstrably serving

    status, doc = _post(svc.server.url + "/v1/drain", {})
    assert (status, doc["state"]) == (200, "draining")
    status, body, _ = _get_h(svc.server.url + "/healthz")
    assert status == 200  # draining is healthy, just not claiming
    assert json.loads(body)["status"] == "draining"
    with open(svc.info_path) as f:
        assert json.load(f)["state"] == "draining"

    # new work is accepted but NOT claimed while draining
    acc = svc.submit(_body(srcs=("SRC101",)))
    time.sleep(0.5)
    assert svc.request_status(acc["request"])["state"] == "active"
    assert svc.queue.counts().get("queued", 0) >= 1

    status, doc = _post(svc.server.url + "/v1/drain", {"resume": True})
    assert (status, doc["state"]) == (200, "ok")
    status, body, _ = _get_h(svc.server.url + "/healthz")
    assert json.loads(body)["status"] == "ok"
    assert svc.wait_request(acc["request"], timeout=60.0) == "done"
    with open(svc.info_path) as f:
        assert json.load(f)["state"] == "ok"


def test_service_serves_through_tiers_end_to_end(serve_factory, tmp_path):
    """The integration lane the CI smoke job scripts: a tiered service
    demotes under pressure, serves the demoted artifact (promoting it
    back), and journals the read with its hit tier."""
    spec = _spec(tmp_path, hot=2048)
    svc = serve_factory(store_tiers=spec, workers=1)
    plan = _one_plan(svc, size_bytes=4096)
    sha = svc.store.lookup(plan).object["sha256"]

    # the completion hook applies demotion pressure on its own; the
    # forced pass is reentry-suppressed while that walk is in flight,
    # so poll until the 4096-byte object left the 2048-byte hot tier
    deadline = time.time() + 10.0
    while svc.store.locate_tier(sha) == "hot" and time.time() < deadline:
        svc.pressure.maybe_collect(force=True)
        time.sleep(0.05)
    assert svc.store.locate_tier(sha) == "warm"
    assert svc.store.lookup(plan) is not None  # demoted, never evicted

    url = f"{svc.server.url}/v1/artifacts/{plan}?tenant=acme"
    status, body, _ = _get_h(url)
    assert status == 200 and len(body) == 4096
    assert svc.store.locate_tier(sha) == "hot"  # promoted read-through
    # the read lands in the journal from the post-stream completion
    # callback, which the client's last byte can race — poll briefly
    reads = []
    deadline = time.time() + 5.0
    while not reads and time.time() < deadline:
        reads = [r for r in store_heat.read_journals(
            store_heat.heat_dir(svc.store.root))
            if r.get("kind") == "read" and r.get("plan") == plan]
        if not reads:
            time.sleep(0.05)
    assert reads and reads[-1]["tier"] == "warm"


# ---------------------------------------- parity with the reference


@pytest.mark.parametrize("budget", [None, 900])
def test_tiered_gc_places_and_evicts_as_the_reference(tmp_path, budget):
    """The same tier spec and seeded store state in both packages: one
    GC pass demotes the same objects hot -> warm (before evicting), and
    with a total budget evicts the same manifests; every surviving
    object sits in the same tier. Then a read-through of a demoted
    object promotes it back in both (exact equality throughout)."""
    from processing_chain_tpu.store import gc as jgc
    from processing_chain_tpu.store.store import ArtifactStore as JStore

    stores = {}
    for name, cls in (("port", ArtifactStore), ("ref", JStore)):
        base = tmp_path / name
        base.mkdir()
        stores[name] = cls(str(base / "store"),
                           tier_spec=_spec(base, hot=500, warm=1200))
        seeded_store_state(stores[name], str(tmp_path / "src"), 42)
    hashes = [stores["port"].plan_hash({"op": "t", "i": i})
              for i in range(10)]
    a = store_gc.collect(stores["port"], size_budget_bytes=budget,
                         min_object_age_s=3600)
    b = jgc.collect(stores["ref"], size_budget_bytes=budget,
                    min_object_age_s=3600)
    ours = gc_outcome(a, stores["port"], hashes)
    assert ours == gc_outcome(b, stores["ref"], hashes)
    assert ours["demotions"]
    cold_plans = [h for h, tier in ours["tiers"].items() if tier != "hot"]
    assert cold_plans
    demoted = stores["port"].lookup(cold_plans[0]).object["sha256"]
    for store in stores.values():
        hit, _, f, _ = store.open_object_read(demoted)
        f.close()
        assert hit != "hot" and store.locate_tier(demoted) == "hot"
