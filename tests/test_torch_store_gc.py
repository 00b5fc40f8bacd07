"""The port's artifact-store GC, pins and `tools store-admin` (the
contracts of tests/test_store.py's GC and store-admin tests and of
tests/test_serve.py's store-pressure tests), then parity: `gc.collect`
and `StorePressure` on one store state evict the same manifests and
digests in both packages."""

from __future__ import annotations

import json
import os
import time

import pytest

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.engine.jobs import Job, JobRunner
from processing_chain_tpu_torch.serve.pressure import StorePressure
from processing_chain_tpu_torch.store import gc as store_gc
from processing_chain_tpu_torch.store import keys
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.store.store import (
    ArtifactStore,
    StoreCorruption,
)
from processing_chain_tpu_torch.tools import store_admin
from tests._torch_control import gc_outcome, seeded_store_state


@pytest.fixture(autouse=True)
def clean_store_runtime():
    """No test leaks an active store or telemetry state into the rest of
    the suite (the process-wide defaults are: no store, telemetry off)."""
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


def test_verify_object_catches_truncation(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    out = write(str(tmp_path / "a.txt"), "0123456789")
    m = store.commit(store.plan_hash({"op": "t"}), out)
    obj = store.object_path(m.object["sha256"])
    with open(obj, "r+") as f:
        f.truncate(4)
    with pytest.raises(StoreCorruption, match="size"):
        store.verify_object(m.object)


# -------------------------------------------------------------------- gc


def _commit_n(store, tmp_path, n, size=100):
    """n manifests with distinct single-object artifacts of `size` bytes,
    LRU-stamped oldest-first; returns their plan hashes."""
    hashes = []
    for i in range(n):
        out = write(str(tmp_path / f"a{i}.txt"), f"{i}" * size)
        ph = store.plan_hash({"op": "t", "i": i})
        store.commit(ph, out)
        stamp = time.time() - (n - i) * 1000
        os.utime(store.manifest_path(ph), (stamp, stamp))
        hashes.append(ph)
    return hashes


def test_gc_sweeps_orphans_but_not_young_objects(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    (h,) = _commit_n(store, tmp_path, 1)
    old_orphan = write(store.object_path("ab" + "0" * 62), "orphan")
    os.makedirs(os.path.dirname(old_orphan), exist_ok=True)
    os.utime(old_orphan, (time.time() - 7200,) * 2)
    young_orphan = write(store.object_path("cd" + "1" * 62), "young")

    report = store_gc.collect(store, min_object_age_s=3600)
    assert report["orphans_removed"] == 1
    assert not os.path.exists(old_orphan)
    assert os.path.exists(young_orphan)  # racing an in-flight commit: kept
    assert store.lookup(h) is not None  # referenced object untouched


def test_gc_lru_budget_respects_pins_and_shared_objects(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    hashes = _commit_n(store, tmp_path, 4, size=100)
    # a second manifest sharing artifact 3's bytes: eviction of one must
    # not free the object while the other survives
    shared_out = write(str(tmp_path / "shared.txt"), "3" * 100)
    shared_ph = store.plan_hash({"op": "t", "shared": True})
    store.commit(shared_ph, shared_out)
    store.pin(hashes[0], "golden")  # the LRU-oldest is pinned

    report = store_gc.collect(store, size_budget_bytes=250,
                              min_object_age_s=0.0)
    # oldest unpinned first: h1 then h2 evicted; pinned h0 + h3 + shared
    # (2 distinct objects + h0's = 3 * 100 > 250? no: h3 and shared share
    # one object, so kept bytes = h0 + shared object = 200 <= 250)
    assert report["evicted_manifests"] == [hashes[1], hashes[2]]
    assert store.lookup(hashes[0]) is not None  # pinned survives LRU
    assert store.lookup(hashes[1]) is None
    assert store.lookup(hashes[2]) is None
    assert store.lookup(hashes[3]) is not None
    assert report["kept_bytes"] == 200
    # the shared object survived both evictions
    assert os.path.isfile(store.object_path(store.lookup(shared_ph).object["sha256"]))


def test_gc_budget_unreachable_when_all_pinned(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    hashes = _commit_n(store, tmp_path, 2, size=100)
    for h in hashes:
        store.pin(h)
    report = store_gc.collect(store, size_budget_bytes=50)
    assert report["evicted_manifests"] == []
    assert all(store.lookup(h) is not None for h in hashes)


def test_gc_dry_run_touches_nothing(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    hashes = _commit_n(store, tmp_path, 3, size=100)
    report = store_gc.collect(store, size_budget_bytes=100, dry_run=True,
                              min_object_age_s=0.0)
    assert len(report["evicted_manifests"]) == 2
    assert all(store.lookup(h) is not None for h in hashes)


def _text_job(out_dir, name, param, executed, inputs=()):
    """A Job whose artifact content depends on `param` and whose plan
    references `inputs` — the same shape the stages build, minus media."""
    out = os.path.join(out_dir, name + ".txt")

    def fn():
        executed.append(name)
        digest_in = "".join(open(p).read() for p in inputs)
        write(out, f"{name}:{param}:{keys.sha256_hex(digest_in.encode())[:8]}")
        return out

    return Job(
        label=name,
        output_path=out,
        fn=fn,
        plan={"op": name, "param": param,
              "inputs": [keys.file_ref(p) for p in inputs]},
    )


def test_gc_eviction_never_enables_stale_adoption(tmp_path):
    """GC eviction removes a manifest but leaves the materialized output
    on disk. A later run with a CHANGED plan must rebuild it — the
    durable seen-paths ledger, not just live manifests, backs the
    adopt-vs-rebuild decision; re-adopting those bytes would serve an
    artifact built under the old parameters as if it matched the new."""
    store = store_runtime.configure(str(tmp_path / "store"))
    out_dir = str(tmp_path / "db")
    os.makedirs(out_dir)
    executed = []
    r = JobRunner(parallelism=1, name="mini")
    r.add(_text_job(out_dir, "a1", 1, executed))
    r.run()
    assert executed == ["a1"]

    # evict everything (budget 0); the output file stays on disk
    store_gc.collect(store, size_budget_bytes=0, min_object_age_s=0.0)
    assert list(store.iter_manifests()) == []
    assert os.path.isfile(os.path.join(out_dir, "a1.txt"))

    # fresh store object (cold process), changed plan: MUST rebuild
    store_runtime.configure(str(tmp_path / "store"))
    executed = []
    r = JobRunner(parallelism=1, name="mini")
    r.add(_text_job(out_dir, "a1", 2, executed))
    r.run()
    assert executed == ["a1"]


def test_store_admin_ls_verify_gc_pin(tmp_path, capsys):
    root = str(tmp_path / "store")
    store = ArtifactStore(root)
    hashes = _commit_n(store, tmp_path, 3, size=50)

    assert store_admin.main(["--store", root, "ls"]) == 0
    out = capsys.readouterr().out
    assert "3 manifest(s)" in out

    # pin through the CLI, then corrupt one object
    assert store_admin.main(["--store", root, "pin", hashes[0],
                             "--label", "golden"]) == 0
    assert hashes[0] in store.pins()
    victim = store.lookup(hashes[1])
    with open(store.object_path(victim.object["sha256"]), "r+") as f:
        f.write("XX")

    assert store_admin.main(["--store", root, "verify", "--deep"]) == 1
    out = capsys.readouterr().out
    assert "CORRUPT" in out and hashes[1][:12] in out

    # --drop removes exactly the corrupt manifest; verify is clean after
    assert store_admin.main(["--store", root, "verify", "--deep",
                             "--drop"]) == 1
    assert store.lookup(hashes[1]) is None
    assert store_admin.main(["--store", root, "verify", "--deep"]) == 0
    capsys.readouterr()

    # gc with a budget that keeps only the pinned artifact's bytes
    assert store_admin.main(["--store", root, "gc", "--max-bytes", "50",
                             "--min-object-age", "0"]) == 0
    out = capsys.readouterr().out
    assert "evict" in out
    assert store.lookup(hashes[0]) is not None  # pinned
    assert store.lookup(hashes[2]) is None

    assert store_admin.main(["--store", root, "unpin", hashes[0]]) == 0
    assert store.pins() == {}

    with pytest.raises(ValueError, match="no store root"):
        store_admin.main(["ls"])


def test_store_admin_store_flag_after_subcommand(tmp_path, capsys):
    """The documented order `tools store verify --store DIR` must parse
    (README and the module docstring both show it after the subcommand)."""
    root = str(tmp_path / "store")
    _commit_n(ArtifactStore(root), tmp_path, 1)
    assert store_admin.main(["verify", "--store", root, "--deep"]) == 0
    assert store_admin.main(["ls", "--store", root]) == 0
    capsys.readouterr()


def test_store_admin_refuses_nonexistent_root(tmp_path):
    """Read-only admin commands must not mkdir a store at a mistyped
    root and report a false 'verified 0 ok' all-clear."""
    bogus = str(tmp_path / "no-such-store")
    with pytest.raises(ValueError, match="does not exist"):
        store_admin.main(["verify", "--store", bogus])
    assert not os.path.exists(bogus)


def test_dry_run_corruption_probe_does_not_mutate_the_store(tmp_path):
    """Dry-run planning (serve_hit with materialize=False) reports a
    corrupt hit as a rebuild but leaves manifest + object for the real
    run to handle."""
    store = ArtifactStore(str(tmp_path / "store"))
    out = write(str(tmp_path / "a.txt"), "good bytes!")
    ph = store.plan_hash({"op": "t"})
    m = store.commit(ph, out)
    obj = store.object_path(m.object["sha256"])
    with open(obj, "r+") as f:
        f.write("BAD")

    assert store.serve_hit(m, out, materialize=False) is False
    assert store.lookup(ph) is not None  # manifest kept
    assert os.path.exists(obj)  # object kept (the real run drops it)


def test_digest_cache_save_prunes_stale_entries(tmp_path):
    src = write(str(tmp_path / "in.txt"), "v1")
    cache_path = str(tmp_path / "cache.json")
    cache = keys.DigestCache(cache_path)
    cache.digest(src)
    write(src, "v2 longer")  # rewrite: fresh stat key
    cache.digest(src)
    cache.save()
    persisted = json.load(open(cache_path))
    assert len(persisted) == 1  # the dead v1 entry was pruned


def test_unparseable_manifest_is_a_nondestructive_miss(tmp_path, capsys):
    """A manifest with invalid JSON reads as a miss WITHOUT being
    unlinked (ls / verify-without---drop / gc --dry-run must not mutate
    the store); `tools store verify` surfaces it and --drop removes it."""
    tm.enable()
    root = str(tmp_path / "store")
    store = ArtifactStore(root)
    _commit_n(store, tmp_path, 1)
    bad_ph = "f" * 64
    write(store.manifest_path(bad_ph), "{truncated json")

    assert store.lookup(bad_ph) is None
    assert os.path.isfile(store.manifest_path(bad_ph))  # not unlinked
    assert tm.REGISTRY.counter("chain_store_corrupt_total").get() >= 1

    assert store_admin.main(["verify", "--store", root]) == 1
    assert "unreadable/unparseable" in capsys.readouterr().out
    assert store_admin.main(["verify", "--store", root, "--drop"]) == 1
    assert not os.path.isfile(store.manifest_path(bad_ph))
    capsys.readouterr()
    assert store_admin.main(["verify", "--store", root]) == 0


def test_store_admin_parse_bytes():
    assert store_admin._parse_bytes("1024") == 1024
    assert store_admin._parse_bytes("500M") == 500 << 20
    assert store_admin._parse_bytes("2G") == 2 << 30
    assert store_admin._parse_bytes("1.5K") == 1536


# ---------------------------------------------------------- GC pressure


def test_store_pressure_evicts_lru_but_honors_active_pins(tmp_path):
    tm.enable()
    try:
        store = ArtifactStore(str(tmp_path / "store"))
        paths = {}
        for i, tag in enumerate(("old", "mid", "hot")):
            p = tmp_path / f"{tag}.bin"
            p.write_bytes(bytes([i]) * 4096)
            store.commit(tag * 21 + tag[0], str(p), producer=tag)
            paths[tag] = p
            time.sleep(0.05)  # distinct manifest mtimes for LRU order
        active = {("hot" * 21 + "h")}
        pressure = StorePressure(
            store, budget_bytes=8192, active_plans=lambda: active,
        )
        summary = pressure.maybe_collect(force=True)
        assert summary is not None
        assert summary["bytes_freed"] > 0
        assert summary["objects_evicted"] >= 1
        assert summary["pins_honored"] >= 1
        # the active (pinned) plan survived; the oldest cold one went
        assert store.lookup("hot" * 21 + "h") is not None
        assert store.lookup("old" * 21 + "o") is None
        # throttle: an immediate second unforced pass is a no-op
        assert pressure.maybe_collect() is None
    finally:
        tm.disable()


def test_gc_collect_reports_summary_keys(tmp_path):
    from processing_chain_tpu_torch.store import gc as store_gc

    store = ArtifactStore(str(tmp_path / "store"))
    p = tmp_path / "a.bin"
    p.write_bytes(b"x" * 1024)
    store.commit("a" * 64, str(p), producer="t")
    report = store_gc.enforce_budget(store, size_budget_bytes=1 << 30)
    for key in ("bytes_freed", "objects_evicted", "pins_honored",
                "kept_bytes", "kept_manifests"):
        assert key in report
    assert report["kept_manifests"] == 1
    assert report["bytes_freed"] == 0



# ---------------------------------------- parity with the reference


@pytest.mark.parametrize("budget", [0, 600, 1500, None])
def test_gc_collect_evicts_the_same_digests_as_the_reference(tmp_path,
                                                             budget):
    """One seeded store state in each package, one `gc.collect` each:
    the same manifests evicted in the same order, the same digests kept
    and freed, the same orphan swept (exact equality)."""
    from processing_chain_tpu.store import gc as jgc
    from processing_chain_tpu.store.store import ArtifactStore as JStore

    ours = ArtifactStore(str(tmp_path / "port"))
    ref = JStore(str(tmp_path / "ref"))
    state = seeded_store_state(ours, str(tmp_path / "src"), 40)
    assert seeded_store_state(ref, str(tmp_path / "src"), 40) == state
    a = store_gc.collect(ours, size_budget_bytes=budget,
                         min_object_age_s=3600)
    b = jgc.collect(ref, size_budget_bytes=budget, min_object_age_s=3600)
    assert gc_outcome(a, ours, state["hashes"]) == \
        gc_outcome(b, ref, state["hashes"])
    assert a["orphans_removed"] == 1
    if budget is not None and budget < 1500:
        assert a["evicted_manifests"]
    assert all(ours.lookup(h) is not None for h in state["pins"])


def test_store_pressure_evicts_the_same_digests_as_the_reference(tmp_path):
    """`StorePressure` with the same budget and the same active plans
    pinned: the same summary and the same survivors in both packages."""
    from processing_chain_tpu.serve.pressure import StorePressure as JPressure
    from processing_chain_tpu.store.store import ArtifactStore as JStore

    ours = ArtifactStore(str(tmp_path / "port"))
    ref = JStore(str(tmp_path / "ref"))
    state = seeded_store_state(ours, str(tmp_path / "src"), 41)
    seeded_store_state(ref, str(tmp_path / "src"), 41)
    active = set(state["hashes"][:3])
    a = StorePressure(ours, budget_bytes=700,
                      active_plans=lambda: active).maybe_collect(force=True)
    b = JPressure(ref, budget_bytes=700,
                  active_plans=lambda: active).maybe_collect(force=True)
    keys_ = ("bytes_freed", "objects_evicted", "pins_honored",
             "kept_bytes", "kept_manifests", "evicted_manifests")
    assert {k: a[k] for k in keys_} == {k: b[k] for k in keys_}
    assert a["objects_evicted"] >= 1
    assert all(ours.lookup(h) is not None for h in active)
    assert [h for h in state["hashes"] if ours.lookup(h)] == \
        [h for h in state["hashes"] if ref.lookup(h)]
