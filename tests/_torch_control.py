"""Shared inputs of the control-plane parity tests: a seeded store
state either package's ArtifactStore can hold (GC, pressure and tier
parity), and a serve root driven through the control plane (one `wave`
replica with a store budget of three artifacts, through the completion
hook's eviction, eviction regret, artifact reads and control ticks) by either package's
ChainServeService, so each package's readers can be held to the other's
journals."""

from __future__ import annotations

import json
import os
import time
import urllib.request

GEO = {"frames": 8, "src_h": 36, "src_w": 64, "dst_h": 72, "dst_w": 128}
#: one unit's artifact: Y, U and V at the destination geometry
ARTIFACT_BYTES = GEO["frames"] * GEO["dst_h"] * GEO["dst_w"] * 3 // 2


def body(srcs, tenant="lab-a") -> dict:
    return {"tenant": tenant, "database": "P2STR01", "srcs": list(srcs),
            "hrcs": ["HRC001"], "params": dict(GEO)}


def fetch(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read()


def drive(service_cls, root: str, **kw) -> dict:
    """Run the scenario on a service of `service_cls` rooted at `root`
    and stop it. Returns {"plans", "evicted"}. The store budget holds
    one request's three artifacts; the service's own completion hook
    evicts when a fourth lands."""
    svc = service_cls(
        root=root, port=0, executor="wave", workers=1, replica="w-a",
        store_budget_bytes=3 * ARTIFACT_BYTES + 4096, poll_s=0.05,
        control_interval_s=0.05, alert_window_scale=0.01, **kw,
    ).start()
    try:
        acc = svc.submit(body(["SRC001", "SRC002", "SRC003"]))
        assert svc.wait_request(acc["request"], timeout=120.0) == "done"
        done_at = time.monotonic()
        units = svc.request_status(acc["request"])["units"]
        plans = {pvs: u["plan"] for pvs, u in units.items()}
        first = {pvs: fetch(svc.server.url + u["artifact"])
                 for pvs, u in units.items()}
        objects = {pvs: svc.store.object_path(svc.store.lookup(plan).object["sha256"])
                   for pvs, plan in plans.items()}
        # the hook checks the budget at most once a min_interval_s: wait
        # out the check the first request's completions made
        time.sleep(max(0.0, done_at + svc.pressure.min_interval_s + 1.0
                       - time.monotonic()))
        more = svc.submit(body(["SRC004"]))
        assert svc.wait_request(more["request"], timeout=120.0) == "done"
        newest = svc.request_status(more["request"])["units"]
        assert all(len(fetch(svc.server.url + u["artifact"])) == ARTIFACT_BYTES
                   for u in newest.values())
        # the hook's pass runs just after the request reads as done; wait
        # until it has deleted the evicted bytes too (the pass drops a
        # manifest before its object, and a re-commit of the same bytes
        # in between would lose them)
        deadline = time.monotonic() + 20.0
        evicted: list = []
        while not evicted and time.monotonic() < deadline:
            time.sleep(0.02)
            evicted = [pvs for pvs, plan in plans.items()
                       if svc.store.lookup(plan) is None
                       and not os.path.exists(objects[pvs])]
        assert len(evicted) == 1, evicted
        # the evicted plan re-requested: recomputed, identical bytes
        again = svc.submit(body([evicted[0].split("_")[1]]))
        assert svc.wait_request(again["request"], timeout=120.0) == "done"
        redo = svc.request_status(again["request"])["units"][evicted[0]]
        assert redo["plan"] == plans[evicted[0]]
        # the reference's maintenance sweep can read the plan's stale done
        # record as this request's completion before the re-run commits
        # (ROADMAP Queue C; the port's service waits for the bytes)
        deadline = time.monotonic() + 20.0
        while svc.store.lookup(redo["plan"]) is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fetch(svc.server.url + redo["artifact"]) == first[evicted[0]]
        # the next control tick grades the regret (its fast short window
        # is 3 s at this scale)
        deadline = time.monotonic() + 20.0
        regret = False
        while time.monotonic() < deadline and not regret:
            time.sleep(0.05)
            doc = json.loads(fetch(svc.server.url + "/fleet/alerts"))
            regret = any(a.get("rule") == "store_eviction_regret"
                         for a in doc["active"] + doc["resolved"])
        assert regret, "the eviction regret never fired its alert"
        fetch(svc.server.url + "/fleet/scale-signal")
    finally:
        svc.stop()
    return {"plans": plans, "evicted": evicted}


def _write(path: str, text: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def seeded_store_state(store, src_dir, seed: int, n: int = 10) -> dict:
    """Commit `n` seeded artifacts (some sharing bytes) into `store`,
    stamp their LRU order, pin two, and leave one old orphan object:
    the same store state whichever package's ArtifactStore `store` is.
    Returns {"hashes", "pins"}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = rng.integers(40, 400, size=n)
    order = rng.permutation(n)
    now = time.time()
    hashes = []
    for i in range(n):
        # every fourth artifact repeats its predecessor's bytes
        content = f"{i - 1 if i % 4 == 3 else i}:" * int(sizes[i])
        out = _write(os.path.join(src_dir, f"a{i}.txt"), content)
        ph = store.plan_hash({"op": "t", "i": i})
        store.commit(ph, out)
        stamp = now - 10_000 + 100 * int(order[i])
        os.utime(store.manifest_path(ph), (stamp, stamp))
        hashes.append(ph)
    pins = [hashes[int(i)] for i in rng.choice(n, size=2, replace=False)]
    for ph in pins:
        store.pin(ph, "golden")
    orphan = _write(store.object_path("ee" + "7" * 62), "orphan bytes")
    os.utime(orphan, (now - 7200, now - 7200))
    return {"hashes": hashes, "pins": pins}


def gc_outcome(report: dict, store, hashes: list) -> dict:
    """The time-free part of a GC report plus what survived."""
    keep = ("evicted_manifests", "evicted_bytes", "kept_manifests",
            "kept_bytes", "bytes_freed", "objects_evicted", "pins_honored",
            "orphans_removed", "orphan_bytes", "demoted_bytes")
    victims = [(v.get("plan"), v.get("object"), v.get("reason"),
                v.get("tier"), v.get("freed_bytes"), v.get("objects"))
               for v in report["victims"]]
    demotions = [(d["object"], d["from_tier"], d["to_tier"], d["bytes"])
                 for d in report["demotions"]]
    return {**{k: report[k] for k in keep}, "victims": victims,
            "demotions": demotions,
            "live": [h for h in hashes if store.lookup(h) is not None],
            "objects": sorted(store.iter_objects()),
            "tiers": {h: store.locate_tier(store.lookup(h).object["sha256"])
                      for h in hashes if store.lookup(h) is not None}}
