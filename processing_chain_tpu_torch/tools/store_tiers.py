"""store-tiers: the tiered-placement soak (STORE_TIERS_r17.json).

    tools store-tiers soak [--plans 12] [--reads 300] [--replicas 2]
                           [--out FILE] [--root DIR]

The measured acceptance harness for the hot/warm/cold placement layer
(store/tiers.py, docs/STORE.md "Tier hierarchy"): N in-process serve
replicas over ONE tiered store whose hot tier is deliberately
UNDERSIZED against the warm build, then

  * a forced pressure pass demotes the coldest objects down the
    hierarchy (demote before evict — with no total budget nothing may
    be evicted, and nothing ever regrets);
  * a zipf-distributed read storm falls through hot→warm→cold, counts
    per-tier hits in the heat ledger, and read-through-promotes the
    hot head back up;
  * the same probe set is timed with promotion DISABLED (every read
    streams from wherever the bytes sit) and again after the
    promotion storm (the hot head serves from the local fd path) —
    the p99 pair is the "what does the hot tier buy" headline;
  * ranged reads (RFC 9110 single-range) answer 206 and land in the
    ledger as their own read mode;
  * a final pressure pass squeezes the re-promoted head back under
    the hot budget, and every manifest must still integrity-verify
    from whichever tier holds its bytes.

Prints one JSON report line and exits 1 when any invariant fails
(zero evictions, zero regret, demotions observed, promotions
observed, hits in ≥2 tiers, 206s served, hot tier back under budget,
all manifests verify).

The port's copy of processing_chain_tpu/tools/store_tiers.py.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import tempfile
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

from ..store import heat as store_heat
from ..utils.fsio import atomic_write_text
from ..utils.log import get_logger
from .store_heat import _zipf_rank


def _get(url: str, range_header: Optional[str] = None,
         timeout: float = 30.0) -> tuple:
    """(status, body_len, elapsed_s) for one artifact GET; 3xx/4xx
    surface as HTTPError, which for this probe is just another answer."""
    req = urllib.request.Request(url)
    if range_header:
        req.add_header("Range", range_header)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read()
            return resp.status, len(body), time.perf_counter() - t0
    except urllib.error.HTTPError as exc:
        exc.read()
        return exc.code, 0, time.perf_counter() - t0


def _p99_ms(values: list) -> Optional[float]:
    from ..telemetry.fleet import percentile_exact

    if not values:
        return None
    return round(percentile_exact(values, 0.99) * 1e3, 3)


def _cmd_soak(args) -> int:
    from ..serve.service import ChainServeService

    log = get_logger()
    root = args.root or tempfile.mkdtemp(prefix="chain-store-tiers-")
    rng = random.Random(0x71E2)
    # hot@1M against ~6 MB of mixed-size plans: the hot tier CANNOT
    # hold the build, so the demotion path must fire; warm@3M forces a
    # further spill into cold, populating all three rungs
    hot_budget = 1 << 20
    spec = (f"hot@{hot_budget},local={os.path.join(root, 'warm')}@3M,"
            f"object={os.path.join(root, 'cold')}")
    sizes = [4096 if i % 2 else (1 << 20) + 4096
             for i in range(args.plans)]
    replicas = [
        ChainServeService(
            root=root, port=0, executor="synthetic", workers=2,
            replica=f"tier{i}", store_tiers=spec,
            info_path=os.path.join(root, f"serve-info-tier{i}.json"),
        ).start()
        for i in range(args.replicas)
    ]
    store = replicas[0].store
    report: dict = {"plans": args.plans, "reads": args.reads,
                    "replicas": args.replicas, "root": root,
                    "tier_spec": spec, "hot_budget_bytes": hot_budget}
    failures: list[str] = []
    try:
        # ---- warm build: everything ingests hot -----------------------
        req_ids = [
            replicas[0].submit({
                "tenant": "soak", "priority": "normal",
                "database": "P2STR01",
                "srcs": [f"SRC{100 + i:03d}"], "hrcs": ["HRC100"],
                "params": {"geometry": [64, 36], "size_bytes": sizes[i],
                           "work_ms": 1.0},
            })["request"]
            for i in range(args.plans)
        ]
        plans: list[str] = []
        for rid in req_ids:
            if replicas[0].wait_request(rid, timeout=120.0) != "done":
                failures.append(f"warm request {rid} never completed")
                continue
            doc = replicas[0].request_status(rid)
            plans.extend(u["plan"] for u in doc["units"].values())
        report["tier_stats_warm"] = store.tiers.tier_stats()

        # ---- demotion under pressure: hot is over ITS budget, there
        # is no total budget — demote, never evict
        summary = replicas[0].pressure.maybe_collect(force=True) or {}
        report["demotions_initial"] = len(summary.get("demotions", []))
        report["tier_stats_demoted"] = store.tiers.tier_stats()
        if not summary.get("demotions"):
            failures.append("forced pressure pass over an undersized "
                            "hot tier demoted nothing")
        if summary.get("evicted_manifests"):
            failures.append(
                f"{len(summary['evicted_manifests'])} eviction(s) with "
                "no total budget — demote-before-evict is broken")
        # hot may legitimately be EMPTY here (objects bigger than the
        # whole hot budget demote entirely); what must hold is that the
        # spill crossed both lower rungs
        populated = {n for n, s in store.tiers.tier_stats().items()
                     if s["objects"]}
        missing = {"warm", "cold"} - populated
        if missing:
            failures.append(f"tier(s) {sorted(missing)} hold nothing "
                            "after demotion — the spill never got there")

        # ---- p99 WITHOUT the hot tier: promotion off, every read
        # streams from wherever its bytes sit (the demoted warm/cold
        # head included)
        for svc in replicas:
            svc.store.tiers.promote_on_read = False
        probe_set = plans[:: max(1, len(plans) // 8)]
        cold_ms: list[float] = []
        for _ in range(3):
            for plan in probe_set:
                svc = replicas[rng.randrange(len(replicas))]
                status, _, dt = _get(
                    f"{svc.server.url}/v1/artifacts/{plan}?tenant=soak")
                if status != 200:
                    failures.append(
                        f"unpromoted read answered {status}, expected 200")
                cold_ms.append(dt)
        report["p99_ms_without_hot"] = _p99_ms(cold_ms)

        # ---- the zipf storm, promotion on: the hot head climbs back --
        for svc in replicas:
            svc.store.tiers.promote_on_read = True
        by_status: dict = {}
        for r in range(args.reads):
            plan = plans[_zipf_rank(rng, len(plans))]
            svc = replicas[r % len(replicas)]
            status, _, _ = _get(
                f"{svc.server.url}/v1/artifacts/{plan}?tenant=soak")
            by_status[status] = by_status.get(status, 0) + 1
        report["storm_by_status"] = by_status
        if by_status.get(404, 0):
            failures.append(f"{by_status[404]} 404(s) in the storm — "
                            "placement lost an object")
        warm_ms: list[float] = []
        for _ in range(3):
            for plan in probe_set:
                svc = replicas[rng.randrange(len(replicas))]
                status, _, dt = _get(
                    f"{svc.server.url}/v1/artifacts/{plan}?tenant=soak")
                warm_ms.append(dt)
        report["p99_ms_with_hot"] = _p99_ms(warm_ms)
        report["tier_stats_storm"] = store.tiers.tier_stats()
        if not report["tier_stats_storm"]["hot"]["objects"]:
            failures.append("the storm left the hot tier empty — "
                            "read-through promotion moved nothing up")

        # ---- ranged reads: RFC 9110 single-range, own ledger mode ----
        ranged_206 = 0
        for plan in probe_set:
            svc = replicas[0]
            status, n, _ = _get(
                f"{svc.server.url}/v1/artifacts/{plan}?tenant=soak",
                range_header="bytes=0-1023")
            if status == 206 and n == 1024:
                ranged_206 += 1
            else:
                failures.append(f"ranged read answered {status} with "
                                f"{n} byte(s), expected 206/1024")
        report["ranged_reads"] = {"requested": len(probe_set),
                                  "status_206": ranged_206}

        # ---- final squeeze: the promoted head must fit hot again -----
        summary = replicas[0].pressure.maybe_collect(force=True) or {}
        report["demotions_final"] = len(summary.get("demotions", []))
        report["tier_stats_final"] = store.tiers.tier_stats()
        hot_bytes = report["tier_stats_final"]["hot"]["bytes"]
        if hot_bytes > hot_budget:
            failures.append(f"hot tier holds {hot_bytes} bytes after "
                            f"the final pass, over its {hot_budget} "
                            "budget")

        # ---- the ledger's verdict ------------------------------------
        heat_root = store_heat.heat_dir(store.root)
        agg = store_heat.aggregate(heat_root)
        totals = agg["totals"]
        report["ledger_totals"] = dict(totals)
        hits = {t: dict(e) for t, e in agg["by_tier"].items()}
        for entry in hits.values():
            entry["hit_ratio"] = (
                round(entry["reads"] / totals["reads"], 4)
                if totals["reads"] else 0.0)
        report["per_tier_hits"] = hits
        if totals["promotions"] == 0:
            failures.append("the storm promoted nothing — read-through "
                            "promotion never fired")
        if totals["demotions"] == 0:
            failures.append("ledger records no demotions")
        if totals["range"] == 0:
            failures.append("ranged reads left no range-mode ledger "
                            "records")
        if totals["evictions"] or totals["regrets"]:
            failures.append(
                f"{totals['evictions']} eviction(s) / "
                f"{totals['regrets']} regret(s) under an adequate total "
                "budget — both must be zero")
        if len([t for t, e in hits.items() if e["reads"]]) < 2:
            failures.append(f"reads hit only {sorted(hits)} — the "
                            "fall-through path never crossed a tier "
                            "boundary")

        # ---- integrity: every manifest verifies from whichever tier
        # holds its bytes now
        from ..store.store import StoreCorruption

        for plan in plans:
            manifest = store.lookup(plan)
            if manifest is None:
                failures.append(f"plan {plan[:12]}… lost its manifest")
                continue
            try:
                store.verify_object(manifest.object)
            except StoreCorruption as exc:
                failures.append(f"plan {plan[:12]}… fails verification "
                                f"after placement: {exc}")
    finally:
        for svc in replicas:
            try:
                svc.stop()
            except Exception:  # noqa: BLE001 - report the soak, not the teardown
                log.warning("store-tiers soak: replica stop failed",
                            exc_info=True)

    report["failures"] = failures
    report["ok"] = not failures
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        atomic_write_text(args.out, line + "\n")
    if failures:
        for f in failures:
            log.error("store-tiers soak: %s", f)
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools store-tiers", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_soak = sub.add_parser(
        "soak", help="tiered-placement soak over an undersized hot tier")
    p_soak.add_argument("--plans", type=int, default=12,
                        help="distinct plans to warm (mixed sizes)")
    p_soak.add_argument("--reads", type=int, default=300,
                        help="zipf-distributed GETs across the fleet")
    p_soak.add_argument("--replicas", type=int, default=2,
                        help="in-process serve replicas over the store")
    p_soak.add_argument("--out", default=None,
                        help="write the JSON report here too")
    p_soak.add_argument("--root", default=None,
                        help="serve root (default: fresh temp dir)")
    args = parser.parse_args(list(argv) if argv is not None else None)
    return _cmd_soak(args)


if __name__ == "__main__":
    raise SystemExit(main())
