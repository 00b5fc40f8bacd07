"""store-heat: the access-heat report and the read-heavy zipf soak.

Two subcommands over the heat ledger (store/heat.py — the read-path
flight recorder of the artifact plane):

    tools store-heat report SOURCE [--top N] [--json]
    tools store-heat soak   [--plans 12] [--reads 400] [--out FILE]
                            [--root DIR] [--budget-fraction 0.35]

`report` renders the fleet-merged ledger of one store (SOURCE is a
store root, or a serve root whose `store/` is the conventional layout):
totals, the 304 edge-hit ratio, per-replica sums, the top-N plans by
reads and by bytes, and the working-set curve — "X% of bytes serve Y%
of reads", the promotion/demotion signal ROADMAP item 2's tiering
needs.

`soak` is the measured acceptance harness (committed as
STORE_HEAT_r16.json): two in-process replicas over one store, a warm
build of mixed-size plans, a zipf-distributed read storm with
conditional GETs (nonzero 304 ratio on re-reads), then the regret
experiment — under an ADEQUATE budget nothing is evicted and regret is
zero; under a deliberately UNDERSIZED budget the GC evicts with
forensics and the soak's re-reads and one re-POST fire
`chain_store_eviction_regret_total` via both paths (read and rebuild).
Exit 1 when any invariant fails, serve-soak style.

The port's copy of processing_chain_tpu/tools/store_heat.py.
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


def _resolve_heat_dir(source: str) -> str:
    """SOURCE may be a store root (holding heat/) or a serve root
    (holding store/heat)."""
    direct = store_heat.heat_dir(source)
    if os.path.isdir(direct):
        return direct
    nested = store_heat.heat_dir(os.path.join(source, "store"))
    if os.path.isdir(nested):
        return nested
    return direct


def _curve_headline(curve: list) -> Optional[dict]:
    """The smallest hot-set prefix covering 90% of reads — the one
    sentence an operator sizes a cache tier from."""
    for point in curve:
        if point["reads_frac"] >= 0.9:
            return point
    return curve[-1] if curve else None


def _downsample(curve: list, points: int = 10) -> list:
    if len(curve) <= points:
        return curve
    step = len(curve) / points
    picked = [curve[min(len(curve) - 1, int(i * step))]
              for i in range(1, points)]
    picked.append(curve[-1])
    return picked


def _cmd_report(source: str, top: int, as_json: bool) -> int:
    root = _resolve_heat_dir(source)
    agg = store_heat.aggregate(root)
    curve = store_heat.working_set_curve(agg["per_plan"])
    totals = agg["totals"]
    ratio_304 = (totals["not_modified"] / totals["reads"]
                 if totals["reads"] else 0.0)
    if as_json:
        print(json.dumps({
            "heat_dir": root,
            "totals": totals,
            "ratio_304": round(ratio_304, 4),
            "by_replica": agg["by_replica"],
            "by_tier": agg["by_tier"],
            "working_set_curve": _downsample(curve),
        }, sort_keys=True))
        return 0
    if not totals["reads"] and not totals["evictions"]:
        print(f"{root}: no heat records")
        return 0
    print(f"heat ledger: {root}")
    print(f"reads: {totals['reads']} (full={totals['full']} "
          f"304={totals['not_modified']} range={totals['range']}, "
          f"304 ratio {ratio_304:.1%})  "
          f"bytes served: {totals['bytes'] / 1e6:.1f} MB")
    print(f"evictions: {totals['evictions']}  "
          f"regrets: {totals['regrets']}  "
          f"promotions: {totals['promotions']}  "
          f"demotions: {totals['demotions']}")
    for rep in sorted(agg["by_replica"]):
        entry = agg["by_replica"][rep]
        print(f"  replica {rep:<28} reads {entry['reads']:>6}  "
              f"bytes {entry['bytes'] / 1e6:9.1f} MB")
    if agg["by_tier"]:
        print("reads by tier (where the byte was found):")
        for tier in sorted(agg["by_tier"]):
            entry = agg["by_tier"][tier]
            frac = (entry["reads"] / totals["reads"]
                    if totals["reads"] else 0.0)
            print(f"  tier {tier:<8} reads {entry['reads']:>6} "
                  f"({frac:6.1%})  bytes {entry['bytes'] / 1e6:9.1f} MB")
    by_reads = sorted(agg["per_plan"].items(),
                      key=lambda kv: -kv[1]["reads"])[:top]
    if by_reads:
        print(f"top {len(by_reads)} plans by reads:")
        for plan, entry in by_reads:
            age = time.time() - entry["last_ts"] if entry["last_ts"] else 0
            tiers = "".join(
                f" {t}={n}" for t, n in sorted(entry["tiers"].items()))
            print(f"  {plan[:12]}  reads {entry['reads']:>5} "
                  f"(304 {entry['not_modified']})  "
                  f"{store_heat.plan_size(entry) / 1e6:7.2f} MB  "
                  f"last read {age / 60:.1f}m ago"
                  + (f"  tiers:{tiers}" if tiers else ""))
    by_bytes = sorted(agg["per_plan"].items(),
                      key=lambda kv: -kv[1]["bytes"])[:top]
    if by_bytes:
        print(f"top {len(by_bytes)} plans by bytes served:")
        for plan, entry in by_bytes:
            print(f"  {plan[:12]}  served {entry['bytes'] / 1e6:9.2f} MB "
                  f"over {entry['reads']} read(s)")
    headline = _curve_headline(curve)
    if headline:
        print(
            f"working set: {headline['plans']} plan(s) = "
            f"{headline['bytes_frac']:.0%} of bytes serve "
            f"{headline['reads_frac']:.0%} of reads"
        )
        for point in _downsample(curve):
            print(f"  {point['plans']:>4} plans: "
                  f"{point['bytes_frac']:7.1%} of bytes -> "
                  f"{point['reads_frac']:7.1%} of reads")
    return 0


# -------------------------------------------------------------- the soak


def _get(url: str, etag: Optional[str] = None,
         timeout: float = 30.0) -> tuple:
    """(status, etag, body_bytes, elapsed_s) for one artifact GET;
    urllib surfaces 304 as an HTTPError, which for this probe is just
    another answer."""
    req = urllib.request.Request(url)
    if etag:
        req.add_header("If-None-Match", etag)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read()
            return (resp.status, resp.headers.get("ETag"), len(body),
                    time.perf_counter() - t0)
    except urllib.error.HTTPError as exc:
        exc.read()
        return (exc.code, exc.headers.get("ETag"), 0,
                time.perf_counter() - t0)


def _zipf_rank(rng: random.Random, n: int) -> int:
    """A zipf(1)-distributed rank in [0, n): hot-head, long-tail — the
    read mix a content cache actually sees."""
    weights = [1.0 / (k + 1) for k in range(n)]
    return rng.choices(range(n), weights=weights, k=1)[0]


def _read_percentiles(urls: list, timeout_s: float = 5.0) -> dict:
    """p50/p99 per (phase × size class) from the replicas' merged
    /metrics histograms — the same estimate path the fleet view grades
    SLOs with (telemetry/fleet.py)."""
    from ..telemetry import fleet

    parsed = []
    for url in urls:
        try:
            with urllib.request.urlopen(url.rstrip("/") + "/metrics",
                                        timeout=timeout_s) as resp:
                text = resp.read().decode(errors="replace")
        except (urllib.error.URLError, TimeoutError, OSError):
            continue
        parsed.append(fleet.parse_histograms(
            text, fleet.READ_PHASE_METRICS.values()))
    merged = fleet.merge_histograms(parsed)
    out: dict = {}
    for (name, _), series in sorted(merged.items()):
        phase = next(p for p, m in fleet.READ_PHASE_METRICS.items()
                     if m == name)
        size_class = series["labels"].get("size_class", "?")
        cell = out.setdefault(phase, {}).setdefault(size_class, {})
        cell["n"] = series["count"]
        for frac in (0.50, 0.99):
            est = fleet.percentile_from_buckets(series["buckets"], frac)
            cell[f"p{int(frac * 100)}_s"] = \
                round(est, 6) if est is not None else None
    return out


def _cmd_soak(args) -> int:
    from ..serve.service import ChainServeService

    log = get_logger()
    root = args.root or tempfile.mkdtemp(prefix="chain-store-heat-")
    rng = random.Random(0xBEEF)
    # mixed size classes on purpose: the read SLO grades per size
    # class, so the soak must populate more than one row
    sizes = [4096 if i % 2 else (1 << 20) + 4096
             for i in range(args.plans)]
    replicas = [
        ChainServeService(
            root=root, port=0, executor="synthetic", workers=2,
            replica=f"heat{i}",
            info_path=os.path.join(root, f"serve-info-heat{i}.json"),
        ).start()
        for i in range(2)
    ]
    report: dict = {"plans": args.plans, "reads": args.reads,
                    "root": root, "replicas": 2}
    failures: list[str] = []
    try:
        # ---- warm phase: one plan per request, driven through replica 0
        req_ids = []
        for i in range(args.plans):
            req_ids.append(replicas[0].submit({
                "tenant": "soak",
                "priority": "normal",
                "database": "P2STR01",
                "srcs": [f"SRC{100 + i:03d}"],
                "hrcs": ["HRC100"],
                "params": {"geometry": [64, 36], "size_bytes": sizes[i],
                           "work_ms": 1.0},
            })["request"])
        plans: list[str] = []
        for rid in req_ids:
            if replicas[0].wait_request(rid, timeout=60.0) != "done":
                failures.append(f"warm request {rid} never completed")
                continue
            doc = replicas[0].request_status(rid)
            plans.extend(u["plan"] for u in doc["units"].values())
        if len(plans) != args.plans:
            failures.append(
                f"warm store holds {len(plans)}/{args.plans} plans")

        # ---- read storm: zipf-ranked, alternating replicas, with
        # conditional re-reads (every other revisit sends the ETag)
        etags: dict = {}
        seen: dict = {}
        by_status: dict = {}
        for r in range(args.reads):
            plan = plans[_zipf_rank(rng, len(plans))]
            svc = replicas[r % 2]
            url = f"{svc.server.url}/v1/artifacts/{plan}?tenant=soak"
            visits = seen.get(plan, 0)
            conditional = visits > 0 and visits % 2 == 1
            status, etag, _, _ = _get(
                url, etag=etags.get(plan) if conditional else None)
            seen[plan] = visits + 1
            if etag:
                etags[plan] = etag
            by_status[status] = by_status.get(status, 0) + 1
        report["reads_by_status"] = by_status
        if by_status.get(200, 0) == 0:
            failures.append("read storm produced no 200s")
        if by_status.get(304, 0) == 0:
            failures.append("conditional re-reads produced no 304s")
        if by_status.get(404, 0):
            failures.append(
                f"{by_status[404]} 404(s) before any eviction")

        # ---- adequate budget: nothing is over budget, regret stays 0
        heat_root = store_heat.heat_dir(replicas[0].store.root)
        agg = store_heat.aggregate(heat_root)
        totals = agg["totals"]
        replica_sum = {
            "reads": sum(e["reads"] for e in agg["by_replica"].values()),
            "bytes": sum(e["bytes"] for e in agg["by_replica"].values()),
        }
        if (totals["reads"] != replica_sum["reads"]
                or totals["bytes"] != replica_sum["bytes"]):
            failures.append(
                f"fleet-merged totals {totals} disagree with "
                f"per-replica sums {replica_sum}")
        report["ledger_totals"] = dict(totals)
        report["ledger_by_replica"] = agg["by_replica"]
        report["ratio_304"] = round(
            totals["not_modified"] / totals["reads"], 4) \
            if totals["reads"] else 0.0
        report["regret_adequate_budget"] = totals["regrets"]
        if totals["regrets"]:
            failures.append(
                f"{totals['regrets']} regret(s) under an adequate "
                "budget — must be zero")
        curve = store_heat.working_set_curve(agg["per_plan"])
        report["working_set_curve"] = _downsample(curve)
        headline = _curve_headline(curve)
        if headline:
            report["working_set_90pct_reads"] = headline

        # ---- undersized budget: force the pressure pass, demand
        # forensic evictions
        store_bytes = replicas[0].store.stats()["bytes"]
        budget = max(1, int(store_bytes * args.budget_fraction))
        report["store_bytes"] = store_bytes
        report["undersized_budget_bytes"] = budget
        replicas[0].pressure.budget_bytes = budget
        summary = replicas[0].pressure.maybe_collect(force=True)
        evicted = list((summary or {}).get("evicted_manifests", []))
        victims = list((summary or {}).get("victims", []))
        report["evicted"] = len(evicted)
        if not evicted:
            failures.append(
                f"undersized budget ({budget} of {store_bytes} bytes) "
                "evicted nothing")
        if len(victims) < len(evicted) or any(
                "last_used_age_s" not in v for v in victims
                if v.get("reason") == "over_budget"):
            failures.append("evictions missing per-victim evidence")

        # ---- regret, via read: replica 1 re-reads what replica 0's
        # pressure pass just evicted (cross-replica: the detector reads
        # the peer journal)
        for plan in evicted[:3]:
            status, _, _, _ = _get(
                f"{replicas[1].server.url}/v1/artifacts/{plan}"
                "?tenant=soak")
            if status != 404:
                failures.append(
                    f"evicted plan answered {status}, expected 404")
        # ---- regret, via rebuild: re-POST one evicted plan; the queue
        # remembers the completion, the store no longer holds it
        if evicted:
            i = plans.index(evicted[0]) if evicted[0] in plans else 0
            rid = replicas[0].submit({
                "tenant": "soak",
                "priority": "normal",
                "database": "P2STR01",
                "srcs": [f"SRC{100 + i:03d}"],
                "hrcs": ["HRC100"],
                "params": {"geometry": [64, 36],
                           "size_bytes": sizes[i], "work_ms": 1.0},
            })["request"]
            replicas[0].wait_request(rid, timeout=60.0)
        regrets = {"read": 0, "rebuild": 0}
        for record in store_heat.read_journals(heat_root):
            if record.get("kind") == "regret":
                via = record.get("via", "?")
                regrets[via] = regrets.get(via, 0) + 1
        report["regret_undersized_budget"] = regrets
        if evicted and not regrets["read"]:
            failures.append("re-reading evicted plans fired no read "
                            "regret")
        if evicted and not regrets["rebuild"]:
            failures.append("re-POSTing an evicted plan fired no "
                            "rebuild regret")

        # ---- read SLO percentiles from the /metrics histograms. Both
        # in-process replicas render the ONE process-wide registry, so
        # scraping one already covers the fleet — merging both would
        # double-count n (real fleets are one process per replica)
        report["read_latency"] = _read_percentiles(
            [replicas[0].server.url])
        if not report["read_latency"].get("read_ttfb_s"):
            failures.append("no read TTFB observations in /metrics")
    finally:
        for svc in replicas:
            try:
                svc.stop()
            except Exception:  # noqa: BLE001 - report the soak, not the teardown
                log.warning("store-heat soak: replica stop failed",
                            exc_info=True)

    report["failures"] = failures
    report["ok"] = not failures
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        atomic_write_text(args.out, line + "\n")
    if failures:
        for f in failures:
            log.error("store-heat soak: %s", f)
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools store-heat", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_report = sub.add_parser(
        "report", help="fleet-merged heat report of one store")
    p_report.add_argument(
        "source",
        help="store root (holding heat/) or serve root (store/heat)")
    p_report.add_argument("--top", type=int, default=10,
                          help="plans per top-N table")
    p_report.add_argument("--json", action="store_true",
                          help="machine-readable aggregate")
    p_soak = sub.add_parser(
        "soak", help="2-replica zipf read soak + regret experiment")
    p_soak.add_argument("--plans", type=int, default=12,
                        help="distinct plans to warm (mixed sizes)")
    p_soak.add_argument("--reads", type=int, default=400,
                        help="zipf-distributed GETs across the fleet")
    p_soak.add_argument("--budget-fraction", type=float, default=0.35,
                        help="undersized budget as a fraction of the "
                             "warm store's bytes")
    p_soak.add_argument("--out", default=None,
                        help="write the JSON report here too")
    p_soak.add_argument("--root", default=None,
                        help="serve root (default: fresh temp dir)")
    args = parser.parse_args(list(argv) if argv is not None else None)

    if args.cmd == "report":
        return _cmd_report(args.source, args.top, args.json)
    return _cmd_soak(args)


if __name__ == "__main__":
    raise SystemExit(main())
