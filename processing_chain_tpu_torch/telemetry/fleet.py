"""Fleet-wide observability: replica discovery, SLO merge, trace assembly.

One chain-serve root can be served by any number of replica processes
(docs/SERVE.md "Running multiple replicas"), and before this module
each of them answered /status and /metrics only for ITSELF — nobody
could say "what is the fleet doing" or "what happened to request X"
without ssh'ing into every process. The collector here builds one
merged view from three sources that all outlive any single replica:

  * **serve-info files** — every replica writes `{url, replica, pid,
    replica_epoch}` at startup; `discover_replicas` scans the root for
    them and probes each /status + /metrics, marking dead ones instead
    of failing (a fleet view with one dead replica renders partial
    data, it does not crash).
  * **the shared durable state** — queue records and request docs under
    the root are the fleet's ground truth regardless of who is alive;
    counts come from disk, not from any replica's memory.
  * **the span journal** (serve/spans.py) — the per-replica transition
    history, merged into cross-replica request traces by
    `assemble_trace`, with the gapless-chain completeness check.

The SLO layer: each replica's /metrics carries the per-(tenant ×
priority-class) phase histograms (`chain_serve_queue_wait_seconds`,
`chain_serve_execution_seconds`, `chain_serve_e2e_seconds`);
`merge_histograms` sums them bucket-wise across replicas (cumulative
bucket counts sum to cumulative bucket counts — no rebinning), and
`slo_report` grades every flow against the declared bands in
`telemetry/catalog.SLO_BANDS`: estimated p50/p95/p99 plus the fraction
of observations inside the band.

Served as `/fleet` on every replica's LiveServer, rendered by `tools
fleet-top`, and consumed by `tools trace show` (the cross-replica
timeline, Chrome-trace export via profiling.build_chrome_trace).

The port's copy of processing_chain_tpu/telemetry/fleet.py.
"""

from __future__ import annotations

import json
import os
import re
import time
import urllib.error
import urllib.request
from typing import Iterable, Optional

from ..serve import spans as serve_spans
from ..store import heat as store_heat
from . import alerts as alerts_mod
from . import catalog

#: SLO phase -> the metric whose histogram measures it
PHASE_METRICS = {
    "queue_wait_s": "chain_serve_queue_wait_seconds",
    "execution_s": "chain_serve_execution_seconds",
    "e2e_s": "chain_serve_e2e_seconds",
}

#: read-path SLO phase -> metric (per tenant × size class; graded
#: against catalog.READ_SLO_BANDS — docs/STORE.md "Access heat &
#: eviction forensics")
READ_PHASE_METRICS = {
    "read_ttfb_s": "chain_serve_read_ttfb_seconds",
    "read_s": "chain_serve_read_seconds",
}

#: per-tenant cost-accounting counters merged into the /fleet "cost"
#: section (serve/cost.py; docs/SERVE.md "Cost-aware scheduling &
#: admission")
COST_COUNTERS = (
    "chain_serve_cost_predicted_seconds_total",
    "chain_serve_cost_observed_seconds_total",
    "chain_serve_cost_rejected_total",
)
#: per-tier placement metrics merged into the /fleet "store_tiers"
#: section (store/tiers.py; docs/STORE.md "Tier hierarchy")
TIER_METRICS = (
    "chain_store_tier_hits_total",
    "chain_store_tier_promotions_total",
    "chain_store_tier_demotions_total",
    "chain_store_tier_bytes",
)

#: device-plane wave counters (parallel/meshobs.py) — all cumulative
#: per-replica event counts, so the fleet merge is a plain sum
MESH_METRICS = (
    "chain_mesh_waves_total",
    "chain_mesh_wave_slots_total",
    "chain_mesh_recompiles_total",
    "chain_mesh_compile_seconds_total",
)
#: the observed/predicted audit histogram (same section)
COST_ERROR_METRIC = "chain_serve_cost_error_ratio"

#: percentiles the SLO report estimates from the merged buckets
PERCENTILES = (0.50, 0.95, 0.99)


# ------------------------------------------------------------ discovery


def discover_replicas(root: str) -> list[dict]:
    """Every serve-info document under `root` (top level only): any
    JSON file carrying both `url` and `replica` counts — the default
    `serve-info.json` and per-replica `--info-file`s alike. Stale files
    from dead generations stay listed (the probe marks them dead);
    replicas that re-registered under the same id keep only the
    newest file's claim."""
    infos: dict[str, dict] = {}
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(root, name)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or "url" not in doc \
                or "replica" not in doc:
            continue
        doc["info_file"] = name
        try:
            doc["info_mtime"] = os.stat(path).st_mtime
        except OSError:
            doc["info_mtime"] = 0.0
        prev = infos.get(doc["replica"])
        if prev is None or doc["info_mtime"] >= prev["info_mtime"]:
            infos[doc["replica"]] = doc
    return sorted(infos.values(), key=lambda d: d["replica"])


def _fetch(url: str, timeout_s: float) -> Optional[bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read()
    except (urllib.error.URLError, TimeoutError, OSError, ValueError):
        return None


# ----------------------------------------------------- prometheus parse

_PROM_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)$"
)
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _prom_samples(text: str) -> Iterable[tuple]:
    """(name, labels, value) per sample line of one /metrics render —
    the ONE place the line grammar, label unescaping and value parsing
    live; parse_histograms and parse_counters both consume it (an
    escaping fix must not have to land twice)."""
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line.strip())
        if m is None:
            continue
        labels = {k: v.replace('\\"', '"').replace("\\\\", "\\")
                  for k, v in _LABEL.findall(m.group("labels") or "")}
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        yield m.group("name"), labels, value


def parse_histograms(text: str, names: Iterable[str]) -> dict:
    """The named histograms out of one /metrics render. Returns
    {(name, labelitems): {"labels", "buckets" (cumulative, by le
    string), "sum", "count"}} where labelitems is the sorted tuple of
    (label, value) pairs excluding `le`."""
    wanted = set(names)
    out: dict = {}

    def entry(name: str, labels: dict) -> dict:
        key = (name, tuple(sorted(labels.items())))
        return out.setdefault(key, {
            "labels": labels, "buckets": {}, "sum": 0.0, "count": 0,
        })

    for name, labels, value in _prom_samples(text):
        base, _, suffix = name.rpartition("_")
        if base not in wanted or suffix not in ("bucket", "sum", "count"):
            continue
        if suffix == "bucket":
            le = labels.pop("le", "+Inf")
            entry(base, labels)["buckets"][le] = value
        elif suffix == "sum":
            entry(base, labels)["sum"] += value
        else:
            entry(base, labels)["count"] += int(value)
    return out


def parse_counters(text: str, names: Iterable[str]) -> dict:
    """The named counters (or gauges) out of one /metrics render:
    {(name, labelitems): {"labels", "value"}} — the counter sibling of
    `parse_histograms`, for the cost-accounting merge."""
    wanted = set(names)
    out: dict = {}
    for name, labels, value in _prom_samples(text):
        if name not in wanted:
            continue
        key = (name, tuple(sorted(labels.items())))
        entry = out.setdefault(key, {"labels": labels, "value": 0.0})
        entry["value"] += value
    return out


def merge_counters(parsed: Iterable[dict]) -> dict:
    """Sum per-replica counter parses (cumulative counts sum exactly,
    like the histogram merge)."""
    merged: dict = {}
    for one in parsed:
        for key, series in one.items():
            into = merged.setdefault(key, {
                "labels": dict(series["labels"]), "value": 0.0,
            })
            into["value"] += series["value"]
    return merged


def tier_report(parsed: list) -> dict:
    """The /fleet "store_tiers" section from each replica's tier
    metrics: per-tier hit counts merged by SUM (every replica's reads
    are distinct events) with fleet-wide hit ratios, promotion/demotion
    move counts likewise, and per-tier bytes merged by MAX — the gauge
    reports SHARED store state, so summing replicas would multiply one
    disk by the fleet size."""
    tiers: dict = {}
    for counters in parsed:
        for (name, _), entry in counters.items():
            tier = entry["labels"].get("tier", "?")
            t = tiers.setdefault(tier, {
                "hits": 0, "promotions": 0, "demotions": 0, "bytes": 0,
            })
            value = entry["value"]
            if name == "chain_store_tier_hits_total":
                t["hits"] += int(value)
            elif name == "chain_store_tier_promotions_total":
                t["promotions"] += int(value)
            elif name == "chain_store_tier_demotions_total":
                t["demotions"] += int(value)
            elif name == "chain_store_tier_bytes":
                t["bytes"] = max(t["bytes"], int(value))
    total_hits = sum(t["hits"] for t in tiers.values())
    for t in tiers.values():
        t["hit_ratio"] = (
            round(t["hits"] / total_hits, 4) if total_hits else 0.0)
    return {"tiers": tiers, "hits_total": total_hits}


def mesh_report(parsed: list) -> dict:
    """The /fleet "mesh" section from each replica's chain_mesh_*
    counters (parallel/meshobs.py): per geometry bucket, fleet-summed
    wave counts, the valid/pad slot split with the derived waste
    fraction, and the compile ledger (every replica compiles its own
    steps, so recompiles sum too). Empty buckets dict when no replica
    has dispatched a wave."""
    buckets: dict = {}
    for counters in parsed:
        for (name, _), entry in counters.items():
            bucket = entry["labels"].get("bucket", "?")
            b = buckets.setdefault(bucket, {
                "waves": 0, "valid": 0, "padded": 0,
                "recompiles": 0, "compile_s": 0.0,
            })
            value = entry["value"]
            if name == "chain_mesh_waves_total":
                b["waves"] += int(value)
            elif name == "chain_mesh_wave_slots_total":
                if entry["labels"].get("kind") == "valid":
                    b["valid"] += int(value)
                else:
                    b["padded"] += int(value)
            elif name == "chain_mesh_recompiles_total":
                b["recompiles"] += int(value)
            elif name == "chain_mesh_compile_seconds_total":
                b["compile_s"] = round(b["compile_s"] + value, 4)
    for b in buckets.values():
        total = b["valid"] + b["padded"]
        b["waste_fraction"] = (
            round(b["padded"] / total, 4) if total else 0.0)
    return {
        "buckets": buckets,
        "waves": sum(b["waves"] for b in buckets.values()),
        "recompiles": sum(b["recompiles"] for b in buckets.values()),
    }


def cost_report(counters: dict, error_hist: dict) -> dict:
    """The /fleet "cost" section from merged counters + the merged
    observed/predicted ratio histogram: per-tenant predicted/observed
    seconds, admission refusals by reason, and the model-error
    estimate. Empty sub-dicts when the fleet has no cost traffic."""
    tenants: dict = {}
    rejected: dict = {}
    for (name, _), series in sorted(counters.items()):
        if name == "chain_serve_cost_rejected_total":
            reason = series["labels"].get("reason", "?")
            rejected[reason] = rejected.get(reason, 0) \
                + int(series["value"])
            continue
        tenant = series["labels"].get("tenant", "")
        entry = tenants.setdefault(
            tenant, {"predicted_s": 0.0, "observed_s": 0.0}
        )
        if name == "chain_serve_cost_predicted_seconds_total":
            entry["predicted_s"] = round(
                entry["predicted_s"] + series["value"], 3)
        elif name == "chain_serve_cost_observed_seconds_total":
            entry["observed_s"] = round(
                entry["observed_s"] + series["value"], 3)
    error: Optional[dict] = None
    for (name, _), series in error_hist.items():
        if name != COST_ERROR_METRIC or not series["count"]:
            continue
        error = {
            "n": series["count"],
            "ratio_p50": percentile_from_buckets(series["buckets"], 0.50),
            "ratio_p95": percentile_from_buckets(series["buckets"], 0.95),
        }
    return {"tenants": tenants, "rejected": rejected,
            "model_error": error}


def merge_histograms(parsed: Iterable[dict]) -> dict:
    """Sum per-replica histogram parses (same shape in and out).
    Cumulative bucket counts sum to cumulative bucket counts, so no
    rebinning is needed — the replicas share one bucket layout by
    construction (the registry's defaults)."""
    merged: dict = {}
    for one in parsed:
        for key, series in one.items():
            into = merged.setdefault(key, {
                "labels": dict(series["labels"]),
                "buckets": {}, "sum": 0.0, "count": 0,
            })
            for le, c in series["buckets"].items():
                into["buckets"][le] = into["buckets"].get(le, 0.0) + c
            into["sum"] += series["sum"]
            into["count"] += series["count"]
    return merged


def percentile_exact(values: list, frac: float) -> Optional[float]:
    """Order-statistic percentile over RAW samples — the one formula
    the soak/chaos harnesses share (`percentile_from_buckets` below is
    the merged-histogram estimate; two private copies of this already
    drifted once). None on empty input."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(len(ordered) * frac))]


def _le_key(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def percentile_from_buckets(buckets: dict, frac: float) -> Optional[float]:
    """Upper-bound estimate of one quantile from cumulative bucket
    counts: the smallest bucket bound whose cumulative count covers
    `frac` of the observations. None when the histogram is empty; the
    largest FINITE bound stands in for +Inf (the estimate is then a
    floor, which is the honest direction for an SLO breach check)."""
    if not buckets:
        return None
    ordered = sorted(buckets.items(), key=lambda kv: _le_key(kv[0]))
    total = ordered[-1][1]
    if total <= 0:
        return None
    target = frac * total
    finite = [le for le, _ in ordered if le != "+Inf"]
    for le, cum in ordered:
        if cum >= target:
            if le == "+Inf":
                return _le_key(finite[-1]) if finite else None
            return _le_key(le)
    return _le_key(finite[-1]) if finite else None


def band_fraction(buckets: dict, band_s: float) -> Optional[float]:
    """Fraction of observations at or under `band_s`, estimated from
    the cumulative count of the first bucket bound ≥ the band (an
    over-estimate by at most one bucket width — documented next to the
    SLO tables)."""
    if not buckets:
        return None
    ordered = sorted(buckets.items(), key=lambda kv: _le_key(kv[0]))
    total = ordered[-1][1]
    if total <= 0:
        return None
    for le, cum in ordered:
        if _le_key(le) >= band_s:
            return cum / total
    return 1.0


def slo_report(merged: dict) -> dict:
    """Grade the merged phase histograms against catalog.SLO_BANDS.
    Returns {tenant: {priority: {phase: {count, p50, p95, p99, band_s,
    within_band, ok}}}} — `ok` is None when no band is declared for
    the flow's priority class."""
    report: dict = {}
    for (name, _), series in sorted(merged.items()):
        phase = next(
            (p for p, metric in PHASE_METRICS.items() if metric == name),
            None,
        )
        if phase is None:
            continue
        labels = series["labels"]
        tenant = labels.get("tenant", "")
        priority = labels.get("priority", "")
        cell: dict = {"count": series["count"]}
        for frac in PERCENTILES:
            est = percentile_from_buckets(series["buckets"], frac)
            cell[f"p{int(frac * 100)}"] = \
                round(est, 6) if est is not None else None
        band_s = catalog.SLO_BANDS.get(phase, {}).get(priority)
        cell["band_s"] = band_s
        if band_s is None:
            cell["within_band"] = None
            cell["ok"] = None
        else:
            within = band_fraction(series["buckets"], band_s)
            cell["within_band"] = \
                round(within, 4) if within is not None else None
            cell["ok"] = (
                None if within is None
                else within >= catalog.SLO_TARGET_FRACTION
            )
        report.setdefault(tenant, {}).setdefault(priority, {})[phase] = cell
    return report


def read_slo_report(merged: dict) -> dict:
    """slo_report's read-path sibling: grade the merged artifact-read
    histograms against catalog.READ_SLO_BANDS. Returns {tenant:
    {size_class: {phase: cell}}} with the same cell shape, so the
    fleet-top renderer formats both reports through one code path."""
    report: dict = {}
    for (name, _), series in sorted(merged.items()):
        phase = next(
            (p for p, metric in READ_PHASE_METRICS.items()
             if metric == name),
            None,
        )
        if phase is None:
            continue
        labels = series["labels"]
        tenant = labels.get("tenant", "")
        size_class = labels.get("size_class", "")
        cell: dict = {"count": series["count"]}
        for frac in PERCENTILES:
            est = percentile_from_buckets(series["buckets"], frac)
            cell[f"p{int(frac * 100)}"] = \
                round(est, 6) if est is not None else None
        band_s = catalog.READ_SLO_BANDS.get(phase, {}).get(size_class)
        cell["band_s"] = band_s
        if band_s is None:
            cell["within_band"] = None
            cell["ok"] = None
        else:
            within = band_fraction(series["buckets"], band_s)
            cell["within_band"] = \
                round(within, 4) if within is not None else None
            cell["ok"] = (
                None if within is None
                else within >= catalog.SLO_TARGET_FRACTION
            )
        report.setdefault(tenant, {}).setdefault(
            size_class, {})[phase] = cell
    return report


# ------------------------------------------------------- durable truth


def _counts_from_dir(path: str, state_key: str) -> dict:
    counts: dict = {}
    try:
        names = os.listdir(path)
    except OSError:
        return counts
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(path, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        state = doc.get(state_key, "?")
        counts[state] = counts.get(state, 0) + 1
    return counts


def queue_counts(root: str) -> dict:
    return _counts_from_dir(os.path.join(root, "queue", "jobs"), "state")


def request_counts(root: str) -> dict:
    return _counts_from_dir(os.path.join(root, "requests"), "state")


# ----------------------------------------------------------- fleet view


def fleet_view(root: str, timeout_s: float = 2.0) -> dict:
    """The merged fleet document `/fleet` serves and `tools fleet-top`
    renders. Probes every discovered replica; dead ones are reported
    with `alive: false` and the rest of the view still builds from the
    shared durable state."""
    root = os.path.abspath(root)
    replicas: list[dict] = []
    parsed: list[dict] = []
    parsed_counters: list[dict] = []
    parsed_tiers: list[dict] = []
    parsed_mesh: list[dict] = []
    infos = discover_replicas(root)
    for info in infos:
        entry = {
            "replica": info.get("replica"),
            "replica_epoch": info.get("replica_epoch"),
            "pid": info.get("pid"),
            "url": info.get("url"),
            "info_file": info.get("info_file"),
            "alive": False,
        }
        raw = _fetch(info["url"].rstrip("/") + "/status", timeout_s)
        if raw is not None:
            try:
                status = json.loads(raw.decode())
            except ValueError:
                status = None
            if status is not None:
                entry["alive"] = True
                entry["status"] = "ok"
                serve = status.get("serve", {})
                entry["replica_epoch"] = serve.get(
                    "replica_epoch", entry["replica_epoch"])
                entry["pid"] = serve.get("pid", entry["pid"])
                entry["queue"] = serve.get("queue", {})
                entry["requests"] = serve.get("requests", {})
                entry["executor"] = serve.get("executor")
                entry["uptime_s"] = status.get("uptime_s")
                entry["stalls"] = serve.get("stalls") or []
                entry["cost_calibration"] = (
                    serve.get("cost") or {}
                ).get("calibration")
                rss = (status.get("resources") or {}).get("rss_bytes")
                if rss:
                    entry["rss_bytes"] = rss
        if entry["alive"]:
            text = _fetch(info["url"].rstrip("/") + "/metrics", timeout_s)
            if text is not None:
                rendered = text.decode(errors="replace")
                parsed.append(parse_histograms(
                    rendered,
                    [*PHASE_METRICS.values(),
                     *READ_PHASE_METRICS.values(), COST_ERROR_METRIC],
                ))
                parsed_counters.append(
                    parse_counters(rendered, COST_COUNTERS)
                )
                parsed_tiers.append(
                    parse_counters(rendered, TIER_METRICS)
                )
                parsed_mesh.append(
                    parse_counters(rendered, MESH_METRICS)
                )
        else:
            # a journal directory that exists while its process stopped
            # answering is not "silently absent" — it is STALE, graded
            # with its last-seen age (the serve-info's mtime) so
            # alerting can tell "quiet" from "gone"
            # (catalog.ALERT_RULES fleet_replica_stale)
            entry["error"] = "unreachable"
            entry["status"] = "stale"
            mtime = info.get("info_mtime")
            if mtime:
                entry["last_seen_s"] = round(
                    max(0.0, time.time() - float(mtime)), 1)
        replicas.append(entry)
    merged_hists = merge_histograms(parsed)
    # the store root each replica declared in its serve-info (the serve
    # daemon may be pointed at a shared store outside the serve root);
    # newest registration wins, default to the conventional layout
    store_root = os.path.join(root, "store")
    for info in sorted(infos, key=lambda d: d.get("info_mtime", 0.0)):
        if info.get("store"):
            store_root = info["store"]
    return {
        "schema": 1,
        "generated_at": round(time.time(), 3),
        "root": root,
        "replicas": replicas,
        "alive": sum(1 for r in replicas if r["alive"]),
        "queue": queue_counts(root),
        "requests": request_counts(root),
        "slo": slo_report(merged_hists),
        "slo_bands": catalog.SLO_BANDS,
        # artifact read-path grades per (tenant × size class) — the
        # TTFB/full-stream histograms of serve/service.py's
        # /v1/artifacts handler, merged like the phase histograms
        "read_slo": read_slo_report(merged_hists),
        "read_slo_bands": catalog.READ_SLO_BANDS,
        # tail-sampled heat-ledger summary (store/heat.py): read/304/
        # regret/eviction counts over the fleet's journals
        "heat": store_heat.journal_stats(store_heat.heat_dir(store_root)),
        # per-tier placement: fleet-merged hit counts/ratios and move
        # totals (store/tiers.py; docs/STORE.md "Tier hierarchy") —
        # empty tiers dict for single-tier fleets
        "store_tiers": tier_report(parsed_tiers),
        # device-plane wave occupancy/waste/compile ledger, summed over
        # live replicas (parallel/meshobs.py; docs/PERF.md "My waves
        # are wasteful") — empty buckets dict until a wave dispatches
        "mesh": mesh_report(parsed_mesh),
        # per-tenant predicted/observed seconds + admission refusals,
        # merged across replicas (serve/cost.py)
        "cost": {
            **cost_report(merge_counters(parsed_counters), merged_hists),
            # per-replica prediction-scale calibration (serve/cost.py
            # --cost-calibrate): per host, never merged — each replica
            # runs its own hardware
            "calibration": {
                r["replica"]: r["cost_calibration"]
                for r in replicas if r.get("cost_calibration")
            },
        },
        # tail-sampled on purpose: the journals are unbounded
        # append-only history and /fleet refreshes every few seconds
        "spans": serve_spans.journal_stats(
            os.path.join(root, "queue", "spans")),
        # active watchdog stall episodes, labelled with the replica
        # that reported each (telemetry/watchdog.py active_stalls —
        # satellite of the alerting plane: a stalled task is visible
        # fleet-wide, not just in its own process)
        "stalls": [
            {**stall, "replica": r["replica"]}
            for r in replicas for stall in r.get("stalls") or []
        ],
        # burn-rate alerts still firing (telemetry/alerts.py) — the
        # full lifecycle lives at /fleet/alerts; this is the summary
        # fleet-top renders and the control loop's own engines read
        "alerts": {
            "active": alerts_mod.active_alerts(root),
            "journal": alerts_mod.journal_stats(
                alerts_mod.alerts_dir(root)),
        },
        # the newest journaled autoscale recommendation
        # (serve/autoscale.py; live signal at /fleet/scale-signal)
        "scale": alerts_mod.latest_scale(root),
    }


# -------------------------------------------------------- trace stitch


def _load_request_doc(root: str, request_id: str) -> Optional[dict]:
    path = os.path.join(root, "requests", request_id + ".json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def resolve_request_ids(root: str, ref: str) -> list[str]:
    """`ref` may be a request id or a trace id; returns EVERY matching
    request id, submit-ordered. More than one is legitimate: a
    client-supplied gateway trace can ride several POSTs, and showing
    only an arbitrary one would claim 'COMPLETE' while hiding the
    rest — the trace of a shared id is all of its requests."""
    if _load_request_doc(root, ref) is not None:
        return [ref]
    req_dir = os.path.join(root, "requests")
    try:
        names = os.listdir(req_dir)
    except OSError:
        return []
    matches: list[tuple] = []
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(req_dir, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if doc.get("trace") == ref:
            matches.append((doc.get("created_at", 0.0),
                            doc.get("request")))
    return [req for _, req in sorted(matches) if req]


def assemble_trace(root: str, request_id: str) -> dict:
    """The cross-replica timeline of one request: its doc, every span
    that names it (merged over all replica journals), the per-job
    chains, and the gapless-completeness verdict for terminal jobs.
    Works from durable state only — no replica needs to be alive."""
    root = os.path.abspath(root)
    doc = _load_request_doc(root, request_id)
    all_spans = serve_spans.read_journals(
        os.path.join(root, "queue", "spans"))
    # which JOBS answer this request: any span naming it (enqueue,
    # attach, or a later transition carrying the merged request list)
    # OR a durable record listing it — then take each such job's FULL
    # chain. A singleflight attach joins a record mid-flight, so the
    # spans from before the join (its enqueue, an earlier claim) do
    # not name this request yet they ARE its history.
    job_ids = {s.get("job", "?")
               for s in serve_spans.spans_for_request(all_spans,
                                                      request_id)}
    records: dict[str, dict] = {}
    jobs_dir = os.path.join(root, "queue", "jobs")
    try:
        names = os.listdir(jobs_dir)
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".json"):
            continue  # lease sentinels (*.json.inprogress) included
        try:
            with open(os.path.join(jobs_dir, name)) as f:
                record = json.load(f)
        except (OSError, ValueError):
            continue
        if record.get("job") in job_ids or \
                request_id in (record.get("requests") or ()):
            records[record["job"]] = record
            job_ids.add(record["job"])
    jobs: dict[str, list] = {j: [] for j in job_ids}
    for span in all_spans:
        if span.get("job") in job_ids:
            jobs[span["job"]].append(span)
    for chain in jobs.values():
        chain.sort(key=lambda s: (s.get("ts", 0.0), s.get("seq", 0)))
    violations: list[str] = []
    for job_id, chain in sorted(jobs.items()):
        record = records.get(job_id)
        if record is not None:
            violations.extend(serve_spans.verify_chain(
                [s for s in chain if s.get("phase") != "fenced"], record))
    units: dict[str, dict] = {}
    warm_units = 0
    if doc:
        span_plans = {s.get("plan") for chain in jobs.values()
                      for s in chain}
        for pvs_id, unit in (doc.get("units") or {}).items():
            entry = {"plan": unit.get("plan")}
            if unit.get("plan") not in span_plans:
                # no queue traffic at all: answered warm at submit
                entry["warm"] = True
                warm_units += 1
            units[pvs_id] = entry
    t0 = min((s.get("ts", 0.0) for chain in jobs.values() for s in chain),
             default=(doc or {}).get("created_at", 0.0))
    return {
        "request": request_id,
        "trace": (doc or {}).get("trace"),
        "found": doc is not None or bool(jobs),
        "state": (doc or {}).get("state"),
        "tenant": (doc or {}).get("tenant"),
        "priority": (doc or {}).get("priority"),
        "created_at": (doc or {}).get("created_at"),
        "done_at": (doc or {}).get("done_at"),
        "latency_ms": (doc or {}).get("latency_ms"),
        "t0": t0,
        "units": units,
        "warm_units": warm_units,
        "jobs": jobs,
        "records": {j: {"state": r.get("state"),
                        "epoch": r.get("epoch"),
                        "settledEpoch": r.get("settledEpoch"),
                        "owner": r.get("owner"),
                        "unit": (r.get("unit") or {}).get("pvs_id")}
                    for j, r in records.items()},
        "complete": not violations,
        "violations": violations,
    }


class _TraceSpan:
    """profiling.build_chrome_trace's span shape (name/thread/start/
    duration/meta), synthesized from journal intervals."""

    __slots__ = ("name", "thread", "start", "duration", "meta")

    def __init__(self, name: str, thread: str, start: float,
                 duration: float, meta: Optional[dict] = None) -> None:
        self.name = name
        self.thread = thread
        self.start = start
        self.duration = duration
        self.meta = meta or {}


def chrome_trace(trace: dict) -> dict:
    """One request's stitched timeline as Chrome-trace JSON, through
    the SAME trace writer the profiler uses (telemetry/profiling.
    build_chrome_trace) so the clock/format conventions stay single-
    sourced. Replicas render as threads; claim→settle intervals are
    complete spans; enqueue/steal/fenced show as zero-width marks."""
    from .profiling import build_chrome_trace

    t0 = trace.get("t0", 0.0)
    spans: list[_TraceSpan] = []
    for job_id, chain in sorted(trace.get("jobs", {}).items()):
        unit = (trace.get("records", {}).get(job_id) or {}).get("unit") \
            or job_id
        open_claim: Optional[dict] = None
        for span in chain:
            ts = span.get("ts", t0) - t0
            phase = span.get("phase")
            replica = span.get("replica", "?")
            if phase == "claim":
                open_claim = span
                continue
            if phase in ("complete", "fail", "quarantine", "requeue",
                         "revert") and open_claim is not None:
                start = open_claim.get("ts", t0) - t0
                spans.append(_TraceSpan(
                    name=f"{unit} [e{span.get('epoch')}] {phase}",
                    thread=replica, start=start,
                    duration=max(1e-6, ts - start),
                    meta={"job": job_id, "phase": phase,
                          "epoch": span.get("epoch", 0)},
                ))
                open_claim = None
                continue
            spans.append(_TraceSpan(
                name=f"{unit} {phase}", thread=replica, start=ts,
                duration=1e-6,
                meta={"job": job_id, "phase": phase or "?",
                      "epoch": span.get("epoch", 0)},
            ))
        if open_claim is not None:
            # claim with no observed end: the owner died mid-wave and
            # nothing has stolen it yet — render the open interval
            start = open_claim.get("ts", t0) - t0
            spans.append(_TraceSpan(
                name=f"{unit} [e{open_claim.get('epoch')}] unsettled",
                thread=open_claim.get("replica", "?"), start=start,
                duration=1e-6,
                meta={"job": job_id, "phase": "claim-open",
                      "epoch": open_claim.get("epoch", 0)},
            ))
    doc = build_chrome_trace(spans)
    doc["otherData"] = {
        "producer": "processing_chain_tpu_torch tools trace",
        "request": trace.get("request"),
        "trace": trace.get("trace"),
    }
    return doc
