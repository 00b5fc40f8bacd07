"""`tools fleet-doctor` — cross-plane incident correlation.

The flight recorders each journal their own plane: serve spans
(queue/spans), store heat (store/heat), mesh occupancy (meshobs) and
now the alert lifecycle (alerts/). When an alert fires, the question
is never "did it fire" — it is *what else was happening*. fleet-doctor
joins all four journal planes on one time axis and renders the
incident window around any alert:

    python -m processing_chain_tpu_torch tools fleet-doctor al-r1-0001 --root DIR
    python -m processing_chain_tpu_torch tools fleet-doctor 'slo_burn_queue_wait{...}' \\
        --root DIR --window-s 30 --chrome incident.json

A bare `--root DIR` (no alert ref) lists the alerts on record. The
`--chrome` export writes a Chrome-trace (chrome://tracing /
ui.perfetto.dev) file: one track per plane, alert episodes as
duration events spanning fired→resolved.

`--soak` runs the SLO-breach proof harness instead: an in-process
replica fleet is driven through a healthy control phase (zero alerts
must fire), an injected breach (an interactive flood against one slow
worker per replica + an undersized hot tier; the declared burn-rate
and regret alerts must fire, and the scale signal must recommend up),
a replica loss (the stale-replica rule must fire), and a recovery
(every alert must resolve, the scale signal must return to steady).
The one-line JSON report is the committed `ALERTS_r20.json` evidence;
exit is nonzero on any violated invariant.

    python -m processing_chain_tpu_torch tools fleet-doctor --soak
        [--root DIR] [--out FILE]

The port's copy of processing_chain_tpu/tools/fleet_doctor.py.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

from ..telemetry import alerts as alerts_mod
from ..utils.fsio import atomic_write_json, atomic_write_text
from ..utils.log import get_logger

#: every burn window/threshold/hold in the soak is the production
#: declaration times this — hours of SRE windows compressed into
#: seconds without forking the rules (telemetry/alerts.py)
SOAK_WINDOW_SCALE = 0.001


# ------------------------------------------------------------ gathering


def gather_planes(root: str) -> list[dict]:
    """Every journal record of every plane under one serve root, each
    tagged with its `plane`, merged onto one (ts, replica, seq) axis."""
    from ..parallel import meshobs
    from ..serve import spans as serve_spans
    from ..store import heat as store_heat

    records: list[dict] = []
    for plane, recs in (
        ("spans", serve_spans.read_journals(
            os.path.join(root, "queue", "spans"))),
        ("heat", store_heat.read_journals(
            store_heat.heat_dir(os.path.join(root, "store")))),
        ("mesh", meshobs.read_journals(meshobs.mesh_dir(root))),
        ("alerts", alerts_mod.read_journals(alerts_mod.alerts_dir(root))),
    ):
        for rec in recs:
            records.append({"plane": plane, **rec})
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("replica", ""),
                                r.get("seq", 0)))
    return records


def _summarize(rec: dict) -> str:
    """One render line per record, per plane dialect."""
    plane = rec.get("plane")
    if plane == "spans":
        extra = ""
        if rec.get("queue_wait_s") is not None:
            extra = f" wait={rec['queue_wait_s']:.3f}s"
        elif rec.get("exec_s") is not None:
            extra = f" exec={rec['exec_s']:.3f}s"
        return (f"{rec.get('phase', '?')} job={rec.get('job', '?')} "
                f"state={rec.get('state', '?')}{extra}")
    if plane == "heat":
        kind = rec.get("kind", "?")
        plan = (rec.get("plan") or "?")[:12]
        if kind == "read":
            return f"read plan={plan} mode={rec.get('mode')} " \
                   f"bytes={rec.get('bytes', 0)}"
        if kind == "evict":
            return f"EVICT plan={plan} bytes={rec.get('bytes', 0)}"
        if kind == "regret":
            return f"REGRET plan={plan} via={rec.get('via')} " \
                   f"evicted_ago_s={rec.get('evicted_ago_s')}"
        return f"{kind} plan={plan}"
    if plane == "mesh":
        return (f"{rec.get('kind', '?')} bucket={rec.get('bucket', '?')} "
                f"valid={rec.get('valid', '?')}/"
                f"{rec.get('dispatched', '?')}")
    if plane == "alerts":
        kind = rec.get("kind", "?")
        if kind == "scale":
            return (f"SCALE {rec.get('current')}->{rec.get('desired')} "
                    f"[{','.join(rec.get('reasons') or [])}]")
        label = {"fired": "FIRED", "resolved": "RESOLVED",
                 "renotify": "renotify"}.get(kind, kind)
        tail = rec.get("reason") or rec.get("alert") or ""
        return f"{label} {rec.get('rule', '?')} id={rec.get('id')}  {tail}"
    return json.dumps(rec, sort_keys=True)[:120]


def render_incident(root: str, ref: str,
                    window_s: float = 30.0) -> Optional[dict]:
    """The incident document around one alert: the folded alert state,
    every journal record (all planes) inside [fired - window_s,
    resolved/last + window_s], and the rendered text timeline."""
    anchor = alerts_mod.find_alert(root, ref)
    if anchor is None:
        return None
    t_fire = anchor.get("fired_ts") or 0.0
    t_end = anchor.get("resolved_ts") or anchor.get("last_ts") or t_fire
    lo, hi = t_fire - window_s, t_end + window_s
    records = [r for r in gather_planes(root)
               if lo <= r.get("ts", 0.0) <= hi]
    lines = [
        f"incident {anchor.get('id')}  {anchor.get('alert')}",
        f"  fired    {_stamp(t_fire)}   "
        f"severity={anchor.get('severity')}",
        (f"  resolved {_stamp(anchor['resolved_ts'])}   "
         f"after {anchor.get('duration_s')}s"
         if anchor.get("resolved_ts") else "  still firing"),
        f"  window   ±{window_s:g}s, {len(records)} records across "
        f"{len({r['plane'] for r in records})} planes",
        "",
    ]
    for rec in records:
        dt = rec.get("ts", 0.0) - t_fire
        mark = ">>" if rec.get("plane") == "alerts" else "  "
        lines.append(
            f"{mark} {dt:+9.3f}s [{rec['plane']:<6}] "
            f"{rec.get('replica', '?'):<12} {_summarize(rec)}"
        )
    return {"alert": {k: v for k, v in anchor.items() if k != "records"},
            "window_s": window_s, "records": records,
            "planes": sorted({r["plane"] for r in records}),
            "text": "\n".join(lines)}


def _stamp(ts: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(ts)) \
        + f".{int((ts % 1) * 1000):03d}"


def chrome_trace(incident: dict) -> dict:
    """Chrome-trace export: one track (tid) per plane, instant events
    for journal records, a duration event for the alert episode."""
    events: list[dict] = []
    tids = {"alerts": 0, "spans": 1, "heat": 2, "mesh": 3}
    for rec in incident["records"]:
        events.append({
            "name": _summarize(rec)[:80],
            "cat": rec["plane"],
            "ph": "i", "s": "t",
            "ts": rec.get("ts", 0.0) * 1e6,
            "pid": 1, "tid": tids.get(rec["plane"], 9),
            "args": {k: v for k, v in rec.items()
                     if k not in ("plane",) and not isinstance(v, (dict,
                                                                   list))},
        })
    alert = incident["alert"]
    t0 = alert.get("fired_ts") or 0.0
    t1 = alert.get("resolved_ts") or alert.get("last_ts") or t0
    events.append({
        "name": alert.get("alert", "alert"),
        "cat": "alerts", "ph": "X",
        "ts": t0 * 1e6, "dur": max(1.0, (t1 - t0) * 1e6),
        "pid": 1, "tid": tids["alerts"],
        "args": {"id": alert.get("id"), "rule": alert.get("rule"),
                 "severity": alert.get("severity")},
    })
    for plane, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": plane}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ------------------------------------------------------------- the soak


def _submit(service, i: int, *, tenant: str = "soak",
            priority: str = "interactive", work_ms: int = 5,
            size_bytes: int = 512, base: int = 10_000) -> str:
    """One single-unit request; a distinct (base + i) means a distinct
    plan, a repeated one re-requests the same plan (the regret path)."""
    doc = service.submit({
        "tenant": tenant, "priority": priority, "database": "P2STR01",
        "srcs": [f"SRC{base + i:05d}"], "hrcs": ["HRC100"],
        "params": {"geometry": [64, 36], "work_ms": work_ms,
                   "size_bytes": size_bytes},
    })
    return doc["request"]


def _wait_requests(service, req_ids: list, timeout: float) -> list:
    return [r for r in req_ids
            if service.wait_request(r, timeout=timeout) != "done"]


def _fired_rules(root: str) -> dict:
    """rule -> fired-record count, from the durable journals."""
    out: dict = {}
    for rec in alerts_mod.read_journals(alerts_mod.alerts_dir(root)):
        if rec.get("kind") == "fired":
            out[rec.get("rule")] = out.get(rec.get("rule"), 0) + 1
    return out


def _wait_for(predicate, timeout_s: float, poll_s: float = 0.2) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll_s)
    return bool(predicate())


def run_soak(args) -> int:
    """The breach harness (module doc). Control and breach run under
    separate roots so "zero alerts in the healthy fleet" is provable
    from a journal that the breach never touches."""
    from ..serve.service import ChainServeService

    log = get_logger()
    base = args.root or tempfile.mkdtemp(prefix="chain-alert-soak-")
    os.makedirs(base, exist_ok=True)
    report: dict = {"soak": "alerts", "window_scale": SOAK_WINDOW_SCALE,
                    "root": base, "phases": {}}
    failures: list[str] = []

    # ---- phase 1: healthy control — the fleet at rest must be silent
    control_root = os.path.join(base, "control")
    svc = ChainServeService(
        control_root, port=0, workers=2, wave_width=2, poll_s=0.1,
        control_interval_s=0.15, alert_window_scale=SOAK_WINDOW_SCALE,
        replica="ctl-a",
    ).start()
    try:
        reqs = [_submit(svc, i, base=10_000) for i in range(6)]
        stuck = _wait_requests(svc, reqs, timeout=30.0)
        if stuck:
            failures.append(f"control: requests never completed: {stuck}")
        time.sleep(1.0)  # several control ticks over the settled fleet
        svc._control_tick(force=True)
    finally:
        svc.stop()
    control_fired = _fired_rules(control_root)
    report["phases"]["control"] = {
        "requests": 6, "alerts_fired": control_fired,
        "scale": alerts_mod.latest_scale(control_root),
    }
    if control_fired:
        failures.append(
            f"control: alerts fired in a healthy fleet: {control_fired}")

    # ---- phase 2: breach — interactive flood on slow workers + an
    # undersized hot tier. Replica A grades (fast control ticks);
    # replica B only serves, so the dedup contract stays checkable
    # against a single grader.
    root = os.path.join(base, "fleet")
    svc_a = ChainServeService(
        root, port=0, workers=1, wave_width=1, poll_s=0.1,
        control_interval_s=0.15, alert_window_scale=SOAK_WINDOW_SCALE,
        store_budget_bytes=90_000, replica="soak-a",
        info_path=os.path.join(root, "serve-info-a.json"),
    ).start()
    svc_b = ChainServeService(
        root, port=0, workers=1, wave_width=1, poll_s=0.1,
        control_interval_s=1e9, alert_window_scale=SOAK_WINDOW_SCALE,
        store_budget_bytes=90_000, replica="soak-b",
        info_path=os.path.join(root, "serve-info-b.json"),
    ).start()
    expected = {"slo_burn_queue_wait", "store_eviction_regret",
                "fleet_replica_stale"}
    tolerated = expected | {"slo_burn_e2e", "slo_burn_execution"}
    breach_reqs: list = []
    try:
        # the flood: 36 distinct ~250 ms interactive units against two
        # single-worker replicas — later claims wait far past the
        # 2.5 s interactive queue-wait band
        for i in range(36):
            breach_reqs.append(_submit(
                svc_a, i, base=20_000, work_ms=250, size_bytes=30_000))
        burn_seen = _wait_for(
            lambda: "slo_burn_queue_wait" in _fired_rules(root),
            timeout_s=30.0)
        if not burn_seen:
            failures.append(
                "breach: slo_burn_queue_wait never fired under a "
                "sustained interactive queue-wait breach")
        stuck = _wait_requests(svc_a, breach_reqs, timeout=60.0)
        if stuck:
            failures.append(f"breach: flood never drained: {stuck}")
        # hot-tier pressure: the 30 kB artifacts blew the 90 kB budget
        # long ago; force the GC pass, then re-request early plans —
        # rebuilds of recently-evicted bytes are REGRET
        svc_a.pressure.maybe_collect(force=True)
        # params must MATCH the flood's exactly: a different work_ms is
        # a different plan hash, not a rebuild of the evicted artifact
        regret_reqs = [_submit(svc_a, i, base=20_000, work_ms=250,
                               size_bytes=30_000) for i in range(4)]
        _wait_requests(svc_a, regret_reqs, timeout=30.0)
        regret_seen = _wait_for(
            lambda: "store_eviction_regret" in _fired_rules(root),
            timeout_s=20.0)
        if not regret_seen:
            failures.append(
                "breach: store_eviction_regret never fired after "
                "evicted plans were re-requested")
        # scale evidence from the durable journal: some record during
        # the breach must have recommended up, for a breach reason
        scale_records = [
            r for r in alerts_mod.read_journals(alerts_mod.alerts_dir(root))
            if r.get("kind") == "scale"]
        scale_up = next(
            (r for r in scale_records
             if r.get("desired", 0) > r.get("current", 0)
             and ({"queue_wait_burn", "backlog_pressure"}
                  & set(r.get("reasons") or []))), None)
        report["phases"]["breach"] = {
            "requests": len(breach_reqs),
            "alerts_fired": _fired_rules(root),
            "active": [a.get("alert") for a in
                       alerts_mod.active_alerts(root)],
            "scale": scale_up,
        }
        if scale_up is None:
            failures.append(
                "breach: no scale record recommended up for a breach "
                f"reason; records: {scale_records}")

        # ---- phase 3: replica loss — stop B but leave its serve-info
        # registration; the fleet view grades it stale and the
        # fleet_replica_stale rule pages
        svc_b.stop()
        stale_seen = _wait_for(
            lambda: "fleet_replica_stale" in _fired_rules(root),
            timeout_s=20.0)
        if not stale_seen:
            failures.append(
                "stale: fleet_replica_stale never fired for the "
                "stopped replica")
        report["phases"]["stale"] = {
            "alerts_fired": _fired_rules(root)}

        # ---- phase 4: recovery — deregister the dead replica, feed
        # healthy in-band traffic until every alert resolves and the
        # scale signal returns to steady
        try:
            os.unlink(os.path.join(root, "serve-info-b.json"))
        except OSError:
            pass

        healthy_seq = iter(range(10_000))

        def _all_resolved() -> bool:
            # fresh in-band observations push the burn windows back
            # under threshold; fresh plans never regret
            for _ in range(2):
                rid = _submit(svc_a, next(healthy_seq), base=30_000,
                              work_ms=5)
                svc_a.wait_request(rid, timeout=10.0)
            return not alerts_mod.active_alerts(root)

        recovered = _wait_for(_all_resolved, timeout_s=60.0, poll_s=0.1)
        if not recovered:
            failures.append(
                "recovery: alerts still firing after the fault "
                "cleared: "
                f"{[a.get('alert') for a in alerts_mod.active_alerts(root)]}")
        svc_a._control_tick(force=True)
        scale_after = svc_a.autoscale.latest()
        report["phases"]["recovery"] = {
            "resolved": recovered, "scale": scale_after}
        if scale_after and scale_after.get("replicas_desired", 99) > \
                scale_after.get("replicas_current", 1):
            failures.append(
                f"recovery: scale signal still recommends up: "
                f"{scale_after}")
    finally:
        svc_a.stop()

    # ---- invariants over the durable journals
    fired = _fired_rules(root)
    missing = sorted(expected - set(fired))
    unexpected = sorted(set(fired) - tolerated)
    if missing:
        failures.append(f"expected alerts never fired: {missing}")
    if unexpected:
        failures.append(f"unexpected alerts fired: {unexpected}")
    records = alerts_mod.read_journals(alerts_mod.alerts_dir(root))
    ids = [r.get("id") for r in records if r.get("kind") == "fired"]
    if len(ids) != len(set(ids)):
        failures.append("alert ids are not unique across the journals")
    # dedup/lifecycle: per key the journal must read fired →
    # (renotify)* → resolved, repeating — a second `fired` while an
    # episode is open is exactly the duplicate the dedup keys exist
    # to prevent
    by_key: dict = {}
    for rec in records:
        if rec.get("kind") in ("fired", "renotify", "resolved"):
            by_key.setdefault(rec.get("alert"), []).append(rec)
    for key, episode in sorted(by_key.items()):
        open_ = False
        for rec in episode:
            kind = rec.get("kind")
            if kind == "fired":
                if open_:
                    failures.append(
                        f"dedup violated: {key} re-fired while firing")
                open_ = True
            elif kind in ("renotify", "resolved"):
                if not open_:
                    failures.append(
                        f"lifecycle violated: {key} {kind} without an "
                        "open episode")
                if kind == "resolved":
                    open_ = False
        if open_:
            failures.append(f"alert never resolved: {key}")
    folded = alerts_mod.fold(records)
    report["alerts"] = {
        "fired": fired,
        "lifecycle": {k: {"state": v.get("state"),
                          "episodes": v.get("episodes"),
                          "duration_s": v.get("duration_s")}
                      for k, v in sorted(folded.items())},
    }

    # ---- the cross-plane incident render must join ≥2 planes
    burn_id = next(
        (rec.get("id") for rec in
         alerts_mod.read_journals(alerts_mod.alerts_dir(root))
         if rec.get("kind") == "fired"
         and rec.get("rule") == "slo_burn_queue_wait"), None)
    if burn_id:
        incident = render_incident(root, burn_id, window_s=10.0)
        if incident is None:
            failures.append(f"fleet-doctor cannot find alert {burn_id}")
        else:
            report["incident"] = {
                "id": burn_id, "planes": incident["planes"],
                "records": len(incident["records"]),
            }
            if len(incident["planes"]) < 2:
                failures.append(
                    "incident render joined fewer than 2 planes: "
                    f"{incident['planes']}")
            print(incident["text"])
    else:
        failures.append("no slo_burn_queue_wait fired record to render")

    report["failures"] = failures
    report["ok"] = not failures
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        atomic_write_text(args.out, line + "\n")
    if failures:
        for f in failures:
            log.error("alert-soak: %s", f)
        return 1
    log.info("alert-soak: OK — %s fired and resolved, scale signal "
             "up under breach, steady after", sorted(fired))
    return 0


# ------------------------------------------------------------------ CLI


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools fleet-doctor",
        description="cross-plane incident correlation + the SLO-breach "
                    "soak (docs/TELEMETRY.md \"Alerting & the scale "
                    "signal\")",
    )
    parser.add_argument("alert", nargs="?", default=None,
                        help="alert id (al-…) or dedup key to render; "
                             "omit to list the alerts on record")
    parser.add_argument("--root", default=None,
                        help="serve root (required unless --soak picks "
                             "a temp dir)")
    parser.add_argument("--window-s", type=float, default=30.0,
                        help="seconds of context either side of the "
                             "alert episode")
    parser.add_argument("--chrome", default=None, metavar="FILE",
                        help="also write a Chrome-trace export of the "
                             "incident window")
    parser.add_argument("--json", action="store_true",
                        help="print the incident document as JSON "
                             "instead of the text timeline")
    parser.add_argument("--soak", action="store_true",
                        help="run the SLO-breach proof harness")
    parser.add_argument("--out", default=None,
                        help="(--soak) also write the JSON report here")
    args = parser.parse_args(list(argv) if argv is not None else None)

    if args.soak:
        return run_soak(args)
    if not args.root:
        parser.error("--root is required (or use --soak)")
    if args.alert is None:
        doc = alerts_mod.alerts_report(args.root)
        for section in ("active", "resolved"):
            for a in doc.get(section, []):
                print(f"{a.get('id', '?'):<16} {section:<9} "
                      f"{a.get('alert')}")
        if not doc.get("active") and not doc.get("resolved"):
            print("(no alerts on record)")
        return 0
    incident = render_incident(args.root, args.alert,
                               window_s=args.window_s)
    if incident is None:
        get_logger().error("fleet-doctor: no alert matching %r under %s",
                           args.alert, args.root)
        return 1
    if args.chrome:
        atomic_write_json(args.chrome, chrome_trace(incident))
    if args.json:
        print(json.dumps({k: v for k, v in incident.items()
                          if k != "text"}, sort_keys=True))
    else:
        print(incident["text"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
