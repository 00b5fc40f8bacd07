"""Burn-rate alerting: the watcher over every flight recorder.

The fleet records everything — request spans with SLO histograms,
artifact-plane heat/regret journals, device-plane wave/compile
journals — but until this module nothing *watched* the recorders: a
breached read SLO was only visible if an operator happened to run
fleet-top. The `AlertEngine` closes that gap. Each replica's service
maintenance tick hands it the merged fleet view (telemetry/fleet.py)
and it grades every rule declared in `telemetry/catalog.py
ALERT_RULES`:

  * **SLO burn rules** are multi-window multi-burn-rate (the SRE
    shape): per (tenant × class) flow the engine snapshots the
    cumulative (count, in-band) pair from the fleet-merged histograms
    and computes the error-budget burn rate over each declared window
    pair (`catalog.BURN_RATE_WINDOWS`: fast 5m/1h pages, slow 30m/6h
    tickets). A pair trips only when BOTH its windows burn — the short
    window makes the alert fast to fire and fast to resolve, the long
    window keeps one bad minute from paging.
  * **Cross-plane rules** watch the other recorders: active watchdog
    stall/hard-timeout episodes, eviction-regret records accruing
    inside the fast window (store/heat.py — the cache is undersized),
    mesh geometry buckets wasting past the fragmentation threshold
    (parallel/meshobs.py), and replicas gone `stale` (serve-info on
    disk, process not answering).

Fire/resolve transitions are durable journal records under the
spans/heat/meshobs discipline — append-only per-replica JSONL with
torn-tail sealing, never raising into the service that hosts the
engine — with dedup keys (an already-firing alert is re-notified on a
throttle, never re-fired) so the merged stream stays coherent when
several replicas evaluate concurrently. `/fleet/alerts` serves the
folded view; `tools fleet-doctor` joins the journal with the other
planes into incident timelines.

The autoscale advisor (serve/autoscale.py) shares this journal: its
`scale` recommendation records ride the same files, so every scale
decision is attributable next to the alerts that motivated it.

The port's copy of processing_chain_tpu/telemetry/alerts.py.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

from ..utils import lockdebug
from ..utils.log import get_logger
from . import catalog
from .events import emit
from .metrics import counter, gauge
from .profiling import FRAGMENTATION_WASTE_THRESHOLD

FIRED = counter(
    "chain_alerts_fired_total",
    "alert fire transitions graded by this replica's engine", ("rule",),
)
RESOLVED = counter(
    "chain_alerts_resolved_total",
    "alert resolve transitions graded by this replica's engine",
    ("rule",),
)
ACTIVE = gauge(
    "chain_alerts_active",
    "alerts currently firing in this replica's engine",
)

_SAFE_NAME = re.compile(r"[^A-Za-z0-9._-]+")

#: while an alert stays firing, one `renotify` record per this many
#: seconds (scaled by the engine's window_scale) — the dedup contract:
#: the condition holding is one incident, not a record per evaluation
DEFAULT_RENOTIFY_S = 300.0

#: the error budget an SLO flow may spend: 1 - target fraction
_BUDGET_FRACTION = 1.0 - catalog.SLO_TARGET_FRACTION


def alerts_dir(root: str) -> str:
    """The alert-journal directory of one serve root."""
    return os.path.join(os.path.abspath(root), "alerts")


def _journal_name(replica: str) -> str:
    return _SAFE_NAME.sub("_", replica) + ".jsonl"


# ------------------------------------------------------------- journal


class AlertJournal:
    """Append-only per-replica alert journal (the spans/heat/meshobs
    discipline): lazily opened, torn predecessor tails sealed before
    the first append, every failure degraded to a logged warning —
    alerting must never take down the service it watches."""

    def __init__(self, root: str, replica: str) -> None:
        self.root = os.path.abspath(root)
        self.replica = replica
        self.path = os.path.join(self.root, _journal_name(replica))
        self._lock = lockdebug.make_lock("alert_journal")
        self._f = None      # guarded-by: _lock
        self._seq = 0       # guarded-by: _lock

    def _seal_torn_tail(self) -> None:
        """A predecessor SIGKILLed mid-write leaves a torn final line.
        Readers skip it, but O_APPEND would glue THIS incarnation's
        first record onto it and lose both — terminate the torn line
        before appending so our records stay parseable."""
        try:
            with open(self.path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
        except FileNotFoundError:
            return
        except OSError:
            pass  # the append itself will surface a real disk fault

    def append(self, record: dict) -> None:
        """One journal record. Never raises."""
        record.setdefault("ts", round(time.time(), 6))
        record["replica"] = self.replica
        record["pid"] = os.getpid()
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            try:
                if self._f is None:
                    os.makedirs(self.root, exist_ok=True)
                    self._seal_torn_tail()
                    self._f = open(self.path, "a")
                self._f.write(json.dumps(record, sort_keys=True) + "\n")
                self._f.flush()
            except (OSError, ValueError):
                get_logger().warning(
                    "alerts: could not append %s record",
                    record.get("kind"), exc_info=True)
                try:
                    if self._f is not None:
                        self._f.close()
                except OSError:
                    pass
                self._f = None

    def close(self) -> None:
        with self._lock:
            try:
                if self._f is not None:
                    self._f.close()
            except OSError:
                pass
            self._f = None


# ----------------------------------------------------------- burn math


class FlowWindow:
    """Cumulative (count, in-band) snapshots of one graded flow, from
    which windowed burn rates derive. The fleet histograms are
    cumulative, so a *windowed* error fraction needs the delta between
    two snapshots; the engine snapshots once per evaluation and this
    class answers "how fast did this flow burn budget over the last W
    seconds"."""

    __slots__ = ("snaps",)

    def __init__(self) -> None:
        #: (ts, cumulative count, cumulative in-band count)
        self.snaps: list = []

    def add(self, ts: float, count: float,
            within_band: Optional[float]) -> None:
        inband = count * within_band if within_band is not None else count
        self.snaps.append((ts, float(count), float(inband)))

    def prune(self, now: float, keep_s: float) -> None:
        cutoff = now - keep_s
        # keep one snapshot OLDER than the horizon so the longest
        # window always has a far edge to delta against
        while len(self.snaps) > 2 and self.snaps[1][0] <= cutoff:
            self.snaps.pop(0)

    def far_edge(self, now: float, window_s: float) -> tuple:
        """The snapshot a window's delta is taken against (two or more
        kept): the oldest inside the window. Where evaluations come
        sparser than the window, only the newest lies inside it; the one
        before it is then the edge, or a step between two evaluations
        would never read as fresh."""
        for i, snap in enumerate(self.snaps):
            if snap[0] >= now - window_s:
                return self.snaps[min(i, len(self.snaps) - 2)]
        return self.snaps[0]

    def burn(self, now: float, window_s: float) -> Optional[float]:
        """Error-budget burn rate over the trailing window: the error
        fraction of the observations inside it, divided by the budget
        fraction (1 == spending exactly the whole budget at the SLO
        boundary). None while the window holds no new observations.
        History shorter than the window grades over what exists — the
        engine would otherwise be blind for the first long-window
        span of every incident."""
        if len(self.snaps) < 2:
            return None
        t1, c1, i1 = self.snaps[-1]
        t0, c0, i0 = self.far_edge(now, window_s)
        if t1 <= t0:
            return None
        d_count = c1 - c0
        if d_count <= 0:
            return None
        d_err = max(0.0, d_count - (i1 - i0))
        return (d_err / d_count) / _BUDGET_FRACTION


# -------------------------------------------------------------- engine


class AlertEngine:
    """Grades `catalog.ALERT_RULES` against successive fleet views and
    journals the fire/resolve lifecycle. One engine per replica; dedup
    keys keep the fleet-merged stream coherent when several evaluate.

    `window_scale` uniformly compresses every declared window (and the
    re-notify throttle) — the soak harness squeezes hours into seconds
    without forking the rule declarations the production fleet runs.
    """

    def __init__(self, root: str, replica: str, *,
                 journal: Optional[AlertJournal] = None,
                 window_scale: float = 1.0,
                 renotify_s: float = DEFAULT_RENOTIFY_S,
                 rules: Optional[dict] = None) -> None:
        self.root = os.path.abspath(root)
        self.replica = replica
        self.window_scale = float(window_scale)
        self.renotify_s = float(renotify_s) * self.window_scale
        self.rules = dict(rules if rules is not None
                          else catalog.ALERT_RULES)
        self.journal = journal or AlertJournal(alerts_dir(root), replica)
        self._lock = lockdebug.make_lock("alert_engine")
        self._flows: dict = {}    # flow key -> FlowWindow  # guarded-by: _lock
        self._active: dict = {}   # alert key -> state dict  # guarded-by: _lock
        self._fire_count = 0      # guarded-by: _lock
        #: longest horizon any window needs, for snapshot pruning
        self._keep_s = max(
            w["long_s"] for w in catalog.BURN_RATE_WINDOWS.values()
        ) * self.window_scale * 1.25

    # ------------------------------------------------------- evaluation

    def evaluate(self, view: dict, now: Optional[float] = None) -> dict:
        """One grading pass over a fleet-view document. Returns
        {"active": [...], "fired": [...], "resolved": [...]} — the
        transitions this pass produced plus everything still firing.
        Never raises: a rule that cannot grade is logged and skipped
        (alerting must not sink the maintenance tick that hosts it)."""
        now = time.time() if now is None else now
        conditions: dict = {}
        for rule, spec in self.rules.items():
            try:
                for cond in self._grade_rule(rule, spec, view, now):
                    conditions[cond["alert"]] = cond
            except Exception:  # noqa: BLE001 - one bad rule must not mute the rest
                get_logger().warning(
                    "alerts: rule %s failed to grade", rule,
                    exc_info=True)
        return self._transition(conditions, now)

    def _grade_rule(self, rule: str, spec: dict, view: dict,
                    now: float) -> list:
        source = spec.get("source")
        if source in ("slo", "read_slo"):
            return self._grade_burn(rule, spec, view.get(source) or {},
                                    now)
        if source == "stalls":
            return self._grade_stalls(rule, spec, view.get("stalls") or [])
        if source == "heat":
            return self._grade_heat(rule, spec, view.get("heat") or {},
                                    now)
        if source == "mesh":
            return self._grade_mesh(rule, spec, view.get("mesh") or {})
        if source == "replicas":
            return self._grade_stale(rule, spec,
                                     view.get("replicas") or [])
        raise ValueError(f"rule {rule}: unknown source {source!r}")

    def _grade_burn(self, rule: str, spec: dict, report: dict,
                    now: float) -> list:
        """Multi-window multi-burn-rate over one SLO report section:
        per flow, snapshot the cumulative cell and trip when any
        declared window pair burns past its rate on BOTH windows."""
        phase = spec["phase"]
        out: list = []
        for tenant in sorted(report):
            for cls in sorted(report[tenant]):
                cell = report[tenant][cls].get(phase)
                if not cell or not cell.get("count"):
                    continue
                with self._lock:
                    flow = self._flows.setdefault(
                        (rule, tenant, cls), FlowWindow())
                    flow.add(now, cell["count"], cell.get("within_band"))
                    flow.prune(now, self._keep_s)
                    tripped = None
                    for wname, w in sorted(
                            catalog.BURN_RATE_WINDOWS.items()):
                        short = flow.burn(
                            now, w["short_s"] * self.window_scale)
                        long = flow.burn(
                            now, w["long_s"] * self.window_scale)
                        if short is not None and long is not None and \
                                short >= w["burn_rate"] and \
                                long >= w["burn_rate"]:
                            tripped = (wname, w, short)
                            break
                if tripped is None:
                    continue
                wname, w, short = tripped
                labels = {"tenant": tenant, "class": cls,
                          "phase": phase}
                out.append({
                    "alert": _alert_key(rule, labels),
                    "rule": rule, "labels": labels,
                    "severity": spec.get("severity", "ticket"),
                    "value": round(short, 2),
                    "threshold": w["burn_rate"], "window": wname,
                    "reason": (
                        f"{tenant}/{cls} {phase} burning error budget "
                        f"at {short:.1f}x over the {wname} windows "
                        f"(threshold {w['burn_rate']:g}x)"),
                })
        return out

    def _grade_stalls(self, rule: str, spec: dict, stalls: list) -> list:
        incident = spec.get("incident", "stalled")
        out: list = []
        for stall in stalls:
            if stall.get("incident", "stalled") != incident:
                continue
            labels = {"replica": stall.get("replica", "?"),
                      "task": stall.get("task", "?"),
                      "stage": stall.get("stage") or "-"}
            out.append({
                "alert": _alert_key(rule, labels),
                "rule": rule, "labels": labels,
                "severity": spec.get("severity", "ticket"),
                "value": stall.get("beat_age_s"),
                "threshold": None, "window": None,
                "reason": (
                    f"{labels['replica']}: {stall.get('kind', 'task')} "
                    f"'{labels['task']}' {incident} for "
                    f"{stall.get('beat_age_s', 0):.0f}s "
                    f"(stage {labels['stage']})"),
            })
        return out

    def _grade_heat(self, rule: str, spec: dict, heat: dict,
                    now: float) -> list:
        regrets = heat.get("regrets")
        if regrets is None:
            return []
        window_s = (catalog.BURN_RATE_WINDOWS["fast"]["short_s"]
                    * self.window_scale)
        with self._lock:
            flow = self._flows.setdefault((rule,), FlowWindow())
            # the stats are tail-sampled, so the cumulative count can
            # slide DOWN as old records leave the window; clamp to
            # monotonic so a slide never reads as fresh regret
            prev = flow.snaps[-1][1] if flow.snaps else 0.0
            flow.add(now, max(float(regrets), prev), None)
            flow.prune(now, self._keep_s)
            delta = 0.0
            if len(flow.snaps) >= 2:
                delta = flow.snaps[-1][1] - flow.far_edge(now, window_s)[1]
        if delta < spec.get("min_regrets", 1):
            return []
        labels = {"plane": "store"}
        return [{
            "alert": _alert_key(rule, labels),
            "rule": rule, "labels": labels,
            "severity": spec.get("severity", "ticket"),
            "value": int(delta), "threshold": spec.get("min_regrets", 1),
            "window": "fast",
            "reason": (
                f"{int(delta)} eviction regret(s) inside the fast "
                "window — recently-evicted artifacts are being re-read "
                "or rebuilt (hot tier undersized)"),
        }]

    def _grade_mesh(self, rule: str, spec: dict, mesh: dict) -> list:
        out: list = []
        for bucket, b in sorted((mesh.get("buckets") or {}).items()):
            waves = b.get("waves", 0)
            waste = b.get("waste_fraction", 0.0)
            if waves < spec.get("min_waves", 3) or \
                    waste < FRAGMENTATION_WASTE_THRESHOLD:
                continue
            labels = {"bucket": bucket}
            out.append({
                "alert": _alert_key(rule, labels),
                "rule": rule, "labels": labels,
                "severity": spec.get("severity", "ticket"),
                "value": waste,
                "threshold": FRAGMENTATION_WASTE_THRESHOLD,
                "window": None,
                "reason": (
                    f"mesh bucket {bucket} wastes "
                    f"{waste:.0%} of its slots over {waves} waves "
                    f"(threshold {FRAGMENTATION_WASTE_THRESHOLD:.0%})"),
            })
        return out

    def _grade_stale(self, rule: str, spec: dict,
                     replicas: list) -> list:
        stale_after = (spec.get("stale_after_s", 30.0)
                       * self.window_scale)
        out: list = []
        for rep in replicas:
            if rep.get("status") != "stale":
                continue
            age = rep.get("last_seen_s")
            if age is None or age < stale_after:
                continue
            labels = {"replica": rep.get("replica", "?")}
            out.append({
                "alert": _alert_key(rule, labels),
                "rule": rule, "labels": labels,
                "severity": spec.get("severity", "page"),
                "value": round(age, 1), "threshold": stale_after,
                "window": None,
                "reason": (
                    f"replica {labels['replica']} has a serve-info "
                    f"registration but stopped answering "
                    f"{age:.0f}s ago"),
            })
        return out

    # ------------------------------------------------------ transitions

    def _transition(self, conditions: dict, now: float) -> dict:
        """Diff this pass's tripped conditions against the firing set:
        new keys fire (journal + event + counter, once — the dedup
        contract), persisting keys re-notify on the throttle, vanished
        keys resolve."""
        fired: list = []
        resolved: list = []
        renotify: list = []
        with self._lock:
            for key, cond in conditions.items():
                state = self._active.get(key)
                if state is None:
                    self._fire_count += 1
                    alert_id = (f"al-{_SAFE_NAME.sub('_', self.replica)}"
                                f"-{self._fire_count:04d}")
                    state = {"id": alert_id, "fired_ts": now,
                             "notified_ts": now, **cond}
                    self._active[key] = state
                    fired.append(dict(state))
                else:
                    state.update({k: cond[k] for k in
                                  ("value", "reason", "window")})
                    if now - state["notified_ts"] >= self.renotify_s:
                        state["notified_ts"] = now
                        renotify.append(dict(state))
            for key in [k for k in self._active if k not in conditions]:
                state = self._active.pop(key)
                state["resolved_ts"] = now
                state["duration_s"] = round(now - state["fired_ts"], 3)
                resolved.append(state)
            active = [dict(s) for s in self._active.values()]
        for state in fired:
            self.journal.append({
                "kind": "fired", "id": state["id"],
                "alert": state["alert"], "rule": state["rule"],
                "severity": state["severity"],
                "labels": state["labels"], "value": state["value"],
                "threshold": state["threshold"],
                "window": state["window"], "reason": state["reason"],
                "ts": round(now, 6),
            })
            FIRED.labels(rule=state["rule"]).inc()
            emit("alert_fired", rule=state["rule"], alert=state["alert"],
                 id=state["id"], severity=state["severity"],
                 reason=state["reason"])
        for state in renotify:
            self.journal.append({
                "kind": "renotify", "id": state["id"],
                "alert": state["alert"], "rule": state["rule"],
                "severity": state["severity"],
                "labels": state["labels"], "value": state["value"],
                "reason": state["reason"], "ts": round(now, 6),
            })
        for state in resolved:
            self.journal.append({
                "kind": "resolved", "id": state["id"],
                "alert": state["alert"], "rule": state["rule"],
                "severity": state["severity"],
                "labels": state["labels"],
                "duration_s": state["duration_s"], "ts": round(now, 6),
            })
            RESOLVED.labels(rule=state["rule"]).inc()
            emit("alert_resolved", rule=state["rule"],
                 alert=state["alert"], id=state["id"],
                 duration_s=state["duration_s"])
        ACTIVE.set(len(active))
        return {"active": active, "fired": fired, "resolved": resolved}

    def active(self) -> list:
        with self._lock:
            return [dict(s) for s in self._active.values()]

    def close(self) -> None:
        self.journal.close()


def _alert_key(rule: str, labels: dict) -> str:
    """The dedup key: rule plus its sorted labels. One firing condition
    == one key == one alert, however many passes re-observe it."""
    tail = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{rule}{{{tail}}}" if tail else rule


# -------------------------------------------------------------- readers


def read_journal(path: str) -> list[dict]:
    """One journal file; tolerates torn lines (the one write a crash
    can interrupt — the spans/heat discipline)."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue  # torn line: every complete record stands
                if isinstance(record, dict):
                    out.append(record)
    except OSError:
        return []
    return out


def read_journals(root: str) -> list[dict]:
    """Every replica's alert journal under `root`, merged and ordered
    by (ts, replica, seq)."""
    records: list[dict] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    for name in names:
        if name.endswith(".jsonl"):
            records.extend(read_journal(os.path.join(root, name)))
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("replica", ""),
                                r.get("seq", 0)))
    return records


def fold(records: list) -> dict:
    """Collapse a merged record stream into per-alert lifecycle state:
    alert key -> {state, id, rule, labels, fired_ts, last_ts, ...}.
    Later records win; a `fired` after a `resolved` re-opens the key
    (each firing episode keeps its own id)."""
    alerts: dict = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "scale":
            continue
        key = rec.get("alert")
        if not key:
            continue
        entry = alerts.setdefault(key, {"alert": key})
        if kind == "fired":
            entry.update({
                "state": "firing", "id": rec.get("id"),
                "rule": rec.get("rule"),
                "severity": rec.get("severity"),
                "labels": rec.get("labels"),
                "value": rec.get("value"), "window": rec.get("window"),
                "reason": rec.get("reason"),
                "fired_ts": rec.get("ts"), "fired_by": rec.get("replica"),
                "episodes": entry.get("episodes", 0) + 1,
            })
            entry.pop("resolved_ts", None)
            entry.pop("duration_s", None)
        elif kind == "renotify":
            entry["value"] = rec.get("value", entry.get("value"))
            entry["reason"] = rec.get("reason", entry.get("reason"))
        elif kind == "resolved":
            entry.update({
                "state": "resolved", "resolved_ts": rec.get("ts"),
                "duration_s": rec.get("duration_s"),
            })
        entry["last_ts"] = rec.get("ts")
    return alerts


def active_alerts(root: str) -> list[dict]:
    """Every alert still firing across the fleet's journals, oldest
    first — the /fleet summary and fleet-top's alert line."""
    folded = fold(read_journals(alerts_dir(root)))
    active = [a for a in folded.values() if a.get("state") == "firing"]
    active.sort(key=lambda a: a.get("fired_ts", 0.0))
    return active


def alerts_report(root: str) -> dict:
    """The /fleet/alerts document: folded lifecycle state plus raw
    journal counts. Works from durable state only — no replica needs
    to be alive."""
    records = read_journals(alerts_dir(root))
    folded = fold(records)
    by_kind: dict = {}
    for rec in records:
        kind = rec.get("kind", "?")
        by_kind[kind] = by_kind.get(kind, 0) + 1
    active = sorted((a for a in folded.values()
                     if a.get("state") == "firing"),
                    key=lambda a: a.get("fired_ts", 0.0))
    resolved = sorted((a for a in folded.values()
                       if a.get("state") == "resolved"),
                      key=lambda a: a.get("resolved_ts", 0.0))
    return {
        "schema": 1,
        "generated_at": round(time.time(), 3),
        "root": os.path.abspath(root),
        "rules": sorted(catalog.ALERT_RULES),
        "active": active,
        "resolved": resolved[-32:],
        "counts": by_kind,
    }


def latest_scale(root: str) -> Optional[dict]:
    """The newest autoscale recommendation journaled under `root`
    (serve/autoscale.py rides this journal), or None."""
    latest = None
    for rec in read_journals(alerts_dir(root)):
        if rec.get("kind") == "scale":
            latest = rec
    return latest


def find_alert(root: str, ref: str) -> Optional[dict]:
    """Resolve an alert id (`al-…`) or dedup key to its folded state
    plus every raw journal record of the episode — the fleet-doctor
    incident anchor."""
    records = read_journals(alerts_dir(root))
    key = None
    for rec in records:
        if rec.get("id") == ref or rec.get("alert") == ref:
            key = rec.get("alert")
            break
    if key is None:
        return None
    folded = fold(records).get(key)
    if folded is None:
        return None
    episode = [r for r in records if r.get("alert") == key]
    return {**folded, "records": episode}


def journal_stats(root: str) -> dict:
    """Cheap size/count stats of the alert journals for status lines."""
    files = 0
    nbytes = 0
    try:
        names = sorted(os.listdir(root))
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        files += 1
        try:
            nbytes += os.path.getsize(os.path.join(root, name))
        except OSError:
            pass
    return {"files": files, "bytes": nbytes}
