"""The access-heat ledger: read-path flight recorder of the artifact store.

The artifact plane's read path (`GET /v1/artifacts`, docs/SERVE.md) was
write-side observable only: the store counts hits and GC counts
evictions, but nothing records WHO is read, how often, how many bytes,
or what evicting a plan cost — the exact signals the tiered/edge-cached
artifact plane of ROADMAP item 2 needs before any promotion/demotion
policy can be more than a guess. This module is that recorder:

  * **One journal file per replica** (`<store root>/heat/<replica>.jsonl`),
    modeled on serve/spans.py: appends are flushed-not-fsynced (a
    SIGKILLed process cannot take flushed bytes with it — they are the
    kernel's; power-loss durability is deliberately not paid on a
    per-read hot path), O_APPEND so a restart racing its predecessor's
    last flush never interleaves mid-line, and readers tolerate a torn
    final line. Journals merge fleet-wide by simple concatenation —
    per-replica files never contend across processes.
  * **Four record kinds** (the `kind` field):
      - `read`   — one artifact read: `plan`, `mode` (`full` — bytes
        streamed — `not_modified` — a conditional GET answered 304,
        an edge-class hit whose bytes the client's cache already holds —
        or `range` — a single byte range streamed as a 206), `bytes`
        actually served, the `tier` the bytes were found in when the
        store is tiered, the artifact `size` and `size_class`,
        `tenant`, and the measured `ttfb_s`/`dur_s` when the serve
        layer observed them.
      - `move`   — one tier placement move (store/tiers.py): `op`
        (`promote` | `demote`), `from_tier`, `to_tier`, `bytes`, and
        the owning `plan` when known. Written only AFTER the source
        copy is deleted, so a crashed move never journals and a
        retried one journals exactly once.
      - `evict`  — one GC eviction with its evidence (store/gc.py):
        `reason` (`over_budget` | `orphan`), `last_used_age_s`,
        recorded `reads`, `freed_bytes`, and the `budget_bytes`
        pressure trigger.
      - `regret` — a read or rebuild of a plan hash evicted within
        `regret_window_s`: the canonical cache-undersizing signal,
        counted as `chain_store_eviction_regret_total` (an adequately
        sized cache records zero; every regret is a rebuild or a 404
        the budget forced).

Readers (`read_journals`, `aggregate`, `working_set_curve`) serve the
`tools store-heat` report and the fleet merge (telemetry/fleet.py);
`journal_stats` is the tail-sampled cheap summary the few-seconds-
cadence `/fleet` view reads, mirroring serve/spans.journal_stats —
journals are append-only history and the hot path must not reparse an
unbounded file per refresh.

The port's copy of processing_chain_tpu/store/heat.py.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

from .. import telemetry as tm
from ..utils import lockdebug
from ..utils.log import get_logger

READS = tm.counter(
    "chain_store_reads_total",
    "artifact reads recorded by the heat ledger, by mode "
    "(full = bytes streamed; not_modified = conditional GET hit; "
    "range = a single byte range streamed as a 206)",
    ("mode",),
)
READ_BYTES = tm.counter(
    "chain_store_read_bytes_total",
    "artifact bytes actually served to readers",
)
REGRET = tm.counter(
    "chain_store_eviction_regret_total",
    "reads or rebuilds of a recently-evicted plan hash — the "
    "cache-undersizing signal (docs/STORE.md)",
    ("via",),
)

#: an eviction is "recent" — and a later read/rebuild of its plan is
#: REGRET — for this long (seconds)
REGRET_WINDOW_S = 3600.0

_SAFE_NAME = re.compile(r"[^A-Za-z0-9._-]+")


def heat_dir(store_root: str) -> str:
    """The ledger directory of one store root."""
    return os.path.join(os.path.abspath(store_root), "heat")


def _journal_name(replica: str) -> str:
    return _SAFE_NAME.sub("_", replica) + ".jsonl"


class HeatLedger:
    """Append-only per-replica heat journal + the regret detector.

    Thread-safe: the HTTP read path, the submit path (rebuild regret)
    and the GC pass all record through one ledger. Appends are flushed
    per record and any disk failure degrades to a logged warning — the
    ledger is observability, it must never break the read path it
    observes."""

    def __init__(self, store_root: str, replica: str,
                 regret_window_s: float = REGRET_WINDOW_S) -> None:
        self.root = heat_dir(store_root)
        self.replica = replica
        self.path = os.path.join(self.root, _journal_name(replica))
        self.regret_window_s = float(regret_window_s)
        self._lock = lockdebug.make_lock("store_heat")
        self._f = None      # guarded-by: _lock
        self._seq = 0       # guarded-by: _lock
        #: plan -> (evict ts, evicting replica) within the regret window,
        #: fed by our own evictions and a throttled incremental scan of
        #: the peer journals (evictions elsewhere in the fleet must
        #: regret HERE when this replica serves the re-read)
        self._evicted: dict = {}       # guarded-by: _lock
        self._offsets: dict = {}       # guarded-by: _lock
        self._last_refresh = 0.0       # guarded-by: _lock
        self._refresh_interval_s = 1.0

    # ------------------------------------------------------------ writes

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

    def _append(self, record: dict) -> None:
        """One journal record (spans.py discipline). Never raises."""
        record.setdefault("ts", round(time.time(), 6))
        record["replica"] = self.replica
        record["pid"] = os.getpid()
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            try:
                if self._f is None:
                    os.makedirs(self.root, exist_ok=True)
                    # append-only stream: torn tails are tolerated by
                    # readers, and O_APPEND keeps a restarted replica
                    # racing its predecessor's last flush from
                    # interleaving mid-line
                    self._seal_torn_tail()
                    self._f = open(self.path, "a")
                self._f.write(json.dumps(record, sort_keys=True) + "\n")
                self._f.flush()
            except (OSError, ValueError):
                get_logger().warning(
                    "store heat: could not append %s record",
                    record.get("kind"), exc_info=True)
                try:
                    if self._f is not None:
                        self._f.close()
                except OSError:
                    pass
                self._f = None

    def record_read(self, plan: str, nbytes: int, mode: str = "full", *,
                    size: Optional[int] = None,
                    size_class: Optional[str] = None,
                    tenant: str = "",
                    tier: Optional[str] = None,
                    ttfb_s: Optional[float] = None,
                    dur_s: Optional[float] = None,
                    ts: Optional[float] = None) -> None:
        """One artifact read (full stream, single-range 206, or
        conditional-GET 304). `tier` is the store tier the read found
        the bytes in (docs/STORE.md "Tier hierarchy"). `ts` is when the
        request arrived (default: now): a stream is recorded once it
        completes, after its client may already have sent the next
        request, so the arrival time keeps the journal in request order."""
        READS.labels(mode=mode).inc()
        if nbytes:
            READ_BYTES.inc(int(nbytes))
        record = {
            "kind": "read",
            "plan": plan,
            "mode": mode,
            "bytes": int(nbytes),
            "tenant": tenant,
        }
        if ts is not None:
            record["ts"] = round(ts, 6)
        if tier is not None:
            record["tier"] = tier
        if size is not None:
            record["size"] = int(size)
        if size_class is not None:
            record["size_class"] = size_class
        if ttfb_s is not None:
            record["ttfb_s"] = round(ttfb_s, 6)
        if dur_s is not None:
            record["dur_s"] = round(dur_s, 6)
        self._append(record)

    def record_move(self, evidence: dict) -> None:
        """One tier placement move, with the evidence store/tiers.py
        assembled (shared shape with the `store_promote`/`store_demote`
        events). Called AFTER the source delete — see the crash-safety
        ordering note in the module docstring."""
        self._append({"kind": "move", **evidence})

    def record_eviction(self, evidence: dict) -> None:
        """One GC eviction, with the per-victim evidence store/gc.py
        assembled (shared shape with the `store_evict` event and the
        `tools store-admin gc` render)."""
        record = {"kind": "evict", **evidence}
        plan = evidence.get("plan")
        if plan:
            with self._lock:
                self._evicted[plan] = (time.time(), self.replica)
        self._append(record)

    def note_read_or_rebuild(self, plan: str,
                             via: str = "read") -> Optional[dict]:
        """Regret check: if `plan` was evicted within the regret window
        (by ANY replica — peers' journals are consulted), count one
        eviction regret and journal it. Returns the regret record, or
        None when the miss is not regretful (never built, or evicted
        long ago)."""
        now = time.time()
        with self._lock:
            self._refresh_locked(now)
            entry = self._evicted.get(plan)
            if entry is None:
                return None
            evicted_ts, evicted_by = entry
            if now - evicted_ts > self.regret_window_s:
                self._evicted.pop(plan, None)
                return None
        REGRET.labels(via=via).inc()
        record = {
            "kind": "regret",
            "plan": plan,
            "via": via,
            "evicted_ago_s": round(max(0.0, now - evicted_ts), 3),
            "evicted_by": evicted_by,
        }
        tm.emit("store_regret", plan=plan, via=via,
                evicted_ago_s=record["evicted_ago_s"],
                evicted_by=evicted_by)
        self._append(record)
        return record

    # holds-lock: _lock
    def _refresh_locked(self, now: float) -> None:
        """Throttled incremental scan of every replica's journal for
        evict records. Offsets only ever advance to the end of the last
        COMPLETE line, so a torn tail is re-read whole once its newline
        lands."""
        if now - self._last_refresh < self._refresh_interval_s:
            return
        self._last_refresh = now
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for name in names:
            if not name.endswith(".jsonl"):
                continue
            path = os.path.join(self.root, name)
            offset = self._offsets.get(name, 0)
            try:
                with open(path) as f:
                    f.seek(offset)
                    chunk = f.read()
            except OSError:
                continue
            end = chunk.rfind("\n")
            if end < 0:
                continue
            self._offsets[name] = offset + end + 1
            for line in chunk[:end].splitlines():
                try:
                    record = json.loads(line)
                except ValueError:
                    continue
                if (isinstance(record, dict)
                        and record.get("kind") == "evict"
                        and record.get("plan")):
                    self._evicted[record["plan"]] = (
                        record.get("ts", 0.0),
                        record.get("replica", "?"),
                    )
        cutoff = now - self.regret_window_s
        for plan in [p for p, (ts, _) in self._evicted.items()
                     if ts < cutoff]:
            self._evicted.pop(plan, None)

    def read_counts(self) -> dict:
        """plan -> recorded read count, merged over every replica's
        journal — the GC evidence's `reads` field (store/gc.py)."""
        counts: dict = {}
        for record in read_journals(self.root):
            if record.get("kind") == "read" and record.get("plan"):
                counts[record["plan"]] = counts.get(record["plan"], 0) + 1
        return counts

    def close(self) -> None:
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass


# ---------------------------------------------------------------- readers


def read_journal(path: str) -> list[dict]:
    """One journal file; tolerates torn lines (the one write a crash
    can interrupt — same discipline serve/spans.py pins). A torn line
    is usually the tail, but a restarted replica seals its
    predecessor's torn tail with a newline and appends after it, so a
    long-lived journal can carry one mid-file; either way every
    complete record stands."""
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
    """Every replica's heat journal under `root`, merged and ordered by
    (ts, replica, seq)."""
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


def aggregate(root: str) -> dict:
    """The full-history ledger rollup the heat report renders:
    per-plan read/bytes/last-access accounting, per-replica sums (the
    fleet-merge identity check: merged totals MUST equal the by-replica
    sums — both come from the same records), and fleet totals including
    regrets and evictions."""
    per_plan: dict = {}
    by_replica: dict = {}
    by_tier: dict = {}
    totals = {"reads": 0, "full": 0, "not_modified": 0, "range": 0,
              "bytes": 0, "regrets": 0, "evictions": 0,
              "promotions": 0, "demotions": 0}
    for record in read_journals(root):
        kind = record.get("kind")
        if kind == "read":
            plan = record.get("plan") or "?"
            entry = per_plan.setdefault(plan, {
                "reads": 0, "full": 0, "not_modified": 0, "range": 0,
                "bytes": 0, "last_ts": 0.0, "size": 0, "tiers": {},
            })
            mode = record.get("mode")
            if mode not in ("full", "not_modified", "range"):
                mode = "full"
            nbytes = int(record.get("bytes") or 0)
            entry["reads"] += 1
            entry[mode] += 1
            entry["bytes"] += nbytes
            entry["last_ts"] = max(entry["last_ts"],
                                   record.get("ts", 0.0))
            if record.get("size"):
                entry["size"] = max(entry["size"], int(record["size"]))
            tier = record.get("tier")
            if tier:
                entry["tiers"][tier] = entry["tiers"].get(tier, 0) + 1
                t = by_tier.setdefault(tier, {"reads": 0, "bytes": 0})
                t["reads"] += 1
                t["bytes"] += nbytes
            rep = by_replica.setdefault(record.get("replica", "?"),
                                        {"reads": 0, "bytes": 0})
            rep["reads"] += 1
            rep["bytes"] += nbytes
            totals["reads"] += 1
            totals[mode] += 1
            totals["bytes"] += nbytes
        elif kind == "move":
            if record.get("op") == "promote":
                totals["promotions"] += 1
            else:
                totals["demotions"] += 1
        elif kind == "evict":
            totals["evictions"] += 1
        elif kind == "regret":
            totals["regrets"] += 1
    return {"per_plan": per_plan, "by_replica": by_replica,
            "by_tier": by_tier, "totals": totals}


def plan_size(entry: dict) -> int:
    """Best artifact-size estimate for one per-plan aggregate entry:
    the recorded manifest size, else bytes-per-full-read."""
    if entry.get("size"):
        return int(entry["size"])
    if entry.get("full"):
        return int(entry["bytes"] / max(1, entry["full"]))
    return 0


def working_set_curve(per_plan: dict) -> list[dict]:
    """The hot-set curve, hottest plan first: after the k hottest
    plans, what fraction of the stored bytes serves what fraction of
    the reads ("X% of bytes serve Y% of reads"). One point per plan;
    the report downsamples for display."""
    entries = sorted(per_plan.values(), key=lambda e: -e["reads"])
    total_reads = sum(e["reads"] for e in entries)
    total_bytes = sum(plan_size(e) for e in entries)
    curve: list[dict] = []
    cum_reads = 0
    cum_bytes = 0
    for i, entry in enumerate(entries):
        cum_reads += entry["reads"]
        cum_bytes += plan_size(entry)
        curve.append({
            "plans": i + 1,
            "reads_frac": round(cum_reads / total_reads, 4)
            if total_reads else 0.0,
            "bytes_frac": round(cum_bytes / total_bytes, 4)
            if total_bytes else 0.0,
        })
    return curve


def journal_stats(root: str, tail_bytes: int = 1 << 19) -> dict:
    """Cheap fleet-view summary (serve/spans.journal_stats's sibling):
    total size from stat, per-kind/mode counts parsed from each
    journal's TAIL. `sampled: true` flags that some journal exceeded
    the tail window — the counts then cover the recent window, not all
    time (no silent cap)."""
    stats = {"files": 0, "bytes": 0, "total": 0, "reads": 0, "full": 0,
             "not_modified": 0, "range": 0, "bytes_served": 0,
             "evictions": 0, "regrets": 0, "moves": 0, "sampled": False}
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return stats
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        path = os.path.join(root, name)
        try:
            size = os.stat(path).st_size
            with open(path) as f:
                if size > tail_bytes:
                    stats["sampled"] = True
                    f.seek(size - tail_bytes)
                    f.readline()  # discard the mid-record partial
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        record = json.loads(line)
                    except ValueError:
                        continue  # torn tail (or mid-window garbage)
                    stats["total"] += 1
                    kind = record.get("kind")
                    if kind == "read":
                        stats["reads"] += 1
                        mode = record.get("mode")
                        if mode in ("full", "not_modified", "range"):
                            stats[mode] += 1
                        stats["bytes_served"] += \
                            int(record.get("bytes") or 0)
                    elif kind == "move":
                        stats["moves"] += 1
                    elif kind == "evict":
                        stats["evictions"] += 1
                    elif kind == "regret":
                        stats["regrets"] += 1
        except OSError:
            continue
        stats["files"] += 1
        stats["bytes"] += size
    return stats
