"""Durable request-trace span journal: the queue's causal skeleton, surfaced
(copy of processing_chain_tpu/serve/spans.py).

A request's life spans processes — submit → queue → claim → steal →
wave → settle — and survives SIGKILL, but the durable queue records
hold only the LATEST state, not the path that led there. This module
turns every
ownership/state transition into one append-only, epoch-stamped span
record so the whole fleet's history is replayable from disk:

  * **One journal file per replica** (`spans/<replica>.jsonl` under the
    queue root): appends never contend across processes, a SIGKILLed
    replica's journal survives it, and `read_journals` merges the fleet
    back into one timeline (sorted by wall clock, then per-journal
    sequence — the only ordering that exists across processes).
  * **Span-before-persist discipline**: the writer appends (flushed to
    the kernel) BEFORE the queue persists the transition it describes,
    so a crash between the two leaves an *extra* span (an attempt whose
    record never landed — honest forensics), never a *missing* one. The
    gapless-chain invariant below depends on exactly this ordering.
    Flush, not fsync: a SIGKILLed process cannot take flushed bytes
    with it (they are the kernel's), and that is the death mode the
    fleet contract covers — power-loss durability stays the QUEUE
    records' claim (their rewrites fsync), the journal deliberately
    does not pay ~ms-per-span for it inside the queue's critical
    sections.
  * **Trace ids ride along**: each span carries the record's request
    ids and trace ids at the moment of the transition, so `tools trace
    show` can filter the fleet journal down to one request without a
    secondary index.

The **gapless-chain invariant** (`verify_chain`, checked per terminal
record by `tools serve-chaos`): every epoch a record ever held was
introduced by exactly one claim/steal/requeue transition, and each of
those writes a span — so for a terminal record the journal must show an
`enqueue`, every epoch in `1..settled_epoch`, and a terminal span
matching the record's final state. A SIGKILLed owner cannot break this:
its own claim span was already flushed to the kernel before the claim
persisted — a process death cannot take those bytes with it (power
loss can; that durability is the queue records' fsynced claim,
deliberately not the journal's) — and the steal/recovery that took
the work over is written by a live peer.

Readers tolerate a torn final line (the one write a crash can
interrupt), mirroring telemetry/events.read_jsonl.

Retention: journals are append-only per-root history with NO rotation
— pruning old spans would break the gapless chains of the records
that outlive them, so a journal lives exactly as long as its serve
root. The hot path (/fleet, refreshed every few seconds) therefore
reads only tail-sampled stats (`journal_stats`); the full-history
readers (`tools trace show`, the chaos completeness check, soak
percentiles) are operator-invoked and bounded by the root's lifetime.
Journal rotation keyed to request retention is future work.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Iterable, Optional

from ..utils import lockdebug
from ..utils.log import get_logger

#: transition vocabulary (the `phase` field); terminal phases settle a
#: record, ownership phases introduce a fresh epoch
PHASES = (
    "enqueue",    # record minted (or re-armed for a fresh life)
    "attach",     # an overlapping request joined the existing record
    "claim",      # queued -> running: this replica owns the execution
    "revert",     # mid-claim disk failure undone: back to queued
    "steal",      # a live replica reclaimed a dead/expired lease
    "requeue",    # retry (attempts budget) or crash-recovery re-arm
    "complete",   # running -> done
    "fail",       # running -> failed
    "quarantine", # running -> quarantined
    "fenced",     # a stale-epoch settle was refused (forensics only)
)

#: phases that introduce the epoch they carry (the gapless-chain check
#: demands every epoch in 1..settled_epoch appear on one of these)
EPOCH_PHASES = ("claim", "steal", "requeue", "revert")

#: phases that settle a record; the last span of a terminal record's
#: chain must be one of these and agree with the record's state
TERMINAL_PHASES = {"complete": "done", "fail": "failed",
                   "quarantine": "quarantined"}

_SAFE_NAME = re.compile(r"[^A-Za-z0-9._-]+")


def safe_replica_name(replica: str) -> str:
    """Replica id as a filesystem-safe basename (journal + epoch files)."""
    return _SAFE_NAME.sub("_", replica)


def _journal_name(replica: str) -> str:
    return safe_replica_name(replica) + ".jsonl"


class SpanJournal:
    """Append-only per-replica span writer (see module doc).

    Thread-safe: the scheduler workers, the maintenance tick and the
    HTTP submit path all transition records. Appends are flushed per
    record (SIGKILL-proof: flushed bytes belong to the kernel, not the
    process — see the module doc for why fsync is deliberately NOT
    paid here), and any disk failure degrades to a logged warning: the
    journal is observability, it must never break the queue it
    observes."""

    def __init__(self, root: str, replica: str,
                 replica_epoch: int = 0) -> None:
        self.root = os.path.abspath(root)
        self.replica = replica
        self.replica_epoch = int(replica_epoch)
        self.path = os.path.join(self.root, _journal_name(replica))
        self._lock = lockdebug.make_lock("serve_spans")
        self._f = None    # guarded-by: _lock
        self._seq = 0     # guarded-by: _lock

    def append(self, phase: str, *, job: str, plan: str, state: str,
               epoch: int, requests: Iterable[str] = (),
               traces: Iterable[str] = (), **extra) -> None:
        """Record one transition. Never raises (see class doc)."""
        record = {
            "ts": round(time.time(), 6),
            "phase": phase,
            "job": job,
            "plan": plan,
            "state": state,
            "epoch": int(epoch),
            "replica": self.replica,
            "replica_epoch": self.replica_epoch,
            "pid": os.getpid(),
            "requests": list(requests),
            "traces": [t for t in traces if t],
        }
        record.update(extra)
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            try:
                if self._f is None:
                    os.makedirs(self.root, exist_ok=True)
                    # append-only stream: torn tails are tolerated by
                    # read_journals, and O_APPEND keeps concurrent
                    # incarnations (a restart racing its predecessor's
                    # last flush) from interleaving mid-line
                    self._f = open(self.path, "a")
                self._f.write(json.dumps(record, sort_keys=True) + "\n")
                self._f.flush()
            except (OSError, ValueError):
                get_logger().warning(
                    "serve spans: could not append %s span for %s",
                    phase, job, exc_info=True)
                try:
                    if self._f is not None:
                        self._f.close()
                except OSError:
                    pass
                self._f = None

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
    """One journal file; tolerates a torn final line."""
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
                    break  # torn tail: everything before it stands
                if isinstance(record, dict):
                    out.append(record)
    except OSError:
        return []
    return out


def read_journals(root: str) -> list[dict]:
    """Every replica's journal under `root`, merged into one fleet
    timeline ordered by (ts, replica, seq) — wall clock across
    processes, per-journal sequence within one."""
    spans: list[dict] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    for name in names:
        if name.endswith(".jsonl"):
            spans.extend(read_journal(os.path.join(root, name)))
    spans.sort(key=lambda s: (s.get("ts", 0.0), s.get("replica", ""),
                              s.get("seq", 0)))
    return spans


def journal_stats(root: str, tail_bytes: int = 1 << 19) -> dict:
    """Cheap fleet-view summary of the journals: total size from stat,
    per-phase counts parsed from each journal's TAIL (last
    `tail_bytes`). An always-on fleet appends spans forever, and
    /fleet refreshes every few seconds — it must not reparse an
    unbounded history per refresh. `sampled: true` flags that some
    journal exceeded the tail window, i.e. the counts cover the recent
    window rather than all time (no silent cap)."""
    stats = {"files": 0, "bytes": 0, "total": 0,
             "by_phase": {}, "sampled": False}
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
                    phase = record.get("phase", "?")
                    stats["by_phase"][phase] = \
                        stats["by_phase"].get(phase, 0) + 1
                    stats["total"] += 1
        except OSError:
            continue
        stats["files"] += 1
        stats["bytes"] += size
    return stats


def spans_for_request(spans: Iterable[dict], request_id: str) -> list[dict]:
    return [s for s in spans if request_id in (s.get("requests") or ())]


def spans_for_job(spans: Iterable[dict], job_id: str) -> list[dict]:
    return [s for s in spans if s.get("job") == job_id]


# ------------------------------------------------------- gapless chains


def verify_chain(job_spans: list[dict], record: dict) -> list[str]:
    """The gapless-chain invariant for ONE terminal queue record
    (chaos-harness vocabulary: `record` is the on-disk JSON dict).
    Returns violations; empty = the journal fully explains how this
    record reached its terminal state, across any number of replica
    deaths. Non-terminal records are not checked (their chain is still
    being written)."""
    job_id = record.get("job", "?")
    state = record.get("state")
    if state not in ("done", "failed", "quarantined"):
        return []
    violations: list[str] = []
    if not job_spans:
        return [f"record {job_id} is terminal but has no spans at all"]
    if job_spans[0].get("phase") != "enqueue":
        violations.append(
            f"record {job_id}: chain starts with "
            f"{job_spans[0].get('phase')!r}, not 'enqueue'")
    settled_epoch = record.get("settledEpoch")
    final_epoch = settled_epoch if settled_epoch is not None \
        else record.get("epoch", 0)
    seen_epochs = {int(s.get("epoch", 0)) for s in job_spans
                   if s.get("phase") in EPOCH_PHASES}
    missing = sorted(set(range(1, int(final_epoch) + 1)) - seen_epochs)
    if missing:
        violations.append(
            f"record {job_id}: no ownership span introduced epoch(s) "
            f"{missing} — the chain has a gap")
    terminal = [s for s in job_spans if s.get("phase") in TERMINAL_PHASES]
    if not terminal:
        violations.append(
            f"record {job_id} is {state!r} but the journal holds no "
            "terminal span")
    else:
        last = terminal[-1]
        if TERMINAL_PHASES.get(last.get("phase")) != state:
            violations.append(
                f"record {job_id}: last terminal span is "
                f"{last.get('phase')!r} but the record is {state!r}")
        if settled_epoch is not None and \
                int(last.get("epoch", -1)) != int(settled_epoch):
            violations.append(
                f"record {job_id}: terminal span carries epoch "
                f"{last.get('epoch')} but the record settled under "
                f"{settled_epoch}")
    return violations


def verify_completeness(serve_root: str,
                        records: Optional[dict] = None) -> list[str]:
    """The fleet-wide trace-completeness check `tools serve-chaos` runs
    as an invariant: every terminal record under `serve_root` has a
    gapless span chain. `records` (job_id -> record dict) can be
    injected by callers that already loaded them."""
    jobs_dir = os.path.join(serve_root, "queue", "jobs")
    if records is None:
        records = {}
        try:
            names = os.listdir(jobs_dir)
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".json"):
                continue  # lease sentinels (*.json.inprogress) included
            try:
                with open(os.path.join(jobs_dir, name)) as f:
                    doc = json.load(f)
                records[doc["job"]] = doc
            except (OSError, ValueError, KeyError):
                continue
    spans = read_journals(os.path.join(serve_root, "queue", "spans"))
    by_job: dict[str, list] = {}
    for span in spans:
        by_job.setdefault(span.get("job", ""), []).append(span)
    violations: list[str] = []
    for job_id, record in sorted(records.items()):
        violations.extend(verify_chain(by_job.get(job_id, []), record))
    return violations
