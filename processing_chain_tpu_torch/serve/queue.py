"""Durable, dedup-aware job queue: the serve daemons' crash-proof spine
(copy of processing_chain_tpu/serve/queue.py).

One JSON record per job under `jobs/`, every state change an atomic
durable rewrite (utils/fsio — the store's tmp+rename idiom, plus fsync:
queue records claim SIGKILL-proofness, so a power-loss crash must not
promote an unflushed rename). The queue is safe for N concurrent
replica daemons sharing one root:

  * **Lease-fenced ownership** — while a job executes, a
    `<record>.inprogress` LEASE (replica id, monotonically-increasing
    epoch, expiry, pid/host) sits next to it, renewed by the owner's
    heartbeat thread. A lease whose holder is demonstrably dead (same
    host, pid gone) or whose expiry passed is reclaimable: any live
    replica STEALS the record back to `queued` with the epoch bumped
    (`serve_lease_stolen`). Every settle is epoch-fenced against the
    on-disk record, so a zombie replica resumed after SIGSTOP cannot
    settle a record it lost (`serve_settle_fenced`).
  * **Cross-process atomicity** — every mutation holds an exclusive
    flock on `<root>/queue.lock` (released automatically by the kernel
    when a replica dies), so claim/steal/settle/enqueue from different
    replicas never interleave mid-transition. Reads never need it:
    records are whole-file atomic replaces.
  * **Cross-replica visibility** — `poll()` merges peer record changes
    into the in-memory view (stat-keyed rescans) and runs the steal
    scan; enqueue-time dedup across replicas is eventual (a peer's
    record for the same plan attaches after the next poll), and the
    store's plan-hash commit keeps artifacts exactly-once regardless.

Dedup is identity-by-plan-hash, the store's own key: enqueueing a unit
whose plan hash already has a queued/running job ATTACHES the new
request to that record instead of minting a second execution —
overlapping requests from any number of tenants share one job by
construction (singleflight). A plan whose job already completed is the
caller's warm path (the store serves it); a failed or evicted plan
re-arms the same record. A QUARANTINED plan (permanent failure —
docs/SERVE.md "Failure taxonomy") does not: new requests are refused
until an operator re-arms it.

States: queued → running → done | failed | quarantined (failed/evicted
re-arm to queued on the next enqueue; quarantined only via rearm). The
machine is DECLARED below (STATES / INITIAL / TRANSITIONS) and that
declaration is load-bearing: chainlint's `queue-transition` rule
rejects any state write that is not an annotated declared edge, `tools
queue-crashcheck` fault-injects every atomic-write boundary against it,
and docs/SERVE.md renders it. The record keeps every request ID it
answers, `attempts`, `epoch`, `not_before` (retry backoff) and timing
for forensics.
"""

from __future__ import annotations

import fcntl
import json
import os
import secrets
import socket
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional

from .. import telemetry as tm
from ..telemetry import catalog
from ..utils import lockdebug
from ..utils.fsio import atomic_write_json
from ..utils.log import get_logger
from .spans import SpanJournal, safe_replica_name

_QUEUE_DEPTH = tm.gauge(
    "chain_serve_queue_depth", "jobs waiting in the serve queue"
)
# SLO phase histograms (docs/TELEMETRY.md "Fleet observability"): the
# per-(tenant × priority-class) latency truth the fleet view aggregates
# against catalog.SLO_BANDS. Queue-wait is observed at claim time
# (enqueue-or-requeue → claim), execution at settle; the request-level
# end-to-end histogram lives in serve/service.py.
_QUEUE_WAIT = tm.histogram(
    "chain_serve_queue_wait_seconds",
    "time a unit waited in 'queued' before a claim, per tenant/priority",
    ("tenant", "priority"),
    buckets=catalog.SLO_LATENCY_BUCKETS,
)
_EXEC_SECONDS = tm.histogram(
    "chain_serve_execution_seconds",
    "claim-to-settle execution time of a unit, per tenant/priority",
    ("tenant", "priority"),
    buckets=catalog.SLO_LATENCY_BUCKETS,
)
_LEASE_STEALS = tm.counter(
    "chain_serve_lease_steals_total",
    "expired/dead leases reclaimed from peer replicas",
)
_FENCED_SETTLES = tm.counter(
    "chain_serve_fenced_settles_total",
    "settle attempts rejected because the caller's epoch was stale",
)
_CLAIM_REVERTS = tm.counter(
    "chain_serve_claim_reverts_total",
    "claims reverted to queued by a mid-claim disk failure",
)
_QUARANTINED = tm.counter(
    "chain_serve_quarantined_total",
    "plans quarantined after a permanent failure",
)
_SRC_POISONED = tm.counter(
    "chain_serve_poisoned_total",
    "SRC content digests quarantined after a poison verdict",
)

# --------------------------------------------------------------------------
# The record state machine, declared ONCE. Three consumers share this
# table (docs/SERVE.md "State machine"): chainlint's `queue-transition`
# rule verifies every `.state` write in serve code is an annotated,
# declared edge; `tools queue-crashcheck` fault-injects every
# atomic-write boundary and asserts recovery lands every record in a
# declared state; docs/SERVE.md renders it between the
# queue-transitions markers (`tools queue-crashcheck --render-table`).
# Keep every entry a literal — the linter parses this by AST.

#: every state a durable record can be in
STATES = ("queued", "running", "done", "failed", "quarantined")

#: the only state a record may be created in
INITIAL = "queued"

#: declared edges: (from, to)
TRANSITIONS = frozenset({
    ("queued", "running"),        # claim: lease down, execution owned
    ("running", "done"),          # complete: store commit landed / warm hit
    ("running", "failed"),        # fail: attempts budget exhausted
    ("running", "queued"),        # retry/steal/revert/recovery re-arm
    ("running", "quarantined"),   # permanent failure: retrying is futile
    ("queued", "quarantined"),    # poison sweep: the record's SRC content digest was quarantined fleet-wide
    ("failed", "queued"),         # re-arm: a fresh request retries the plan
    ("done", "queued"),           # re-arm: the store evicted the artifact
    ("quarantined", "queued"),    # re-arm: operator cleared the quarantine
})

#: states a new request can attach to (the singleflight window)
_ATTACHABLE = ("queued", "running")

#: states with no outstanding work (quarantine included: nothing will
#: run it until an operator re-arms)
TERMINAL = ("done", "failed", "quarantined")

_HOST = socket.gethostname()

#: replica ids of every OPEN DurableQueue in this process — the
#: same-pid liveness oracle. A lease whose pid is ours but whose
#: replica id is not here belongs to a previous (dead) incarnation:
#: reclaim it immediately instead of waiting out the expiry, which is
#: exactly what a single-replica daemon restart needs.
_REPLICAS_LOCK = lockdebug.make_lock("serve_replicas")
_LIVE_REPLICAS: set = set()  # guarded-by: _REPLICAS_LOCK


def owner_stamp(replica: str) -> dict:
    """The {replica, pid, host} liveness stamp persisted wherever a
    replica claims durable ownership outside the queue (request docs):
    peers probe it with `owner_process_dead` to adopt orphans."""
    return {"replica": replica, "pid": os.getpid(), "host": _HOST}


def owner_process_dead(owner) -> bool:
    """Best-effort: is the process behind an `owner_stamp` demonstrably
    dead? Same-host only (a pid probe means nothing across hosts —
    cross-host orphans are adopted at the next replica restart, which
    rescans everything). False on any doubt: adopting a LIVE peer's
    work is the expensive mistake, waiting is merely slow."""
    if not isinstance(owner, dict):
        return False
    if owner.get("host") != _HOST:
        return False
    try:
        pid = int(owner.get("pid", 0) or 0)
    except (TypeError, ValueError):
        return False
    if pid == os.getpid():
        with _REPLICAS_LOCK:
            return owner.get("replica") not in _LIVE_REPLICAS
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except OSError:
        pass
    return False


def _id_seq(job_id: str) -> int:
    """Numeric tail of a j-prefixed job id; 0 for foreign names."""
    try:
        return int(job_id.lstrip("j"))
    except ValueError:
        return 0


@dataclass
class JobRecord:
    """One durable unit of work, keyed by its plan hash."""

    job_id: str
    plan_hash: str
    plan: dict
    unit: dict            # {"database","src","hrc","params","pvs_id"}
    tenant: str
    priority: str
    output: str           # path RELATIVE to the artifacts root
    requests: list = field(default_factory=list)
    #: trace ids of the requests this record answers, parallel in spirit
    #: (not index) to `requests` — the durable half of the request-trace
    #: context, so a record outliving its submitter still knows its
    #: traces (docs/TELEMETRY.md "Fleet observability & tracing")
    trace_ids: list = field(default_factory=list)
    state: str = "queued"
    enqueued_at: float = 0.0
    #: when the record LAST entered 'queued' (enqueue, re-arm, retry,
    #: steal, recovery) — the queue-wait SLO phase measures from here,
    #: not from the original enqueue
    queued_at: float = 0.0
    #: when the current owner claimed it (None while queued/terminal)
    claimed_at: Optional[float] = None
    attempts: int = 0
    error: Optional[str] = None
    error_kind: Optional[str] = None  # transient | permanent (taxonomy)
    done_at: Optional[float] = None
    warm: bool = False    # completed via store hit, not execution
    epoch: int = 0        # bumped on every ownership change (claim/steal)
    owner: Optional[str] = None       # replica id of the current claimant
    not_before: float = 0.0           # retry backoff: claim-eligibility time
    settled_epoch: Optional[int] = None  # epoch the terminal write carried
    #: predicted execution seconds (serve/cost.py, stamped at enqueue):
    #: the scheduler packs waves by it, admission sums it per tenant,
    #: and the settle-time feedback loop grades it against reality
    cost_s: float = 0.0
    #: content digest of the unit's SRC (Executor.src_digest, stamped
    #: at enqueue): the poison-quarantine key — one hostile upload is
    #: quarantined by its BYTES, so every plan referencing it (any HRC,
    #: any tenant, any replica) fails fast instead of burning its own
    #: retry budget rediscovering the same poison (docs/ROBUSTNESS.md)
    src_digest: Optional[str] = None

    def to_json(self) -> dict:
        return {
            "job": self.job_id,
            "planHash": self.plan_hash,
            "plan": self.plan,
            "unit": self.unit,
            "tenant": self.tenant,
            "priority": self.priority,
            "output": self.output,
            "requests": list(self.requests),
            "traces": list(self.trace_ids),
            "state": self.state,
            "enqueuedAt": self.enqueued_at,
            "queuedAt": self.queued_at,
            "claimedAt": self.claimed_at,
            "attempts": self.attempts,
            "error": self.error,
            "errorKind": self.error_kind,
            "doneAt": self.done_at,
            "warm": self.warm,
            "epoch": self.epoch,
            "owner": self.owner,
            "notBefore": self.not_before,
            "settledEpoch": self.settled_epoch,
            "costS": self.cost_s,
            "srcDigest": self.src_digest,
        }

    @classmethod
    def from_json(cls, data: dict) -> "JobRecord":
        return cls(
            job_id=data["job"],
            plan_hash=data["planHash"],
            plan=data["plan"],
            unit=data["unit"],
            tenant=data.get("tenant", ""),
            priority=data.get("priority", "normal"),
            output=data.get("output", ""),
            requests=list(data.get("requests", [])),
            trace_ids=list(data.get("traces", [])),
            state=data.get("state", "queued"),
            enqueued_at=float(data.get("enqueuedAt", 0.0)),
            queued_at=float(data.get("queuedAt", 0.0)
                            or data.get("enqueuedAt", 0.0)),
            claimed_at=data.get("claimedAt"),
            attempts=int(data.get("attempts", 0)),
            error=data.get("error"),
            error_kind=data.get("errorKind"),
            done_at=data.get("doneAt"),
            warm=bool(data.get("warm", False)),
            epoch=int(data.get("epoch", 0)),
            owner=data.get("owner"),
            not_before=float(data.get("notBefore", 0.0)),
            settled_epoch=data.get("settledEpoch"),
            cost_s=float(data.get("costS", 0.0) or 0.0),
            src_digest=data.get("srcDigest"),
        )


class DurableQueue:
    """Crash-recoverable on-disk job queue with plan-hash dedup, safe
    for N replica processes over one root (module doc).

    Thread-safe: the scheduler's workers, the heartbeat thread and the
    HTTP submit path hit it concurrently. All disk MUTATIONS happen
    under the in-process lock AND the cross-process flock — the record
    files are small and each rewrite is one replace; a torn
    in-memory/on-disk split (or a peer interleaving mid-transition)
    would be worse than the contention."""

    def __init__(self, root: str, replica: Optional[str] = None,
                 lease_s: float = 15.0) -> None:
        self.root = os.path.abspath(root)
        self.jobs_dir = os.path.join(self.root, "jobs")
        os.makedirs(self.jobs_dir, exist_ok=True)
        self.replica = replica or (
            f"{_HOST}-{os.getpid()}-{secrets.token_hex(3)}"
        )
        self.lease_s = max(0.05, float(lease_s))
        self._lock = lockdebug.make_lock("serve_queue")
        # chainlint: disable=atomic-write (lock file: only its existence matters — flock state lives in the kernel, never in its bytes)
        self._lockfd = os.open(
            os.path.join(self.root, "queue.lock"),
            os.O_CREAT | os.O_RDWR, 0o644,
        )
        self._jobs: dict[str, JobRecord] = {}     # guarded-by: _lock
        self._by_plan: dict[str, str] = {}        # guarded-by: _lock
        self._queued: dict[str, JobRecord] = {}   # guarded-by: _lock
        self._running: dict[str, JobRecord] = {}  # guarded-by: _lock
        #: job id -> epoch THIS replica claimed; the fencing token a
        #: settle compares against the on-disk record. Kept on lease
        #: loss (the evidence a zombie's settle is fenced WITH), popped
        #: only when the settle verdict lands.
        self._claimed: dict[str, int] = {}        # guarded-by: _lock
        #: record-file stat signatures for the poll() rescan
        self._stat: dict[str, tuple] = {}         # guarded-by: _lock
        self._last_refresh = 0.0                  # guarded-by: _lock
        self._next_id = 1                         # guarded-by: _lock
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.recovery: dict = {"jobs": 0, "requeued": 0, "done": 0,
                               "failed": 0, "quarantined": 0, "peer": 0}
        with _REPLICAS_LOCK:
            _LIVE_REPLICAS.add(self.replica)
        try:
            #: incarnation counter for THIS replica id over this root,
            #: bumped durably on every open: a stable --replica-id that
            #: restarts shows up in /status and the span journal as the
            #: same name with a fresh epoch, so fleet views and traces
            #: can tell generations apart (chaos restarts, bounces)
            self.replica_epoch = self._bump_replica_epoch()
            self.spans = SpanJournal(
                os.path.join(self.root, "spans"), self.replica,
                replica_epoch=self.replica_epoch,
            )
            self._recover()
        except BaseException:
            # a constructor that dies (disk failure mid-recovery, or
            # the crashcheck harness's injected deaths) must not leak
            # its liveness claims: a name left in _LIVE_REPLICAS would
            # make this replica's stale leases look alive forever
            with _REPLICAS_LOCK:
                _LIVE_REPLICAS.discard(self.replica)
            fd, self._lockfd = self._lockfd, -1
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
            raise

    def _bump_replica_epoch(self) -> int:
        path = os.path.join(
            self.root, "replica-epochs",
            safe_replica_name(self.replica) + ".json",
        )
        with self._lock:
            with self._flock():
                try:
                    with open(path) as f:
                        epoch = int(json.load(f).get("epoch", 0)) + 1
                except (OSError, ValueError, TypeError):
                    epoch = 1
                try:
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    atomic_write_json(path, {"epoch": epoch})
                except OSError:
                    pass  # identity bookkeeping must not block startup
        return epoch

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        """Release this replica's liveness claims: stop the heartbeat,
        unregister from the in-process liveness set, drop the lock fd.
        After close() this replica's leases are reclaimable by peers
        (and by a successor queue in this same process — the restart
        path tests exercise). Idempotent; mutating calls after close
        raise OSError."""
        self.stop_heartbeat()
        with _REPLICAS_LOCK:
            _LIVE_REPLICAS.discard(self.replica)
        self.spans.close()
        fd, self._lockfd = self._lockfd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass

    def start_heartbeat(self, interval_s: Optional[float] = None) -> None:
        """Renew this replica's leases periodically (lease_s/3 default).
        Without a heartbeat a long execution outlives its lease and a
        peer may steal it mid-flight — fine for single-replica tests,
        wrong for a fleet."""
        if self._hb_thread is not None:
            return
        interval = interval_s if interval_s is not None else \
            max(0.05, self.lease_s / 3.0)
        self._hb_stop.clear()

        def _loop() -> None:
            while not self._hb_stop.wait(timeout=interval):
                try:
                    self.renew_leases()
                except Exception:  # noqa: BLE001 - heartbeat must survive disk hiccups
                    get_logger().exception(
                        "serve queue: lease renewal pass failed")

        self._hb_thread = threading.Thread(
            target=_loop, name="chain-serve-lease-heartbeat", daemon=True,
        )
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None

    # ----------------------------------------------------------- layout

    def _record_path(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, job_id + ".json")

    def _sentinel_path(self, job_id: str) -> str:
        return self._record_path(job_id) + ".inprogress"

    @contextmanager
    def _flock(self) -> Iterator[None]:
        """Cross-process mutual exclusion for record transitions. Only
        ever taken under self._lock (one fd per process: flock on the
        same open file description is recursive, so in-process nesting
        MUST be prevented by the thread lock, not the kernel). The
        kernel releases it when the holder dies, so a SIGKILLed replica
        can never wedge the fleet; a SIGSTOPped one stalls peers only
        for the (sub-millisecond) critical sections, not for the length
        of its executions — leases cover those."""
        if self._lockfd < 0:
            raise OSError("queue is closed")
        fcntl.flock(self._lockfd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(self._lockfd, fcntl.LOCK_UN)

    @contextmanager
    def exclusive(self) -> Iterator[None]:
        """The queue's cross-process mutual exclusion, lent out for
        fleet-level decisions that need the same fence — the service's
        orphan-request adoption claims a dead peer's request doc under
        it, so two surviving replicas cannot both adopt one orphan.
        Keep the body to a read-check-write; peers' queue mutations
        wait behind it."""
        with self._lock:
            with self._flock():
                yield

    # holds-lock: _lock
    def _persist(self, record: JobRecord) -> None:
        path = self._record_path(record.job_id)
        atomic_write_json(path, record.to_json(), durable=True,
                          sort_keys=True)
        try:
            st = os.stat(path)
        except OSError:
            return
        self._stat[record.job_id] = (st.st_mtime_ns, st.st_size, st.st_ino)

    # holds-lock: _lock
    def _read_disk(self, job_id: str) -> Optional[JobRecord]:
        """The on-disk record — the shared truth a settle is fenced
        against. None when unreadable/missing (the in-memory copy then
        stands in)."""
        try:
            with open(self._record_path(job_id)) as f:
                return JobRecord.from_json(json.load(f))
        except (OSError, ValueError, KeyError):
            return None

    # ------------------------------------------------------------ leases

    # holds-lock: _lock
    def _write_lease(self, record: JobRecord) -> None:
        now = time.time()
        atomic_write_json(self._sentinel_path(record.job_id), {
            "replica": self.replica,
            "epoch": record.epoch,
            "pid": os.getpid(),
            "host": _HOST,
            "acquiredAt": now,
            "expiresAt": now + self.lease_s,
        })

    # holds-lock: _lock
    def _read_lease(self, job_id: str) -> Optional[dict]:
        """The lease next to a record: a dict, {} for a legacy empty
        sentinel (pre-lease format: ownerless), None when absent."""
        try:
            with open(self._sentinel_path(job_id)) as f:
                text = f.read()
        except OSError:
            return None
        if not text.strip():
            return {}
        try:
            lease = json.loads(text)
        except ValueError:
            return {}
        return lease if isinstance(lease, dict) else {}

    # holds-lock: _lock
    def _lease_dead(self, lease: Optional[dict], now: float,
                    job_id: str) -> bool:
        """True when a lease no longer protects its record. Expiry is
        the universal trigger (a live-but-stuck holder loses after
        lease_s without renewal — the SIGSTOP-zombie case); same-host
        holders that are demonstrably dead (pid gone, or a previous
        incarnation in this very process) are reclaimed immediately so
        a daemon restart never waits out its own stale lease."""
        if not lease:  # absent or legacy empty sentinel: ownerless
            return True
        if lease.get("replica") == self.replica:
            # our NAME — but a stable --replica-id survives restarts,
            # so the name alone proves nothing: the lease is ours only
            # if we hold the exact claim it records. A previous
            # incarnation's lease under our name is dead NOW, not
            # after expiry.
            try:
                lease_epoch = int(lease.get("epoch", -1))
            except (TypeError, ValueError):
                return True
            return self._claimed.get(job_id) != lease_epoch
        if now >= float(lease.get("expiresAt", 0.0) or 0.0):
            return True
        if lease.get("host") == _HOST:
            try:
                pid = int(lease.get("pid", 0) or 0)
            except (TypeError, ValueError):
                return True
            if pid == os.getpid():
                with _REPLICAS_LOCK:
                    return lease.get("replica") not in _LIVE_REPLICAS
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True
            except OSError:
                pass  # EPERM etc: the pid exists — trust the expiry
        return False

    def renew_leases(self) -> list[str]:
        """One heartbeat pass: extend every lease this replica still
        holds; report (and emit `serve_lease_lost` for) records whose
        lease moved on — the settle for those will be fenced."""
        lost: list[tuple] = []
        with self._lock:
            with self._flock():
                for job_id, record in list(self._running.items()):
                    lease = self._read_lease(job_id)
                    if (lease and lease.get("replica") == self.replica
                            and int(lease.get("epoch", -1))
                            == self._claimed.get(job_id)):
                        try:
                            self._write_lease(record)
                        except OSError:
                            get_logger().warning(
                                "serve queue: could not renew lease for %s",
                                job_id)
                    else:
                        # stolen (or vandalized): we no longer own this
                        # execution; keep _claimed so the settle fences
                        self._running.pop(job_id, None)
                        lost.append((job_id, record.plan_hash))
        for job_id, plan in lost:
            tm.emit("serve_lease_lost", job=job_id, plan=plan,
                    replica=self.replica)
        return [job_id for job_id, _ in lost]

    # ---------------------------------------------------------- indexes

    # holds-lock: _lock
    def _absorb(self, record: JobRecord) -> None:
        """Reconcile the in-memory view with one record instance (fresh
        from disk or just persisted). Ownership bookkeeping: a record
        stays in _running only while the epoch we claimed still matches
        — an epoch that moved on means a peer stole it."""
        job_id = record.job_id
        self._jobs[job_id] = record
        if record.state == "queued":
            self._queued[job_id] = record
        else:
            self._queued.pop(job_id, None)
        if (record.state == "running"
                and self._claimed.get(job_id) == record.epoch):
            self._running[job_id] = record
        else:
            self._running.pop(job_id, None)
        cur_id = self._by_plan.get(record.plan_hash)
        if cur_id is None or cur_id == job_id:
            self._by_plan[record.plan_hash] = job_id
        elif (self._jobs[cur_id].state in ("failed", "quarantined")
                and record.state not in ("failed", "quarantined")):
            # a live record for the plan beats a dead-ended one
            self._by_plan[record.plan_hash] = job_id

    # holds-lock: _lock
    def _set_depth_gauge(self) -> None:
        _QUEUE_DEPTH.set(len(self._queued))

    # --------------------------------------------------------- recovery

    def _recover(self) -> None:
        """Rebuild the in-memory view from disk. A `running` record is
        requeued (attempts+1) only when its lease is reclaimable — the
        holder is dead or the lease expired; a record legitimately
        owned by a LIVE peer replica stays running in our view (we are
        one daemon of a fleet, not the only survivor). The artifact
        store decides at execution time whether requeued work actually
        completed (a commit that landed before the kill is a warm hit,
        zero re-execution)."""
        log = get_logger()
        events: list[dict] = []
        with self._lock:
            with self._flock():
                try:
                    names = sorted(os.listdir(self.jobs_dir))
                except OSError:
                    names = []
                max_seq = 0
                now = time.time()
                for name in names:
                    if not name.endswith(".json"):
                        continue
                    path = os.path.join(self.jobs_dir, name)
                    try:
                        with open(path) as f:
                            record = JobRecord.from_json(json.load(f))
                    except (OSError, ValueError, KeyError) as exc:
                        log.warning("serve queue: unreadable record %s "
                                    "(%s); skipping", path, exc)
                        continue
                    seq = _id_seq(record.job_id)
                    max_seq = max(max_seq, seq)
                    lease = self._read_lease(record.job_id)
                    requeue = False
                    if record.state == "running":
                        # lease dead or missing: the execution died with
                        # its daemon (a missing lease also covers a
                        # crash between the record write and the lease
                        # write). A live peer's lease keeps it running.
                        if self._lease_dead(lease, now, record.job_id):
                            requeue = True
                        else:
                            self.recovery["peer"] += 1
                    elif lease is not None:
                        # stray lease on a settled/queued record: the
                        # settle's unlink raced a crash — clear it so
                        # the steal scan never trips on it
                        self._clear_sentinel(record.job_id)
                    if requeue:
                        # queue-transition: running -> queued (crash recovery: an interrupted execution re-arms)
                        record.state = "queued"
                        record.epoch += 1  # fence the dead owner's settle
                        record.owner = None
                        record.attempts += 1
                        record.error = None
                        record.queued_at = now
                        record.claimed_at = None
                        # span BEFORE persist (spans.py ordering rule)
                        self.spans.append(
                            "requeue", job=record.job_id,
                            plan=record.plan_hash, state="queued",
                            epoch=record.epoch, requests=record.requests,
                            traces=record.trace_ids, reason="recovery",
                            attempts=record.attempts,
                        )
                        self._persist(record)
                        self._clear_sentinel(record.job_id)
                        self.recovery["requeued"] += 1
                        events.append(dict(job=record.job_id,
                                           plan=record.plan_hash,
                                           attempts=record.attempts))
                    self.recovery["jobs"] += 1
                    for state in ("done", "failed", "quarantined"):
                        if record.state == state:
                            self.recovery[state] += 1
                    self._absorb(record)
                    try:
                        st = os.stat(path)
                        self._stat[record.job_id] = (
                            st.st_mtime_ns, st.st_size, st.st_ino)
                    except OSError:
                        pass
                self._next_id = max_seq + 1
                self._set_depth_gauge()
        for fields in events:
            tm.emit("serve_requeued", **fields)
        if self.recovery["requeued"]:
            log.warning(
                "serve queue: requeued %d interrupted job(s) after restart",
                self.recovery["requeued"],
            )

    # ------------------------------------------------------------- poll

    def poll(self) -> dict:
        """Multi-replica maintenance tick: merge peer record changes
        into the in-memory view, then reclaim records whose lease died
        (work stealing). Cheap when nothing changed — one stat per
        record file. Single-replica daemons may skip it entirely."""
        with self._lock:
            changed = self._refresh_locked()
        stolen = self._steal_dead_leases()
        return {"changed": changed, "stolen": stolen}

    # holds-lock: _lock
    def _refresh_locked(self) -> int:
        changed = 0
        self._last_refresh = time.time()
        try:
            names = os.listdir(self.jobs_dir)
        except OSError:
            return 0
        seen: set = set()
        for name in names:
            if not name.endswith(".json"):
                continue
            job_id = name[:-5]
            seen.add(job_id)
            path = os.path.join(self.jobs_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            sig = (st.st_mtime_ns, st.st_size, st.st_ino)
            if self._stat.get(job_id) == sig:
                continue
            try:
                with open(path) as f:
                    record = JobRecord.from_json(json.load(f))
            except (OSError, ValueError, KeyError):
                continue  # mid-replace or poisoned: next poll retries
            self._stat[job_id] = sig
            self._absorb(record)
            if _id_seq(job_id) >= self._next_id:
                self._next_id = _id_seq(job_id) + 1
            changed += 1
        # records whose file vanished (peer retention/cleanup) leave
        # the view — except ones we have claimed, whose settle verdict
        # is still owed
        for job_id in list(self._jobs):
            if job_id in seen or job_id in self._claimed:
                continue
            record = self._jobs.pop(job_id)
            self._queued.pop(job_id, None)
            self._running.pop(job_id, None)
            self._stat.pop(job_id, None)
            if self._by_plan.get(record.plan_hash) == job_id:
                self._by_plan.pop(record.plan_hash, None)
        if changed:
            self._set_depth_gauge()
        return changed

    def _steal_dead_leases(self) -> int:
        """Reclaim running records whose lease no longer protects them:
        requeue with the epoch bumped, so the previous owner — dead, or
        a zombie about to resume — can never settle what it lost."""
        with self._lock:
            candidates = [
                job_id for job_id, rec in self._jobs.items()
                if rec.state == "running" and job_id not in self._running
            ]
        stolen: list[dict] = []
        for job_id in candidates:
            with self._lock:
                with self._flock():
                    disk = self._read_disk(job_id)
                    if disk is None:
                        continue
                    if disk.state != "running":
                        self._absorb(disk)
                        continue
                    lease = self._read_lease(job_id)
                    if not self._lease_dead(lease, time.time(), job_id):
                        continue
                    prev = (lease or {}).get("replica")
                    # queue-transition: running -> queued (lease steal: the owner died or stopped renewing)
                    disk.state = "queued"
                    disk.epoch += 1
                    disk.owner = None
                    disk.attempts += 1
                    disk.error = None
                    disk.queued_at = time.time()
                    disk.claimed_at = None
                    self.spans.append(
                        "steal", job=job_id, plan=disk.plan_hash,
                        state="queued", epoch=disk.epoch,
                        requests=disk.requests, traces=disk.trace_ids,
                        from_replica=prev, attempts=disk.attempts,
                    )
                    try:
                        self._persist(disk)
                    except OSError:
                        get_logger().exception(
                            "serve queue: could not persist steal of %s",
                            job_id)
                        continue
                    self._clear_sentinel(job_id)
                    self._absorb(disk)
                    self._set_depth_gauge()
                    stolen.append(dict(
                        job=job_id, plan=disk.plan_hash,
                        from_replica=prev, epoch=disk.epoch,
                        attempts=disk.attempts,
                    ))
        for fields in stolen:
            _LEASE_STEALS.inc()
            tm.emit("serve_lease_stolen", by=self.replica, **fields)
        return len(stolen)

    # ---------------------------------------------------------- enqueue

    def enqueue(
        self,
        plan_hash: str,
        plan: dict,
        unit: dict,
        tenant: str,
        priority: str,
        request_id: str,
        output: str,
        trace_id: Optional[str] = None,
        cost_s: float = 0.0,
        src_digest: Optional[str] = None,
    ) -> tuple[JobRecord, str]:
        """Enqueue one unit (or attach to its in-flight twin). Returns
        (record, outcome) with outcome ∈ new | attached | done |
        quarantined: `attached` = a queued/running job with this plan
        hash already exists and now also answers `request_id`; `done` =
        the record completed earlier (the caller should serve from the
        store — and re-enqueue via `rearm` if the store lost the
        bytes); `quarantined` = the plan failed permanently — or its
        SRC content digest sits in the poison registry — and will not
        retry until an operator re-arms it (the request is attached
        for forensics, nothing is scheduled)."""
        note: dict = {}
        record, outcome = self._enqueue_locked(
            plan_hash, plan, unit, tenant, priority, request_id, output,
            trace_id, cost_s, src_digest, note,
        )
        if note.get("poisoned"):
            # the record was swept through the poison edge inside the
            # locked section; telemetry is emitted HERE, outside the
            # queue lock (module convention — the span journal already
            # carries the transition)
            _QUARANTINED.inc()
            tm.emit("serve_quarantined", job=record.job_id,
                    plan=record.plan_hash, error=record.error,
                    attempts=record.attempts)
        return record, outcome

    def _enqueue_locked(
        self,
        plan_hash: str,
        plan: dict,
        unit: dict,
        tenant: str,
        priority: int,
        request_id: str,
        output: str,
        trace_id: Optional[str],
        cost_s: float,
        src_digest: Optional[str],
        note: dict,
    ) -> tuple[JobRecord, str]:

        def _attach_ids(record: JobRecord) -> bool:
            changed = False
            if request_id not in record.requests:
                record.requests.append(request_id)
                changed = True
            if trace_id and trace_id not in record.trace_ids:
                record.trace_ids.append(trace_id)
                changed = True
            if cost_s > record.cost_s:
                # a pre-cost-model record (or a fresher estimate) picks
                # up the caller's prediction on EVERY attach path, not
                # just re-arm — wave packing and outstanding_cost must
                # not treat a known-heavy in-flight unit as free
                record.cost_s = float(cost_s)
                changed = True
            if src_digest and record.src_digest != src_digest:
                record.src_digest = src_digest
                changed = True
            return changed

        with self._lock:
            with self._flock():
                poison = self._read_poison(src_digest) if src_digest \
                    else None
                existing_id = self._by_plan.get(plan_hash)
                if existing_id is None and \
                        time.time() - self._last_refresh > 0.25:
                    # unknown plan: a PEER may have minted its record
                    # since our last rescan — refresh (throttled: one
                    # stat-scan per burst, not per unit) before minting
                    # a twin. Dedup across replicas stays eventual (a
                    # miss inside the throttle window makes a duplicate
                    # record, never a duplicate artifact — the store's
                    # plan-hash commit is exactly-once regardless).
                    self._refresh_locked()
                    existing_id = self._by_plan.get(plan_hash)
                if existing_id is not None:
                    # disk is the shared truth: a peer may have moved
                    # the record since our last poll
                    record = self._read_disk(existing_id) or \
                        self._jobs[existing_id]
                    if record.state in _ATTACHABLE:
                        if poison is not None and record.state == "queued":
                            # poisoned SRC: this queued record must not
                            # wait out the scheduler just to rediscover
                            # the quarantine — fail it fast here
                            _attach_ids(record)
                            self._quarantine_poisoned_locked(record, poison)
                            note["poisoned"] = True
                            return record, "quarantined"
                        if _attach_ids(record):
                            self.spans.append(
                                "attach", job=record.job_id,
                                plan=record.plan_hash, state=record.state,
                                epoch=record.epoch,
                                requests=[request_id],
                                traces=[trace_id] if trace_id else [],
                            )
                            self._persist(record)
                        self._absorb(record)
                        return record, "attached"
                    if record.state == "done":
                        if _attach_ids(record):
                            self._persist(record)
                        self._absorb(record)
                        return record, "done"
                    if record.state == "quarantined":
                        # permanent failures do NOT auto-retry: attach
                        # for forensics, refuse until an operator rearms
                        if _attach_ids(record):
                            self._persist(record)
                        self._absorb(record)
                        return record, "quarantined"
                    # failed: re-arm the same record for a fresh attempt
                    # — with a fresh attempt BUDGET (a plan that
                    # exhausted its retries last week must not inherit
                    # the spent counter)
                    self._rearm_locked(record)
                    _attach_ids(record)  # also re-stamps cost_s
                    self.spans.append(
                        "enqueue", job=record.job_id,
                        plan=record.plan_hash, state="queued",
                        epoch=record.epoch, requests=record.requests,
                        traces=record.trace_ids, rearm=True,
                    )
                    if poison is not None:
                        # the plan would retry, but its SRC bytes are
                        # quarantined: park it through the declared
                        # poison-sweep edge instead of scheduling it
                        self._quarantine_poisoned_locked(record, poison)
                        note["poisoned"] = True
                        return record, "quarantined"
                    self._persist(record)
                    self._absorb(record)
                    self._set_depth_gauge()
                    return record, "new"
                # fresh plan: mint a record under an id no replica has
                # used (the probe matters — peers allocate from the
                # same namespace and our view of it may lag a poll)
                while os.path.exists(
                        self._record_path(f"j{self._next_id:06d}")):
                    self._next_id += 1
                now = time.time()
                record = JobRecord(
                    job_id=f"j{self._next_id:06d}",
                    plan_hash=plan_hash,
                    plan=plan,
                    unit=unit,
                    tenant=tenant,
                    priority=priority,
                    output=output,
                    requests=[request_id],
                    trace_ids=[trace_id] if trace_id else [],
                    state="queued",
                    enqueued_at=now,
                    queued_at=now,
                    cost_s=max(0.0, float(cost_s)),
                    src_digest=src_digest,
                )
                self._next_id += 1
                self.spans.append(
                    "enqueue", job=record.job_id, plan=plan_hash,
                    state="queued", epoch=record.epoch,
                    requests=record.requests, traces=record.trace_ids,
                    tenant=tenant, priority=priority,
                )
                if poison is not None:
                    # a fresh plan against a poisoned SRC: the record
                    # exists for forensics (which requests asked, what
                    # the poison verdict was) but parks immediately —
                    # fail-fast is the whole point of the digest
                    # registry (docs/ROBUSTNESS.md)
                    self._quarantine_poisoned_locked(record, poison)
                    note["poisoned"] = True
                    return record, "quarantined"
                self._persist(record)
                self._absorb(record)
                self._set_depth_gauge()
                return record, "new"

    # holds-lock: _lock
    def _rearm_locked(self, record: JobRecord) -> None:
        """Shared re-arm reset: a terminal record back to queued with a
        FRESH budget and clean forensics (no stale error/errorKind/
        settledEpoch from the settled life it just left)."""
        # queue-transition: done|failed|quarantined -> queued (re-arm: evicted artifact / fresh request / operator retry)
        record.state = "queued"
        record.error = None
        record.error_kind = None
        record.warm = False
        record.attempts = 0
        record.not_before = 0.0
        record.settled_epoch = None
        record.enqueued_at = time.time()
        record.queued_at = record.enqueued_at
        record.claimed_at = None

    def rearm(self, job_id: str) -> Optional[JobRecord]:
        """Force a terminal record back to queued: the store evicted a
        done record's artifact, or an operator cleared a quarantine
        (docs/SERVE.md "Quarantine workflow"). No-op on queued/running
        records."""
        with self._lock:
            with self._flock():
                record = self._read_disk(job_id) or self._jobs.get(job_id)
                if record is None or record.state in _ATTACHABLE:
                    return record
                self._rearm_locked(record)
                self.spans.append(
                    "enqueue", job=record.job_id, plan=record.plan_hash,
                    state="queued", epoch=record.epoch,
                    requests=record.requests, traces=record.trace_ids,
                    rearm=True,
                )
                self._persist(record)
                self._absorb(record)
                self._set_depth_gauge()
                return record

    # -------------------------------------------------- poison registry
    #
    # One JSON file per quarantined SRC content digest under
    # <root>/poison/ — durable, shared by every replica over the root
    # (reads are whole-file; writes hold the flock like any queue
    # mutation). A digest lands here when an execution settles with the
    # `poison` failure kind (docs/SERVE.md "Failure taxonomy"): the SRC
    # BYTES are hostile, so every plan referencing them — any HRC, any
    # tenant, any replica — fails fast instead of rediscovering the
    # poison one retry budget at a time. `tools serve-admin poison`
    # is the operator surface (ls / rearm).

    def _poison_path(self, digest: str) -> str:
        return os.path.join(self.root, "poison", digest + ".json")

    # holds-lock: _lock
    def _read_poison(self, digest: str) -> Optional[dict]:
        try:
            with open(self._poison_path(digest)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    # holds-lock: _lock
    def _quarantine_poisoned_locked(self, record: JobRecord,
                                    poison: dict) -> None:
        """Park one queued record whose SRC digest is poisoned, through
        the declared poison-sweep edge. Telemetry stays with the
        callers (events must not be emitted under the queue lock)."""
        # queue-transition: queued -> quarantined (poison sweep: the record's SRC digest was quarantined fleet-wide)
        record.state = "quarantined"
        record.error = (
            f"SRC digest {record.src_digest} is quarantined: "
            f"{poison.get('error', 'poisoned input')}"
        )[:500]
        record.error_kind = "poison"
        record.done_at = time.time()
        record.settled_epoch = record.epoch
        self.spans.append(
            "quarantine", job=record.job_id, plan=record.plan_hash,
            state="quarantined", epoch=record.epoch,
            requests=record.requests, traces=record.trace_ids,
            error=record.error, kind="poison",
        )
        self._persist(record)
        self._clear_sentinel(record.job_id)
        self._absorb(record)
        self._set_depth_gauge()

    def poison_src(self, digest: str, src: Optional[str] = None,
                   error: str = "", by_job: Optional[str] = None
                   ) -> list[JobRecord]:
        """Quarantine one SRC content digest fleet-wide: register it
        durably, then sweep every QUEUED record carrying it through the
        declared poison edge (running records settle on their own — the
        epoch fence makes interfering with a live execution wrong).
        Returns the swept records so the caller can fail their
        waiters. Idempotent: re-poisoning an already-registered digest
        only re-runs the sweep."""
        if not digest:
            return []
        swept: list[JobRecord] = []
        with self._lock:
            with self._flock():
                path = self._poison_path(digest)
                existing = self._read_poison(digest)
                doc = existing or {
                    "digest": digest,
                    "src": src,
                    "error": str(error)[:500],
                    "job": by_job,
                    "poisonedAt": time.time(),
                }
                os.makedirs(os.path.dirname(path), exist_ok=True)
                atomic_write_json(path, doc, durable=True, sort_keys=True)
                self._refresh_locked()  # peers' records join the sweep
                for job_id, record in list(self._queued.items()):
                    if record.src_digest != digest:
                        continue
                    disk = self._read_disk(job_id) or record
                    if disk.state != "queued" or disk.src_digest != digest:
                        self._absorb(disk)
                        continue
                    self._quarantine_poisoned_locked(disk, doc)
                    swept.append(disk)
        if existing is None:
            # one counter tick / event per DIGEST, not per convicted
            # record: re-poisoning an already-registered digest (a
            # second attributed member of the same wave, a rearm that
            # re-convicts) only re-runs the sweep — the swept records
            # below still carry their own serve_quarantined forensics
            _SRC_POISONED.inc()
            tm.emit("serve_src_poisoned", digest=digest, src=src,
                    error=str(error)[:500], job=by_job,
                    swept=[r.job_id for r in swept])
        for record in swept:
            _QUARANTINED.inc()
            tm.emit("serve_quarantined", job=record.job_id,
                    plan=record.plan_hash, error=record.error,
                    attempts=record.attempts)
        return swept

    def src_poisoned(self, digest: str) -> Optional[dict]:
        """The poison registry entry for one digest (None = clean)."""
        if not digest:
            return None
        with self._lock:
            return self._read_poison(digest)

    def poisoned_digests(self) -> list[dict]:
        """Every registered poison entry (operator/admin surface)."""
        entries: list[dict] = []
        poison_dir = os.path.join(self.root, "poison")
        try:
            names = sorted(os.listdir(poison_dir))
        except OSError:
            return entries
        with self._lock:
            for name in names:
                if name.endswith(".json"):
                    doc = self._read_poison(name[:-5])
                    if doc is not None:
                        entries.append(doc)
        return entries

    def rearm_src(self, digest: str) -> dict:
        """Operator re-arm of one poisoned digest (docs/ROBUSTNESS.md
        "Quarantine & re-arm"): drop the registry entry, then re-arm
        every quarantined record that carries the digest so a fresh
        request (or the records' own waiters) can retry against the
        repaired SRC. Returns {"digest", "was_poisoned", "rearmed"}."""
        rearmed: list[str] = []
        with self._lock:
            with self._flock():
                was = self._read_poison(digest) is not None
                try:
                    os.unlink(self._poison_path(digest))
                except FileNotFoundError:
                    pass
                self._refresh_locked()
                for job_id, record in list(self._jobs.items()):
                    if record.src_digest != digest:
                        continue
                    disk = self._read_disk(job_id) or record
                    if disk.state != "quarantined":
                        continue
                    self._rearm_locked(disk)
                    self.spans.append(
                        "enqueue", job=disk.job_id, plan=disk.plan_hash,
                        state="queued", epoch=disk.epoch,
                        requests=disk.requests, traces=disk.trace_ids,
                        rearm=True,
                    )
                    self._persist(disk)
                    self._absorb(disk)
                    rearmed.append(job_id)
                self._set_depth_gauge()
        return {"digest": digest, "was_poisoned": was, "rearmed": rearmed}

    # ------------------------------------------------------- scheduling

    def queued_snapshot(self) -> list[JobRecord]:
        """Claim-eligible records: queued, and past their retry backoff
        (`not_before` — a transient failure's re-eligibility time)."""
        now = time.time()
        with self._lock:
            return sorted(
                (r for r in self._queued.values() if r.not_before <= now),
                key=lambda r: r.enqueued_at,
            )

    def claim(self, job_ids: list[str]) -> list[JobRecord]:
        """Move jobs queued → running (epoch bumped, lease down). Jobs
        another worker or replica claimed first are silently skipped —
        the returned list is what THIS caller owns. A disk failure
        (ENOSPC/EIO on the rewrite or the lease) mid-way through the
        list reverts THAT record to queued and stops claiming
        (`serve_claim_reverted`): the caller still owns everything
        claimed before it, so no record is ever stranded in 'running'
        with no owner while enqueue attaches newcomers to it."""
        owned: list[JobRecord] = []
        reverted: list[dict] = []
        waited: list[tuple] = []
        now = time.time()
        with self._lock:
            with self._flock():
                for job_id in job_ids:
                    if job_id not in self._queued:
                        continue
                    record = self._read_disk(job_id) or self._queued[job_id]
                    if record.state != "queued" or record.not_before > now:
                        self._absorb(record)  # peer moved it meanwhile
                        continue
                    wait_s = max(
                        0.0, now - (record.queued_at or record.enqueued_at)
                    )
                    try:
                        # queue-transition: queued -> running (claim: this worker owns the execution)
                        record.state = "running"
                        record.epoch += 1
                        record.owner = self.replica
                        record.claimed_at = now
                        self.spans.append(
                            "claim", job=job_id, plan=record.plan_hash,
                            state="running", epoch=record.epoch,
                            requests=record.requests,
                            traces=record.trace_ids,
                            queue_wait_s=round(wait_s, 6),
                            wave=len(job_ids),
                        )
                        self._persist(record)
                        self._write_lease(record)
                    except OSError:
                        # queue-transition: running -> queued (claim revert: the disk refused the rewrite/lease)
                        record.state = "queued"
                        record.epoch -= 1
                        record.owner = None
                        record.claimed_at = None
                        self.spans.append(
                            "revert", job=job_id, plan=record.plan_hash,
                            state="queued", epoch=record.epoch,
                            requests=record.requests,
                            traces=record.trace_ids,
                        )
                        try:
                            self._persist(record)
                        except OSError:
                            pass  # peers' steal scan reclaims the orphan
                        try:
                            self._clear_sentinel(job_id)
                        except OSError:  # the disk is already misbehaving
                            pass  # recovery treats a stray lease as dead
                        self._absorb(record)
                        reverted.append(dict(job=job_id,
                                             plan=record.plan_hash))
                        get_logger().exception(
                            "serve queue: claim of %s failed; reverted to "
                            "queued", job_id,
                        )
                        break
                    self._claimed[job_id] = record.epoch
                    self._absorb(record)
                    owned.append(record)
                    waited.append((record.tenant, record.priority, wait_s))
                self._set_depth_gauge()
        for tenant, priority, wait_s in waited:
            _QUEUE_WAIT.labels(tenant=tenant, priority=priority) \
                .observe(wait_s)
        for fields in reverted:
            _CLAIM_REVERTS.inc()
            tm.emit("serve_claim_reverted", replica=self.replica, **fields)
        return owned

    # ----------------------------------------------------------- settle

    # holds-lock: _lock
    def _fence_check(self, job_id: str, op: str) -> tuple:
        """(base_record, fenced_fields). Every settle starts here: the
        on-disk record's epoch must match the epoch THIS replica
        claimed, or the caller lost ownership (steal, recovery by a
        peer) while it executed — its verdict is refused and the record
        left exactly as the current owner's protocol put it."""
        record = self._jobs.get(job_id)
        if record is None:
            return None, None
        disk = self._read_disk(job_id)
        ours = self._claimed.get(job_id, record.epoch)
        if disk is not None and disk.epoch != ours:
            # NOTE: the stale _claimed entry is deliberately KEPT — it
            # is the memory that we lost this record. Popping it here
            # would let a SECOND settle attempt fall back to the
            # absorbed (current) epoch and sail through the fence. It
            # clears only on a successful settle or a fresh claim.
            self._running.pop(job_id, None)
            self._absorb(disk)
            return None, dict(job=job_id, plan=record.plan_hash, op=op,
                              held_epoch=ours, current_epoch=disk.epoch)
        base = disk if disk is not None else record
        # merge request attachments a peer may have added meanwhile —
        # our in-memory copy can lag the shared record
        for req_id in record.requests:
            if req_id not in base.requests:
                base.requests.append(req_id)
        self._claimed.pop(job_id, None)
        return base, None

    def complete(self, job_id: str, warm: bool = False) -> Optional[JobRecord]:
        """Settle a claimed job as done. Epoch-fenced: returns None
        (and emits `serve_settle_fenced`) when ownership moved on —
        a zombie replica resumed after SIGSTOP cannot settle a record
        a live peer stole from it."""
        fenced = None
        exec_obs: Optional[tuple] = None
        with self._lock:
            with self._flock():
                base, fenced = self._fence_check(job_id, "complete")
                if base is None and fenced is None:
                    return None
                if fenced is None:
                    self._running.pop(job_id, None)
                    # queue-transition: running -> done (execution or warm hit settled)
                    base.state = "done"
                    base.warm = warm
                    base.error = None
                    base.error_kind = None
                    base.done_at = time.time()
                    base.settled_epoch = base.epoch
                    exec_s = None
                    if base.claimed_at:
                        exec_s = max(0.0, base.done_at - base.claimed_at)
                        if not warm:
                            exec_obs = (base.tenant, base.priority, exec_s)
                    self.spans.append(
                        "complete", job=job_id, plan=base.plan_hash,
                        state="done", epoch=base.epoch,
                        requests=base.requests, traces=base.trace_ids,
                        warm=warm,
                        exec_s=round(exec_s, 6) if exec_s is not None
                        else None,
                    )
                    self._persist(base)
                    self._clear_sentinel(job_id)
                    self._absorb(base)
                    self._set_depth_gauge()
        if exec_obs is not None:
            _EXEC_SECONDS.labels(tenant=exec_obs[0],
                                 priority=exec_obs[1]).observe(exec_obs[2])
        if fenced is not None:
            self._fenced_span(fenced)
            _FENCED_SETTLES.inc()
            tm.emit("serve_settle_fenced", replica=self.replica, **fenced)
            return None
        return base

    def _fenced_span(self, fenced: dict) -> None:
        """Forensic span for a refused stale-epoch settle: not part of
        any record's gapless chain (nothing transitioned), but `tools
        trace show` renders it so a stolen request's timeline shows the
        zombie's verdict bouncing off the fence."""
        self.spans.append(
            "fenced", job=fenced["job"], plan=fenced["plan"],
            state="", epoch=fenced["current_epoch"],
            op=fenced["op"], held_epoch=fenced["held_epoch"],
        )

    def fail(self, job_id: str, error: str, requeue: bool = False,
             backoff_s: float = 0.0,
             kind: Optional[str] = None) -> Optional[JobRecord]:
        """Settle a claimed job as failed — or requeue it for a retry,
        eligible again only after `backoff_s` (exponential backoff with
        jitter is the SCHEDULER's policy; the queue just persists
        `not_before` so the whole replica fleet honors it). Epoch-fenced
        like complete()."""
        fenced = None
        with self._lock:
            with self._flock():
                base, fenced = self._fence_check(job_id, "fail")
                if base is None and fenced is None:
                    return None
                if fenced is None:
                    self._running.pop(job_id, None)
                    base.error = str(error)[:500]
                    base.error_kind = kind
                    if requeue:
                        # queue-transition: running -> queued (retry: attempts budget not exhausted; not_before backoff)
                        base.state = "queued"
                        base.attempts += 1
                        base.owner = None
                        base.not_before = time.time() + max(0.0, backoff_s)
                        base.queued_at = time.time()
                        base.claimed_at = None
                        self.spans.append(
                            "requeue", job=job_id, plan=base.plan_hash,
                            state="queued", epoch=base.epoch,
                            requests=base.requests, traces=base.trace_ids,
                            reason="retry", attempts=base.attempts,
                            backoff_s=round(max(0.0, backoff_s), 3),
                            error=base.error, kind=kind,
                        )
                    else:
                        # queue-transition: running -> failed (attempts budget exhausted)
                        base.state = "failed"
                        base.done_at = time.time()
                        base.settled_epoch = base.epoch
                        self.spans.append(
                            "fail", job=job_id, plan=base.plan_hash,
                            state="failed", epoch=base.epoch,
                            requests=base.requests, traces=base.trace_ids,
                            error=base.error, kind=kind,
                        )
                    self._persist(base)
                    self._clear_sentinel(job_id)
                    self._absorb(base)
                    self._set_depth_gauge()
        if fenced is not None:
            self._fenced_span(fenced)
            _FENCED_SETTLES.inc()
            tm.emit("serve_settle_fenced", replica=self.replica, **fenced)
            return None
        return base

    def quarantine(self, job_id: str, error: str,
                   kind: str = "permanent") -> Optional[JobRecord]:
        """Settle a claimed job as PERMANENTLY failed: no retry will
        change the outcome (bad params, corrupt SRC), so the plan is
        parked with its forensics instead of burning the attempts
        budget. Only `rearm` (the operator workflow) resurrects it.
        Epoch-fenced like complete()."""
        fenced = None
        with self._lock:
            with self._flock():
                base, fenced = self._fence_check(job_id, "quarantine")
                if base is None and fenced is None:
                    return None
                if fenced is None:
                    self._running.pop(job_id, None)
                    # queue-transition: running -> quarantined (permanent failure: retrying is futile)
                    base.state = "quarantined"
                    base.error = str(error)[:500]
                    base.error_kind = kind
                    base.done_at = time.time()
                    base.settled_epoch = base.epoch
                    self.spans.append(
                        "quarantine", job=job_id, plan=base.plan_hash,
                        state="quarantined", epoch=base.epoch,
                        requests=base.requests, traces=base.trace_ids,
                        error=base.error, kind=kind,
                    )
                    self._persist(base)
                    self._clear_sentinel(job_id)
                    self._absorb(base)
                    self._set_depth_gauge()
        if fenced is not None:
            self._fenced_span(fenced)
            _FENCED_SETTLES.inc()
            tm.emit("serve_settle_fenced", replica=self.replica, **fenced)
            return None
        _QUARANTINED.inc()
        tm.emit("serve_quarantined", job=job_id, plan=base.plan_hash,
                error=base.error, attempts=base.attempts)
        return base

    # holds-lock: _lock
    def _clear_sentinel(self, job_id: str) -> None:
        try:
            os.unlink(self._sentinel_path(job_id))
        except FileNotFoundError:
            pass

    # ------------------------------------------------------------ views

    def record(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            return self._jobs.get(job_id)

    def by_plan(self, plan_hash: str) -> Optional[JobRecord]:
        with self._lock:
            job_id = self._by_plan.get(plan_hash)
            return self._jobs.get(job_id) if job_id else None

    def counts(self) -> dict:
        with self._lock:
            states: dict[str, int] = {}
            for record in self._jobs.values():
                states[record.state] = states.get(record.state, 0) + 1
            return states

    def outstanding_cost(self, tenant: Optional[str] = None) -> float:
        """Predicted seconds of unfinished (queued + running) work, for
        one tenant or the whole queue — the admission gate's view of a
        tenant's backlog (serve/cost.py). Reads this replica's merged
        view of the shared records: cross-replica freshness is bounded
        by the poll interval, which is the admission contract
        (docs/SERVE.md 'Cost-aware scheduling & admission')."""
        with self._lock:
            return sum(
                record.cost_s
                for source in (self._queued, self._running)
                for record in source.values()
                if tenant is None or record.tenant == tenant
            )

    def backlog(self) -> dict:
        """Queued (not yet claimed) work per priority class — record
        counts plus predicted seconds — the autoscale advisor's
        per-class input (serve/autoscale.py): which class is waiting
        picks how fast the fleet must drain."""
        with self._lock:
            out: dict[str, dict] = {}
            for record in self._queued.values():
                cls = out.setdefault(record.priority,
                                     {"count": 0, "cost_s": 0.0})
                cls["count"] += 1
                cls["cost_s"] += record.cost_s
            for cls in out.values():
                cls["cost_s"] = round(cls["cost_s"], 3)
            return out
