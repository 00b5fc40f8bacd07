"""The chain-serve daemon: HTTP front door, queue, scheduler, store
(trimmed port of processing_chain_tpu/serve/service.py).

Left out of the port, each a no-op at the reference's defaults (all
budgets None, one replica): the alert engine and autoscale advisor, the
cost ledger and admission budgets, the store heat ledger, store pressure
and GC, the /fleet routes and the cross-replica orphan-request sweep.

One `ChainServeService` owns the whole serving stack rooted at one
directory:

    root/
      queue/jobs/*.json        durable job records (+ .inprogress sentinels)
      requests/*.json          request records (atomic rewrites)
      artifacts/               materialized outputs (store-hardlinked)
      store/                   the content-addressed artifact store
      serve-info.json          {pid, port, url} for operators/scripts

HTTP surface — ONE LiveServer (telemetry/live.py route registry), so
the observability endpoints and the serving API share a port, a thread
pool and a shutdown story:

    GET  /healthz /metrics /status     the observability triple
         (/status?request=<id> scopes the serve section to one request)
    POST /v1/requests                  submit a processing request
    GET  /v1/requests                  list requests
    GET  /v1/requests/<id>             one request with per-unit states
    GET  /v1/artifacts/<plan_hash>     artifact bytes from the store
    POST /v1/drain                     drain ({}) or resume ({"resume": true})

Identity and dedup: a unit's plan hash (store/keys) is its name
everywhere — queue dedup key, store commit key, artifact URL. Request
overlap therefore collapses BEFORE execution: a unit already in the
store answers warm in milliseconds; one queued or running attaches; and
only genuinely novel plans execute, exactly once (docs/SERVE.md).

The engine's global store slot (store/runtime) is configured to the
serve store at construction: one service per process at a time — or
several REPLICAS of one root in one process (the fleet-shaped tests),
which share the same store root and so agree on the slot.

Multi-replica: any number of services (in any number of processes) may
share one root. Queue ownership is lease-fenced (serve/queue.py), and
the maintenance tick propagates peer executions into this replica's
request bookkeeping (docs/SERVE.md "Running multiple replicas").
"""

from __future__ import annotations

import json
import os
import re
import secrets
import threading
import time
from typing import NamedTuple, Optional

from .. import telemetry as tm
from ..parallel import meshobs
from ..store import runtime as store_runtime
from ..store.store import StoreCorruption
from ..telemetry import catalog as tm_catalog
from ..telemetry import watchdog as tm_watchdog
from ..telemetry import live
from ..utils import lockdebug
from ..utils.fsio import atomic_write_json
from ..utils.log import get_logger
from . import api
from .executors import make_executor
from .queue import DurableQueue, owner_stamp
from .scheduler import Scheduler

_REQ_TOTAL = tm.counter(
    "chain_serve_requests_total", "serve requests by terminal disposition",
    ("state",),
)
_UNITS = tm.counter(
    "chain_serve_units_total", "per-PVS units by enqueue outcome",
    ("outcome",),
)
_REQ_SECONDS = tm.histogram(
    "chain_serve_request_seconds", "request accept-to-complete latency"
)
_WARM_REQ_SECONDS = tm.histogram(
    "chain_serve_warm_request_seconds",
    "latency of requests answered entirely from the store",
)
_E2E_SECONDS = tm.histogram(
    "chain_serve_e2e_seconds",
    "request end-to-end latency (submit to done), per tenant/priority "
    "— the SLO layer's third phase next to queue-wait and execution",
    ("tenant", "priority"),
    buckets=tm_catalog.SLO_LATENCY_BUCKETS,
)
_READ_TTFB_SECONDS = tm.histogram(
    "chain_serve_read_ttfb_seconds",
    "artifact read time-to-first-byte (request to headers+first chunk "
    "on the wire; a 304 observes here only), per tenant/size class — "
    "graded against READ_SLO_BANDS by the fleet view",
    ("tenant", "size_class"),
    buckets=tm_catalog.READ_LATENCY_BUCKETS,
)
_READ_SECONDS = tm.histogram(
    "chain_serve_read_seconds",
    "artifact full-stream read latency (request to last byte), per "
    "tenant/size class",
    ("tenant", "size_class"),
    buckets=tm_catalog.READ_LATENCY_BUCKETS,
)

_HASH_LEN = 64  # sha256 hex

# The reference's constructor defaults, fixed here: one replica per
# root, named by the queue, and its default lease.
_REQUEST_RETENTION = 10_000  # finished requests kept (memory and disk)
_POLL_S = 1.0                # maintenance tick


class _DoneState:
    """Stand-in for a queue record the queue no longer tracks: settled."""

    state = "done"


_DONE_SENTINEL = _DoneState()


class _PlanSettled(NamedTuple):
    """Record stand-in for cross-replica completion sweeps: all the
    waiter bookkeeping needs is the plan hash (and, for failures, the
    error text)."""

    plan_hash: str
    error: Optional[str] = None


class ChainServeService:
    """Composition root of the serve daemon (see module doc)."""

    def __init__(
        self,
        root: str,
        port: int = 0,
        host: Optional[str] = None,
        executor: str = "synthetic",
        workers: int = 2,
        wave_width: int = 4,
        store_root: Optional[str] = None,
        tenant_weights: Optional[dict] = None,
        max_attempts: int = 2,
        device=None,
    ) -> None:
        """`device` goes to the executor: the `wave` executor runs on it
        (None means `cuda:0`, and raises where CUDA is absent)."""
        self.root = os.path.abspath(root)
        self.artifacts_root = os.path.join(self.root, "artifacts")
        self.requests_dir = os.path.join(self.root, "requests")
        for d in (self.root, self.artifacts_root, self.requests_dir):
            os.makedirs(d, exist_ok=True)
        # the serve surface IS telemetry: /metrics must render, job
        # accounting must count — enable before anything registers
        tm.enable()
        self.executor = make_executor(executor, device=device)
        self.store = store_runtime.configure(
            store_root or os.path.join(self.root, "store"))
        self.queue = DurableQueue(os.path.join(self.root, "queue"))
        self.replica = self.queue.replica
        # the device-plane flight recorder (parallel/meshobs.py): the
        # wave executor records into this root's journal under this
        # replica's name
        meshobs.attach_journal(
            meshobs.mesh_dir(self.root), replica=self.replica
        )
        self.info_path = os.path.join(self.root, "serve-info.json")
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._lock = lockdebug.make_lock("serve_service")
        #: request docs; each active one carries a non-persisted
        #: "_pending" set of plan hashes still outstanding, maintained by
        #: submit/_on_job_done so completion checks never re-verify the
        #: store under this lock
        self._requests: dict[str, dict] = {}   # guarded-by: _lock
        #: plan hash -> request ids still waiting on it
        self._plan_waiters: dict[str, set] = {}  # guarded-by: _lock
        self.scheduler = Scheduler(
            self.queue, self.executor, self.artifacts_root,
            workers=workers, wave_width=wave_width,
            tenant_weights=tenant_weights, max_attempts=max_attempts,
            on_done=self._on_job_done, on_failed=self._on_job_failed,
        )
        #: graceful drain (docs/SERVE.md "Draining a replica"): while
        #: True the scheduler claims nothing; flipped by POST /v1/drain
        #: or SIGUSR1, reported by /healthz and serve-info
        self._draining = False               # guarded-by: _lock
        self._t0 = time.monotonic()
        routes = live.default_routes()
        routes.add("/v1/requests", self._h_requests, methods=("GET", "POST"))
        routes.add_prefix("/v1/requests/", self._h_request)
        routes.add_prefix("/v1/artifacts/", self._h_artifact)
        routes.add("/v1/drain", self._h_drain, methods=("POST",))
        # replaces the default liveness route: same shape, plus the
        # replica's drain state — a draining replica is still HEALTHY
        # (200), it is just not claiming work
        routes.add("/healthz", self._h_healthz)
        self.server = live.LiveServer(port, host=host, routes=routes)
        self._recover_requests()

    # --------------------------------------------------------- lifecycle

    def start(self) -> "ChainServeService":
        live.STATUS_PROVIDERS["serve"] = self._status_section
        self.server.start()
        self.queue.start_heartbeat()
        self.scheduler.start()
        self._poll_stop.clear()
        self._poll_thread = threading.Thread(
            target=self._maintenance_loop,
            name="chain-serve-maintenance", daemon=True,
        )
        self._poll_thread.start()
        self._write_info()
        get_logger().info(
            "chain-serve: %s (root %s, replica %s, executor %s, queue: %s)",
            self.server.url, self.root, self.replica, self.executor.kind,
            self.queue.recovery,
        )
        return self

    def _write_info(self) -> None:
        with self._lock:
            state = "draining" if self._draining else "ok"
        atomic_write_json(self.info_path, {
            "pid": os.getpid(),
            "port": self.server.port,
            "url": self.server.url,
            "root": self.root,
            "executor": self.executor.kind,
            "replica": self.replica,
            "replica_epoch": self.queue.replica_epoch,
            "store": self.store.root,
            "state": state,
        })

    def drain(self) -> dict:
        """Flip this replica to draining (docs/SERVE.md "Draining a
        replica"): the scheduler stops claiming, in-flight waves finish
        and settle normally, queued work stays for peers (or for
        resume()). Idempotent; reported by /healthz and serve-info."""
        with self._lock:
            was = self._draining
            self._draining = True
        if not was:
            self.scheduler.drain()
            self._write_info()
            tm.emit("serve_drain", replica=self.replica,
                    state="draining")
            get_logger().info("chain-serve: replica %s draining",
                              self.replica)
        return {"replica": self.replica, "state": "draining"}

    def resume(self) -> dict:
        """Rejoin after a drain: the scheduler claims again with its
        next wake. Idempotent."""
        with self._lock:
            was = self._draining
            self._draining = False
        if was:
            self.scheduler.resume()
            self._write_info()
            tm.emit("serve_drain", replica=self.replica, state="ok")
            get_logger().info("chain-serve: replica %s resumed",
                              self.replica)
        return {"replica": self.replica, "state": "ok"}

    def stop(self) -> None:
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=10.0)
            self._poll_thread = None
        self.scheduler.stop()
        self.server.stop()
        live.STATUS_PROVIDERS.pop("serve", None)
        # releases this replica's leases/liveness so a successor (or a
        # peer) can reclaim any still-running work immediately
        self.queue.close()
        if self.store is not None:
            self.store.digests.save()

    # ------------------------------------------------------- maintenance

    def _maintenance_loop(self) -> None:
        """The replica tick: merge peer queue changes, steal dead leases
        (waking our scheduler for the reclaimed work), and settle
        requests whose plans completed outside this replica's scheduler
        callbacks."""
        while not self._poll_stop.wait(timeout=_POLL_S):
            try:
                result = self.queue.poll()
                if result.get("stolen") or result.get("changed"):
                    self.scheduler.notify()
                self._sweep_remote_settlements()
            except Exception:  # noqa: BLE001 - the tick must survive disk hiccups
                get_logger().exception(
                    "chain-serve: maintenance tick failed")

    def _sweep_remote_settlements(self) -> None:
        with self._lock:
            waited = list(self._plan_waiters)
        for plan_hash in waited:
            record = self.queue.by_plan(plan_hash)
            if record is not None and record.state == "done":
                self._on_job_done(record)
            elif record is not None and record.state in (
                    "failed", "quarantined"):
                self._on_job_failed(record)
            elif record is None and self._plan_is_done(plan_hash):
                # no queue record but the store holds verified bytes: a
                # peer executed and its record left our view
                self._on_job_done(_PlanSettled(plan_hash))

    def __enter__(self) -> "ChainServeService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------- recovery

    def _recover_requests(self) -> None:
        """Reload persisted request records. Finished ones are indexed;
        every active one is ADOPTED (`_adopt_active`): waiters re-armed,
        units whose job record vanished (a crash between request
        persist and unit enqueue) re-enqueued, requests against
        quarantined plans failed with the forensics, and requests whose
        every unit meanwhile completed finalized now."""
        try:
            names = sorted(os.listdir(self.requests_dir))
        except OSError:
            names = []
        recovered_active = []
        with self._lock:
            for name in names:
                if not name.endswith(".json"):
                    continue
                path = os.path.join(self.requests_dir, name)
                try:
                    with open(path) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    get_logger().warning(
                        "serve: unreadable request record %s; skipping", path
                    )
                    continue
                if doc.get("state") == "active":
                    recovered_active.append(doc)  # adopted below
                else:
                    self._requests[doc["request"]] = doc
        for doc in recovered_active:
            self._adopt_active(doc)

    def _adopt_active(self, doc: dict) -> None:
        """Take responsibility for one active request record: re-arm
        its plan waiters, re-create lost enqueues, fail it against
        quarantined plans, finalize it if everything already settled.
        Restamps the ownership so peers stop probing it. Called at
        recovery (every active doc on disk) and from the maintenance
        tick (docs whose owning replica process died un-restarted)."""
        req_id = doc["request"]
        quarantine_error: Optional[str] = None
        with self._lock:
            if req_id in self._requests:
                return
            doc["owner"] = owner_stamp(self.replica)
            doc["_pending"] = set()
            self._requests[req_id] = doc
            for unit_doc in doc["units"].values():
                plan_hash = unit_doc["plan"]
                if self._plan_is_done(plan_hash):
                    continue
                doc["_pending"].add(plan_hash)
                self._plan_waiters.setdefault(plan_hash, set()).add(req_id)
                record = self.queue.by_plan(plan_hash)
                if record is None:
                    # enqueue lost to the crash: re-create it from the
                    # request record (it carries the full unit payload)
                    self.queue.enqueue(
                        plan_hash,
                        unit_doc["planPayload"],
                        unit_doc["unit"],
                        doc["tenant"], doc["priority"], req_id,
                        unit_doc["output"], trace_id=doc.get("trace"),
                        src_digest=unit_doc.get("src_digest")
                        or self.executor.src_digest(unit_doc["unit"]),
                    )
                elif record.state == "quarantined":
                    # the plan failed PERMANENTLY while the request
                    # never saw the verdict: deliver it now instead of
                    # re-arming work whose outcome is determined
                    # (docs/SERVE.md "Failure taxonomy")
                    quarantine_error = (record.error or
                                       "plan quarantined after permanent "
                                       "failure")
                else:
                    # the record may be 'failed' (crash before the
                    # request saw the failure) or 'done' with the
                    # artifact since evicted (the store check above said
                    # not-done): re-arm it, mirroring submit — otherwise
                    # nothing ever runs this plan and the adopted
                    # request pins it in 'active' forever. rearm is a
                    # no-op on queued/running records.
                    self.queue.rearm(record.job_id)
        if quarantine_error is not None:
            with self._lock:
                if doc["state"] == "active":
                    doc["state"] = "failed"
                    doc["done_at"] = time.time()
                    doc["error"] = quarantine_error
            self._persist_request(doc)
            _REQ_TOTAL.labels(state="failed").inc()
            tm.emit("serve_request_done", request=req_id,
                    trace_id=doc.get("trace"), status="failed",
                    error=quarantine_error)
            return
        self._persist_request(doc)  # the new owner stamp, durably
        self._check_request_done(req_id)

    # ------------------------------------------------------- submissions

    def submit(self, payload: object) -> dict:
        """Validate + enqueue one request; returns the acceptance doc.
        Raises api.RequestError on a bad document (handler → 400)."""
        t0 = time.perf_counter()
        try:
            normalized = api.validate_request(payload)
            # executor-specific params validate at the front door too: a
            # unit the executor cannot parse must 400 here, not become a
            # durable queue record that poisons the scheduler's packing
            # pass on every restart
            self.executor.validate_params(normalized["params"])
        except api.RequestError:
            _REQ_TOTAL.labels(state="rejected").inc()
            raise
        except ValueError as exc:
            _REQ_TOTAL.labels(state="rejected").inc()
            raise api.RequestError(str(exc)) from exc
        units = api.expand_units(normalized)
        req_id = "req-" + secrets.token_hex(5)
        # every request gets a trace id (client-supplied context wins):
        # the thread that ties request docs, queue records, span journal
        # and job events into one cross-replica timeline
        trace_id = normalized.get("trace") or api.new_trace_id()
        unit_docs: dict[str, dict] = {}
        plans: dict[str, dict] = {}
        try:
            for unit in units:
                # plan construction is part of the front door: the chain
                # executor resolves the grid against the database config
                # here, so a cell the database does not define is a 400,
                # never a durable record
                plan = self.executor.plan(unit)
                plan_hash = self.store.plan_hash(plan)
                record_unit = {
                    "database": unit.database, "src": unit.src,
                    "hrc": unit.hrc, "params": unit.params,
                    "pvs_id": unit.pvs_id,
                }
                unit_docs[unit.pvs_id] = {
                    "plan": plan_hash,
                    "planPayload": plan,
                    "output": self.executor.output_name(unit, plan_hash),
                    # the poison-quarantine key (docs/ROBUSTNESS.md):
                    # stamped at the front door so the queue record can
                    # fail fast against the digest registry at enqueue
                    "src_digest": self.executor.src_digest(record_unit),
                    "unit": record_unit,
                }
                plans[plan_hash] = unit_docs[unit.pvs_id]
        except api.RequestError:
            _REQ_TOTAL.labels(state="rejected").inc()
            raise
        # the warm set is computed once and reused by the enqueue loop
        warm_plans = {ph for ph in plans if self._plan_is_done(ph)}
        doc = {
            "request": req_id,
            "trace": trace_id,
            "tenant": normalized["tenant"],
            "priority": normalized["priority"],
            "database": normalized["database"],
            "created_at": time.time(),
            "units": unit_docs,
            "state": "active",
            "done_at": None,
            "latency_ms": None,
            "warm": False,
            # liveness stamp: the next service on this root adopts the
            # request if our process dies before finalizing it
            "owner": owner_stamp(self.replica),
        }
        # the request must be discoverable BEFORE its first unit can
        # complete, or a fast job's on_done would miss the waiter
        with self._lock:
            doc["_pending"] = set(plans)
            self._requests[req_id] = doc
            for plan_hash in plans:
                self._plan_waiters.setdefault(plan_hash, set()).add(req_id)
        self._persist_request(doc)
        outcomes = {"warm": 0, "enqueued": 0, "attached": 0,
                    "quarantined": 0}
        quarantine_error: Optional[str] = None
        for plan_hash, unit_doc in plans.items():
            if plan_hash in warm_plans:
                _UNITS.labels(outcome="warm").inc()
                outcomes["warm"] += 1
                with self._lock:
                    doc["_pending"].discard(plan_hash)
                    waiters = self._plan_waiters.get(plan_hash)
                    if waiters is not None:
                        waiters.discard(req_id)
                        if not waiters:
                            self._plan_waiters.pop(plan_hash, None)
                continue
            record, outcome = self.queue.enqueue(
                plan_hash, unit_doc["planPayload"], unit_doc["unit"],
                normalized["tenant"], normalized["priority"], req_id,
                unit_doc["output"], trace_id=trace_id,
                src_digest=unit_doc.get("src_digest"),
            )
            if outcome == "done":
                # the queue remembers a completion the store no longer
                # holds (evicted): re-arm the same record
                self.queue.rearm(record.job_id)
                outcome = "new"
            if outcome == "quarantined":
                # permanent failure on record: the request fails NOW
                # instead of waiting on work nothing will run — an
                # operator re-arms the plan (docs/SERVE.md), a re-POST
                # then retries it
                _UNITS.labels(outcome="quarantined").inc()
                outcomes["quarantined"] += 1
                quarantine_error = record.error or "plan quarantined"
                continue
            key = "enqueued" if outcome == "new" else "attached"
            _UNITS.labels(outcome=key).inc()
            outcomes[key] += 1
        # under the lock: `doc` is shared with worker callbacks the
        # moment it entered self._requests above, and _persist_request
        # snapshots it under this same lock — a bare mutation here would
        # race that snapshot's iteration (snapshot-under-lock audit)
        with self._lock:
            doc["warm"] = outcomes["warm"] == len(plans)
            if quarantine_error is not None and doc["state"] == "active":
                doc["state"] = "failed"
                doc["done_at"] = time.time()
                doc["error"] = quarantine_error
        _REQ_TOTAL.labels(state="accepted").inc()
        tm.emit("serve_request", request=req_id, trace_id=trace_id,
                tenant=normalized["tenant"],
                priority=normalized["priority"], units=len(unit_docs),
                **outcomes)
        if quarantine_error is not None:
            self._persist_request(doc)
            _REQ_TOTAL.labels(state="failed").inc()
            tm.emit("serve_request_done", request=req_id,
                    trace_id=trace_id, status="failed",
                    error=quarantine_error)
        self.scheduler.notify()
        self._check_request_done(req_id, submit_t0=t0)
        with self._lock:
            state = self._requests[req_id]["state"]
            latency_ms = self._requests[req_id]["latency_ms"]
        return {
            "request": req_id,
            "trace": trace_id,
            "state": state,
            "units": len(unit_docs),
            "outcomes": outcomes,
            "latency_ms": latency_ms,
            "url": f"/v1/requests/{req_id}",
        }

    # ------------------------------------------------------- completion

    def _plan_is_done(self, plan_hash: str) -> bool:
        """The store is the truth for artifact existence; a verified
        manifest = warm. Corruption counts as a miss (the rebuild
        path will re-execute)."""
        if self.store is None:
            return False
        manifest = self.store.lookup(plan_hash)
        if manifest is None:
            return False
        try:
            self.store.verify_object(manifest.object)
        except StoreCorruption:
            return False
        self.store.touch(manifest)
        return True

    def _on_job_done(self, record) -> None:
        with self._lock:
            waiters = self._plan_waiters.pop(record.plan_hash, set())
            for req_id in waiters:
                doc = self._requests.get(req_id)
                if doc is not None:
                    doc.get("_pending", set()).discard(record.plan_hash)
        for req_id in sorted(waiters):
            self._check_request_done(req_id)

    def _on_job_failed(self, record) -> None:
        with self._lock:
            waiters = self._plan_waiters.pop(record.plan_hash, set())
            docs = []
            for req_id in sorted(waiters):
                doc = self._requests.get(req_id)
                if doc is None or doc["state"] != "active":
                    continue
                doc["state"] = "failed"
                doc["done_at"] = time.time()
                doc["error"] = record.error
                # same visibility contract as _check_request_done: the
                # terminal event is published before the lock drops
                _REQ_TOTAL.labels(state="failed").inc()
                tm.emit("serve_request_done", request=doc["request"],
                        trace_id=doc.get("trace"), status="failed",
                        error=record.error)
                docs.append(doc)
        for doc in docs:
            self._persist_request(doc)

    def _check_request_done(self, req_id: str,
                            submit_t0: Optional[float] = None) -> None:
        """Finalize a request whose pending set drained. The set is
        maintained incrementally (submit warm hits, _on_job_done), so
        this is a dict lookup under the lock — NOT a per-unit store
        re-verification, which on a mostly-warm many-unit request would
        serialize submit and the whole observability surface behind
        file I/O."""
        with self._lock:
            doc = self._requests.get(req_id)
            if doc is None or doc["state"] != "active":
                return
            if doc.get("_pending"):
                return
            doc["state"] = "done"
            doc["done_at"] = time.time()
            if submit_t0 is not None:
                doc["latency_ms"] = round(
                    (time.perf_counter() - submit_t0) * 1e3, 3
                )
            else:
                doc["latency_ms"] = round(
                    (doc["done_at"] - doc["created_at"]) * 1e3, 3
                )
            warm = doc.get("warm", False)
            latency_s = (doc["done_at"] - doc["created_at"])
            # counters + the terminal event fire INSIDE the lock that
            # makes the state flip visible: a waiter that observes
            # 'done' must also find serve_request_done in the event log
            # — emitting after the (fsynced) persist below left a
            # window a loaded suite actually hit
            _REQ_TOTAL.labels(state="completed").inc()
            _REQ_SECONDS.observe(max(0.0, latency_s))
            _E2E_SECONDS.labels(tenant=doc["tenant"],
                                priority=doc["priority"]) \
                .observe(max(0.0, latency_s))
            if warm:
                _WARM_REQ_SECONDS.observe(max(0.0, latency_s))
            tm.emit("serve_request_done", request=req_id,
                    trace_id=doc.get("trace"), status="done",
                    duration_s=round(max(0.0, latency_s), 4), warm=warm)
        self._persist_request(doc)
        self._prune_finished()

    def _persist_request(self, doc: dict) -> None:
        # snapshot AND write under the lock (the queue's own discipline:
        # the files are small, one atomic replace each). The lock stops
        # two races at once: _on_job_failed inserting doc["error"] while
        # the comprehension iterates (RuntimeError), and a stale snapshot
        # from the submit thread landing AFTER a worker persisted the
        # terminal state, reverting the on-disk record to 'active'.
        # "_pending" (a set) is in-memory bookkeeping, rebuilt at
        # recovery from the store + queue — never persisted.
        with self._lock:
            snapshot = {
                k: v for k, v in doc.items() if not k.startswith("_")
            }
            atomic_write_json(
                os.path.join(
                    self.requests_dir, snapshot["request"] + ".json"
                ),
                snapshot,
                durable=True,  # request docs claim SIGKILL/power-loss proofness
                sort_keys=True,
            )

    def _prune_finished(self) -> None:
        """Retention for an always-on daemon: keep the most recent
        `_REQUEST_RETENTION` finished requests (memory AND disk); the
        artifacts themselves live in the store under GC/budget rules."""
        with self._lock:
            finished = [
                doc for doc in self._requests.values()
                if doc["state"] != "active"
            ]
            excess = len(finished) - _REQUEST_RETENTION
            victims = []
            if excess > 0:
                finished.sort(key=lambda d: d.get("done_at") or 0.0)
                victims = finished[:excess]
                for doc in victims:
                    self._requests.pop(doc["request"], None)
        for doc in victims:
            try:
                os.unlink(os.path.join(
                    self.requests_dir, doc["request"] + ".json"
                ))
            except OSError:
                pass

    # ------------------------------------------------------------- views

    def request_status(self, req_id: str) -> Optional[dict]:
        with self._lock:
            doc = self._requests.get(req_id)
            if doc is None:
                return None
            out = {
                "request": doc["request"],
                "trace": doc.get("trace"),
                "tenant": doc["tenant"],
                "priority": doc["priority"],
                "state": doc["state"],
                "created_at": doc["created_at"],
                "done_at": doc["done_at"],
                "latency_ms": doc["latency_ms"],
                "warm": doc.get("warm", False),
                "units": {},
            }
            if "error" in doc:
                out["error"] = doc["error"]
            pending = doc.get("_pending")
            if pending is None:
                # recovered finished request (no live bookkeeping): any
                # unit the queue still knows as unfinished reports that
                # state; the rest are settled
                pending = {
                    u["plan"] for u in doc["units"].values()
                    if (self.queue.by_plan(u["plan"]) or
                        _DONE_SENTINEL).state != "done"
                }
            for pvs_id, unit_doc in doc["units"].items():
                if unit_doc["plan"] not in pending:
                    # settled when it drained from the pending set — no
                    # store re-verification per GET (eviction later just
                    # 404s the artifact URL, by design)
                    entry = {
                        "plan": unit_doc["plan"], "state": "done",
                        "artifact": f"/v1/artifacts/{unit_doc['plan']}",
                    }
                else:
                    record = self.queue.by_plan(unit_doc["plan"])
                    state = record.state if record is not None else "queued"
                    entry = {"plan": unit_doc["plan"], "state": state}
                    if record is not None and record.error:
                        entry["error"] = record.error
                out["units"][pvs_id] = entry
            return out

    def _request_summaries(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "request": doc["request"],
                    "tenant": doc["tenant"],
                    "priority": doc["priority"],
                    "state": doc["state"],
                    "units": len(doc["units"]),
                    "created_at": doc["created_at"],
                }
                for doc in sorted(
                    self._requests.values(),
                    key=lambda d: d["created_at"],
                )[-1000:]  # most recent; full history is on disk
            ]

    def _status_section(self, query: dict) -> dict:
        section = {
            "executor": self.executor.kind,
            # replica identity: multi-replica runs must be tellable
            # apart at a glance (/status, chain-top, the fleet view)
            "replica": self.replica,
            "replica_epoch": self.queue.replica_epoch,
            "pid": os.getpid(),
            "queue": self.queue.counts(),
            "requests": {},
            # live stall/hard-timeout episodes from the heartbeat registry
            "stalls": tm_watchdog.active_stalls(),
        }
        with self._lock:
            for doc in self._requests.values():
                state = doc["state"]
                section["requests"][state] = (
                    section["requests"].get(state, 0) + 1
                )
        req_id = query.get("request")
        if req_id:
            section["request"] = (
                self.request_status(req_id) or {"error": "unknown request"}
            )
        return section

    # ------------------------------------------------------------- HTTP

    @staticmethod
    def _json(code: int, doc: object):
        return code, "application/json", json.dumps(doc)

    def _h_requests(self, req: live.WebRequest):
        if req.method == "GET":
            return self._json(200, {"requests": self._request_summaries()})
        try:
            payload = json.loads(req.body.decode() or "null")
        except (ValueError, UnicodeDecodeError):
            _REQ_TOTAL.labels(state="rejected").inc()
            return self._json(400, {"error": "body is not valid JSON"})
        try:
            return self._json(202, self.submit(payload))
        except api.RequestError as exc:
            return self._json(400, {"error": str(exc)})

    def _h_healthz(self, req: live.WebRequest):
        """Liveness plus drain state. A draining replica answers 200 —
        it is healthy, it is just not claiming work — so probes keep
        passing while `tools serve-chaos` cycles a drain/join."""
        with self._lock:
            state = "draining" if self._draining else "ok"
        return 200, "application/json", json.dumps({
            "status": state,
            "pid": os.getpid(),
            "replica": self.replica,
            "uptime_s": round(time.monotonic() - self._t0, 3),
        })

    def _h_drain(self, req: live.WebRequest):
        """POST /v1/drain: body `{}` (or empty) drains; `{"resume":
        true}` rejoins. SIGUSR1 on the daemon is the signal-shaped
        equivalent of the drain half (tools/chain_serve.py)."""
        try:
            payload = json.loads(req.body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            return self._json(400, {"error": "body is not valid JSON"})
        if not isinstance(payload, dict):
            return self._json(400, {"error": "body must be a JSON object"})
        if payload.get("resume"):
            return self._json(200, self.resume())
        return self._json(200, self.drain())

    def _h_request(self, req: live.WebRequest):
        req_id = req.path[len("/v1/requests/"):]
        doc = self.request_status(req_id)
        if doc is None:
            return self._json(404, {"error": f"unknown request {req_id!r}"})
        return self._json(200, doc)

    @staticmethod
    def _etag_matches(header: str, etag: str) -> bool:
        """Strong If-None-Match comparison (RFC 9110 §13.1.2): the plan
        hash IS the content address, so weak tags (`W/"…"`) never
        match — a weak validator on a CAS key is a client bug."""
        if header.strip() == "*":
            return True
        return any(c.strip() == etag for c in header.split(","))

    @staticmethod
    def _parse_range(header: Optional[str], size: int):
        """RFC 9110 §14.2 single-range parse against a known size.
        Returns `(start, length)`, the string `"unsatisfiable"` (→ 416
        with `Content-Range: bytes */size`), or None when there is no
        range to honor — absent header, other units, multi-range, and
        malformed specs all serve the full body, as the spec allows."""
        if not header:
            return None
        m = re.fullmatch(r"bytes=(\d*)-(\d*)", header.strip())
        if m is None:
            return None
        first, last = m.group(1), m.group(2)
        if not first and not last:
            return None
        if not first:
            # suffix range: the final N bytes
            n = int(last)
            if n == 0 or size == 0:
                return "unsatisfiable"
            n = min(n, size)
            return size - n, n
        start = int(first)
        if start >= size:
            return "unsatisfiable"
        if not last:
            return start, size - start
        end = int(last)
        if end < start:
            return None
        return start, min(end, size - 1) - start + 1

    def _h_artifact(self, req: live.WebRequest):
        t0 = time.perf_counter()
        key = req.path[len("/v1/artifacts/"):]
        if len(key) != _HASH_LEN or any(
            c not in "0123456789abcdef" for c in key
        ):
            return self._json(400, {"error": "artifact key must be a "
                                             "64-hex plan hash"})
        if self.store is None:
            return self._json(404, {"error": "no store configured"})
        manifest = self.store.lookup(key)
        if manifest is None:
            return self._json(404, {"error": "unknown artifact (expired "
                                             "or never built; re-POST the "
                                             "request to rebuild)"})
        try:
            self.store.verify_object(manifest.object)
        except StoreCorruption:
            return self._json(404, {"error": "artifact failed verification; "
                                             "re-POST the request to rebuild"})
        self.store.touch(manifest)
        size = int(manifest.object.get("size", 0))
        size_class = tm_catalog.read_size_class(size)
        tenant = req.query.get("tenant", "")
        # the plan hash is a content address: it IS the strong ETag, and
        # the bytes behind it are immutable — cache forever
        etag = f'"{key}"'
        extra = {"ETag": etag,
                 "Accept-Ranges": "bytes",
                 "Cache-Control": "public, max-age=31536000, immutable"}
        inm = req.headers.get("if-none-match")
        if inm and self._etag_matches(inm, etag):
            # conditional GET hit: no body, fd never opened — the
            # cheapest read the plane can serve; TTFB-only in the SLO
            # layer (there is no stream to time)
            _READ_TTFB_SECONDS.labels(
                tenant=tenant, size_class=size_class).observe(
                    time.perf_counter() - t0)
            return 304, "application/octet-stream", b"", extra
        # RFC 9110 single-range parse against the manifest's size —
        # BEFORE any fd opens, so an unsatisfiable range costs nothing.
        # An If-Range validator that fails the strong compare drops the
        # range (full 200), per §13.1.5.
        rng = self._parse_range(req.headers.get("range"), size)
        if rng == "unsatisfiable":
            extra416 = dict(extra)
            extra416["Content-Range"] = f"bytes */{size}"
            return (416, "application/json",
                    json.dumps({"error": "requested range not "
                                         "satisfiable", "size": size}),
                    extra416)
        if rng is not None:
            if_range = req.headers.get("if-range")
            if if_range and if_range.strip() != etag:
                rng = None
        # streamed from disk (live.FileBody): artifacts are video-scale.
        # Open the fd HERE, not in the reply: the GC pressure hook can
        # evict the object between this check and the streaming loop,
        # and an open descriptor keeps the bytes alive for this response
        # (a post-eviction GET is an honest 404, never a truncated 200).
        try:
            path, fileobj, _ = self.store.open_object_read(
                manifest.object["sha256"])
        except FileNotFoundError:
            return self._json(404, {"error": "artifact evicted; re-POST "
                                             "the request to rebuild"})
        except OSError as exc:
            # NOT eviction (EMFILE under fd pressure, EACCES, …): a 404
            # here would tell clients to re-POST and recompute bytes that
            # are sitting in the store — say 500 so they retry the GET
            get_logger().warning("serve: artifact open failed: %r", exc)
            return self._json(500, {"error": "artifact temporarily "
                                             "unavailable; retry"})

        status = 200
        offset = 0
        length = None
        if rng is not None:
            offset, length = rng
            status = 206
            extra["Content-Range"] = (
                f"bytes {offset}-{offset + length - 1}/{size}")

        def _on_first_byte() -> None:
            _READ_TTFB_SECONDS.labels(
                tenant=tenant, size_class=size_class
            ).observe(time.perf_counter() - t0)

        def _on_complete(sent: int, ok: bool) -> None:
            if ok:
                _READ_SECONDS.labels(
                    tenant=tenant, size_class=size_class).observe(
                        time.perf_counter() - t0)

        return status, "application/octet-stream", live.FileBody(
            path or "", fileobj=fileobj, offset=offset, length=length,
            on_first_byte=_on_first_byte, on_complete=_on_complete,
        ), extra

    # ------------------------------------------------------ test helpers

    def wait_request(self, req_id: str, timeout: float = 30.0) -> str:
        """Block until the request leaves 'active' (or timeout); returns
        its final (or current) state."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                doc = self._requests.get(req_id)
                state = doc["state"] if doc else "unknown"
            if state != "active":
                return state
            time.sleep(0.02)
        return "active"
