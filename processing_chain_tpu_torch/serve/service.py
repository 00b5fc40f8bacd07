"""The chain-serve daemon: HTTP front door, queue, scheduler, store
(port of processing_chain_tpu/serve/service.py, with the executor on a
torch device).

The control plane is the reference's, each piece a no-op at its defaults
(all budgets None, one replica): store pressure and GC under
`store_budget_bytes`, the tier hierarchy (`store_tiers`), the heat
ledger, the cost ledger with admission at POST (`admission_budget_s`,
`tenant_budget_s`) and cost-aware wave packing (`wave_budget_s`), the
alert engine and autoscale advisor on the maintenance tick, the /fleet
routes, and the cross-replica orphan-request sweep. Left out of the
port: the reference's `chain` executor (real databases through p01-p04),
which waits for the port's media boundary.

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
    GET  /fleet /fleet/alerts /fleet/scale-signal   the merged fleet view

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
from ..telemetry import alerts as alerts_mod
from ..telemetry import catalog as tm_catalog
from ..telemetry import watchdog as tm_watchdog
from ..store import heat as store_heat
from ..store import runtime as store_runtime
from ..store.store import StoreCorruption
from ..telemetry import live
from ..utils import lockdebug
from ..utils.fsio import atomic_write_json
from ..utils.log import get_logger
from . import api, autoscale, cost
from .executors import make_executor
from .pressure import StorePressure
from .queue import DurableQueue, owner_process_dead, owner_stamp
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
_REQUEST_RETENTION = 10_000  # finished requests kept (memory and disk)
#: executions whose cost was settled, remembered so the scheduler's
#: callback and the maintenance sweep settle each one once
_SETTLED_KEEP = 4096


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
        store_budget_bytes: Optional[int] = None,
        store_tiers: Optional[str] = None,
        tenant_weights: Optional[dict] = None,
        max_attempts: int = 2,
        replica: Optional[str] = None,
        lease_s: float = 15.0,
        poll_s: float = 1.0,
        info_path: Optional[str] = None,
        wave_budget_s: Optional[float] = None,
        admission_budget_s: Optional[float] = None,
        tenant_budget_s: Optional[float] = None,
        cost_calibrate: bool = False,
        control_interval_s: float = 10.0,
        alert_window_scale: float = 1.0,
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
            store_root or os.path.join(self.root, "store"),
            tiers=store_tiers,
        )
        self.queue = DurableQueue(
            os.path.join(self.root, "queue"),
            replica=replica, lease_s=lease_s,
        )
        self.replica = self.queue.replica
        #: the read-path flight recorder (store/heat.py): per-replica
        #: access journal + eviction-regret detector, shared with the
        #: GC pressure hook so evictions land with forensics
        self.heat = store_heat.HeatLedger(
            self.store.root, replica=self.replica
        )
        # the device-plane flight recorder (parallel/meshobs.py): the
        # wave executor records into this root's journal under this
        # replica's name — /fleet merges the per-replica files
        meshobs.attach_journal(
            meshobs.mesh_dir(self.root), replica=self.replica
        )
        self.poll_s = max(0.05, float(poll_s))
        self.info_path = info_path or os.path.join(
            self.root, "serve-info.json"
        )
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        #: request-doc stat signatures for the orphan sweep; touched
        #: only by the maintenance thread
        self._req_stat: dict[str, tuple] = {}
        self._lock = lockdebug.make_lock("serve_service")
        #: request docs; each active one carries a non-persisted
        #: "_pending" set of plan hashes still outstanding, maintained by
        #: submit/_on_job_done so completion checks never re-verify the
        #: store under this lock
        self._requests: dict[str, dict] = {}   # guarded-by: _lock
        #: plan hash -> request ids still waiting on it
        self._plan_waiters: dict[str, set] = {}  # guarded-by: _lock
        #: (job_id, epoch) of the executions whose cost was settled: the
        #: scheduler's callback and the maintenance sweep can both see
        #: one done record
        self._settled: dict[tuple, None] = {}  # guarded-by: _lock
        self.pressure = StorePressure(
            self.store, store_budget_bytes, self.active_plans,
            heat=self.heat,
        )
        #: cost-aware serving knobs (docs/SERVE.md "Cost-aware
        #: scheduling & admission"); budgets of None disable each gate
        self.admission_budget_s = (
            float(admission_budget_s) if admission_budget_s else None
        )
        self.tenant_budget_s = (
            float(tenant_budget_s) if tenant_budget_s else None
        )
        self.cost_ledger = cost.CostLedger()
        #: periodic per-host refit of the cost-prediction scale from
        #: the ledger's observed/predicted ratio ring (maintenance
        #: tick; docs/SERVE.md "Cost-aware scheduling & admission")
        self.cost_calibrate = bool(cost_calibrate)
        # ------ the SLO control loop (docs/TELEMETRY.md "Alerting &
        # the scale signal"): one shared per-replica alert journal
        # carries both alert lifecycle records and scale-signal
        # records, so fleet-doctor reads one plane and scale decisions
        # sit next to the alerts that motivated them. The engine and
        # the advisor are re-graded by the maintenance tick, throttled
        # to control_interval_s; window_scale compresses every burn
        # window/hold uniformly (the soak harness squeezes hours into
        # seconds without forking the rule declarations).
        self.control_interval_s = max(0.05, float(control_interval_s))
        self.alert_journal = alerts_mod.AlertJournal(
            alerts_mod.alerts_dir(self.root), self.replica
        )
        self.alert_engine = alerts_mod.AlertEngine(
            self.root, self.replica, journal=self.alert_journal,
            window_scale=alert_window_scale,
        )
        self.autoscale = autoscale.AutoscaleAdvisor(
            self.alert_journal, self.replica, workers=workers,
            window_scale=alert_window_scale,
        )
        self._next_control = 0.0  # monotonic deadline; maintenance thread
        self.scheduler = Scheduler(
            self.queue, self.executor, self.artifacts_root,
            workers=workers, wave_width=wave_width,
            tenant_weights=tenant_weights, max_attempts=max_attempts,
            wave_budget_s=wave_budget_s,
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
        routes.add("/fleet", self._h_fleet)
        routes.add("/fleet/alerts", self._h_fleet_alerts)
        routes.add("/fleet/scale-signal", self._h_scale_signal)
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
        # resolve-on-shutdown is wrong (the condition may persist);
        # close() just seals the journal handle
        self.alert_engine.close()
        self.heat.close()
        if self.store is not None:
            self.store.digests.save()

    # ------------------------------------------------------- maintenance

    def _maintenance_loop(self) -> None:
        """The replica-fleet tick: merge peer queue changes, steal dead
        leases (waking our scheduler for the reclaimed work), and settle
        requests whose plans a PEER replica finished — this replica's
        scheduler callbacks only fire for its own executions, so
        cross-replica completions propagate here."""
        while not self._poll_stop.wait(timeout=self.poll_s):
            try:
                result = self.queue.poll()
                if result.get("stolen") or result.get("changed"):
                    self.scheduler.notify()
                self._sweep_remote_settlements()
                self._adopt_orphan_requests()
                if self.cost_calibrate:
                    # cheap (a sorted copy of a bounded ring); a thin
                    # ring returns None and the scale stays put
                    self.cost_ledger.calibrate()
            except Exception:  # noqa: BLE001 - the tick must survive disk hiccups
                get_logger().exception(
                    "chain-serve: maintenance tick failed")
            try:
                # the SLO control loop rides the same tick but in its
                # own try: an alert-grading failure must not starve
                # lease stealing (and vice versa)
                self._control_tick()
            except Exception:  # noqa: BLE001 - grading must never kill the tick
                get_logger().exception(
                    "chain-serve: control tick failed")

    def _control_tick(self, force: bool = False) -> Optional[dict]:
        """Grade the alert rules and the scale signal against the
        current fleet view. Throttled to `control_interval_s` (the
        fleet scrape stats every replica's journals); `force=True`
        (the /fleet/scale-signal cold path) grades immediately."""
        now = time.monotonic()
        if not force and now < self._next_control:
            return None
        self._next_control = now + self.control_interval_s
        from ..telemetry import fleet as fleet_mod

        view = fleet_mod.fleet_view(self.root, timeout_s=2.0)
        result = self.alert_engine.evaluate(view)
        calibrated = int(cost.calibration().get("n", 0)) > 0
        return self.autoscale.evaluate(
            current_replicas=max(1, int(view.get("alive") or 0)),
            backlog=self.queue.backlog(),
            outstanding_s=self.queue.outstanding_cost(),
            active_alerts=result["active"],
            calibrated=calibrated,
        )

    def _sweep_remote_settlements(self) -> None:
        with self._lock:
            waited = list(self._plan_waiters)
        for plan_hash in waited:
            record = self.queue.by_plan(plan_hash)
            if record is not None and record.state == "done":
                # a done record whose bytes were evicted is one the
                # submit that registered this waiter is about to re-arm:
                # only the bytes in the store settle it
                if self.store.lookup(plan_hash) is not None:
                    self._on_job_done(record)
            elif record is not None and record.state in (
                    "failed", "quarantined"):
                self._on_job_failed(record)
            elif record is None and self._plan_is_done(plan_hash):
                # no queue record but the store holds verified bytes: a
                # peer executed and its record left our view
                self._on_job_done(_PlanSettled(plan_hash))

    def _adopt_orphan_requests(self) -> None:
        """An active request whose owning replica died UN-restarted
        would otherwise wait for some replica's next startup rescan to
        be adopted; the tick adopts it directly. Terminal docs are
        stat-cached (they cannot regress), active docs of LIVE owners
        are re-probed each tick — the probe is one os.kill(pid, 0)."""
        try:
            names = os.listdir(self.requests_dir)
        except OSError:
            return
        seen: set = set()
        for name in names:
            if not name.endswith(".json"):
                continue
            req_id = name[:-5]
            seen.add(req_id)
            with self._lock:
                if req_id in self._requests:
                    continue
            path = os.path.join(self.requests_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            sig = (st.st_mtime_ns, st.st_size)
            if self._req_stat.get(req_id) == sig:
                continue
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue  # mid-replace or poisoned: next tick retries
            if doc.get("state") != "active":
                self._req_stat[req_id] = sig  # terminal: never re-read
                continue
            if not owner_process_dead(doc.get("owner")):
                continue  # owner lives (or is unknowable): theirs
            # claim the doc under the fleet fence: re-check and restamp
            # in one exclusive section so two surviving replicas cannot
            # both adopt the same orphan off simultaneous ticks
            claimed = False
            try:
                with self.queue.exclusive():
                    with open(path) as f:
                        doc = json.load(f)
                    if doc.get("state") == "active" and \
                            owner_process_dead(doc.get("owner")):
                        prev = (doc.get("owner") or {}).get("replica")
                        doc["owner"] = owner_stamp(self.replica)
                        atomic_write_json(path, doc, durable=True,
                                          sort_keys=True)
                        claimed = True
            except (OSError, ValueError):
                continue
            if not claimed:
                continue
            get_logger().warning(
                "chain-serve: adopting orphaned request %s from dead "
                "replica %r", req_id, prev)
            self._adopt_active(doc)
        # retention pruning deletes docs from disk; their stat entries
        # must not outlive them (an always-on daemon leaks otherwise)
        for req_id in list(self._req_stat):
            if req_id not in seen:
                self._req_stat.pop(req_id, None)

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
                        cost_s=float(unit_doc.get("cost_s", 0.0) or 0.0),
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
                    "cost_s": round(cost.predict_unit_cost(
                        self.executor, record_unit), 4),
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
        # admission control (docs/SERVE.md "Cost-aware scheduling &
        # admission"): COLD units' predicted seconds against the
        # per-request and per-tenant budgets, refused at POST time with
        # a 429 forensic body — before any durable state exists. The
        # warm set is computed once and reused by the enqueue loop.
        # Units whose plan is already queued/running cost nothing
        # either: they ATTACH to the in-flight record (singleflight),
        # whose prediction is already in the tenant's outstanding sum —
        # charging them again would refuse exactly the overlapping-grid
        # workload the serve layer exists to dedup, and double-count
        # the predicted ledger.
        warm_plans = {ph for ph in plans if self._plan_is_done(ph)}

        def _in_flight(plan_hash: str) -> bool:
            record = self.queue.by_plan(plan_hash)
            return record is not None and record.state in (
                "queued", "running")

        try:
            predicted_s = cost.check_admission(
                normalized["tenant"],
                [(ud["unit"]["pvs_id"], ud["cost_s"])
                 for ph, ud in plans.items()
                 if ph not in warm_plans and not _in_flight(ph)],
                self.admission_budget_s,
                self.tenant_budget_s,
                # only the tenant budget reads the backlog: without one,
                # submit stays off the queue lock, which workers hold
                # across their fsyncs
                self.queue.outstanding_cost(normalized["tenant"])
                if self.tenant_budget_s is not None else 0.0,
            )
        except cost.AdmissionError:
            _REQ_TOTAL.labels(state="rejected").inc()
            raise
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
            #: the admission decision's evidence, kept on the record
            "predicted_cost_s": round(predicted_s, 3),
            # liveness stamp: peers adopt this request if our process
            # dies before finalizing it (maintenance orphan sweep)
            "owner": owner_stamp(self.replica),
        }
        # the request must be discoverable BEFORE its first unit can
        # complete, or a fast job's on_done would miss the waiter
        with self._lock:
            doc["_pending"] = set(plans)
            self._requests[req_id] = doc
            for plan_hash in plans:
                self._plan_waiters.setdefault(plan_hash, set()).add(req_id)
        if len(warm_plans) < len(plans):
            # a request with cold units is on disk while they run (peers
            # adopt it if this replica dies); an all-warm one is durable
            # once, as done, before submit answers
            self._persist_request(doc)
        self.cost_ledger.admitted(normalized["tenant"], predicted_s)
        outcomes = {"warm": 0, "enqueued": 0, "attached": 0,
                    "quarantined": 0}
        quarantine_error: Optional[str] = None
        for plan_hash, unit_doc in plans.items():
            if plan_hash in warm_plans:
                _UNITS.labels(outcome="warm").inc()
                outcomes["warm"] += 1
                self.cost_ledger.warm(normalized["tenant"])
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
                cost_s=unit_doc["cost_s"],
                src_digest=unit_doc.get("src_digest"),
            )
            if outcome == "done":
                # the queue remembers a completion the store no longer
                # holds (evicted): re-arm the same record. If the
                # eviction was recent, this rebuild is eviction REGRET —
                # the budget forced recomputation of bytes we had.
                self.queue.rearm(record.job_id)
                self.heat.note_read_or_rebuild(plan_hash, via="rebuild")
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
        self._settle_cost(record)
        with self._lock:
            waiters = self._plan_waiters.pop(record.plan_hash, set())
            for req_id in waiters:
                doc = self._requests.get(req_id)
                if doc is not None:
                    doc.get("_pending", set()).discard(record.plan_hash)
        for req_id in sorted(waiters):
            self._check_request_done(req_id)
        self.pressure.maybe_collect()

    def _settle_cost(self, record) -> None:
        """The cost model's feedback loop (docs/SERVE.md): grade the
        record's predicted seconds against what execution really took.
        Only for executions THIS replica owned — a peer's completion
        already landed in its own ledger/metrics, and the fleet view
        merges the replicas' counters (double-observing here would
        double-count fleet-wide). Once per execution: the scheduler's
        callback and the maintenance sweep may both settle one record."""
        if getattr(record, "owner", None) != self.replica:
            return
        key = (getattr(record, "job_id", None), getattr(record, "epoch", None))
        with self._lock:
            if key in self._settled:
                return
            self._settled[key] = None
            if len(self._settled) > _SETTLED_KEEP:
                del self._settled[next(iter(self._settled))]
        tenant = getattr(record, "tenant", "") or ""
        if getattr(record, "warm", False):
            self.cost_ledger.warm(tenant)
            return
        claimed_at = getattr(record, "claimed_at", None)
        done_at = getattr(record, "done_at", None)
        if claimed_at and done_at:
            self.cost_ledger.observed(
                tenant, getattr(record, "cost_s", 0.0),
                max(0.0, done_at - claimed_at),
            )

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

    def active_plans(self) -> set:
        """Plan hashes unfinished requests still need — the GC pressure
        hook's ephemeral pins."""
        with self._lock:
            plans: set = set()
            for doc in self._requests.values():
                if doc["state"] != "active":
                    continue
                plans.update(u["plan"] for u in doc["units"].values())
            return plans

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
                "predicted_cost_s": doc.get("predicted_cost_s"),
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
            # per-tenant predicted/observed accounting + model error
            # (docs/SERVE.md "Cost-aware scheduling & admission")
            "cost": {
                **self.cost_ledger.report(),
                "outstanding_s": round(self.queue.outstanding_cost(), 3),
                # the per-host prediction multiplier in force (1.0 =
                # base coefficients); refit when --cost-calibrate is on
                "calibration": {
                    **cost.calibration(),
                    "enabled": self.cost_calibrate,
                },
            },
            # live stall/hard-timeout episodes from the heartbeat
            # registry — the fleet view re-labels these per replica so
            # a stalled replica is visible fleet-wide (fleet-top's
            # active-stalls line)
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
        except cost.AdmissionError as exc:
            # 429 with the full forensic body: what was predicted,
            # against which budget, and which units are the heaviest —
            # the client can split the grid or retry as work settles
            return self._json(429, exc.doc)
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

    def _h_fleet(self, req: live.WebRequest):
        """The merged fleet view (telemetry/fleet.py): every replica
        over this root — discovered via their serve-info files — plus
        the shared queue/request truth from disk and the SLO layer's
        merged per-(tenant × priority) histograms."""
        from ..telemetry import fleet

        return self._json(200, fleet.fleet_view(self.root))

    def _h_fleet_alerts(self, req: live.WebRequest):
        """GET /fleet/alerts: the fleet-merged alert plane — active
        alerts, recently-resolved ones, and journal stats — folded from
        every replica's alert journal (telemetry/alerts.py)."""
        return self._json(200, alerts_mod.alerts_report(self.root))

    def _h_scale_signal(self, req: live.WebRequest):
        """GET /fleet/scale-signal: the autoscale recommendation
        (serve/autoscale.py) — current vs desired replicas, confidence,
        reason codes. Served from the last maintenance-tick grading;
        a cold replica grades synchronously once."""
        signal = self.autoscale.latest()
        if signal is None:
            try:
                signal = self._control_tick(force=True)
            except Exception:  # noqa: BLE001 - degrade to 503, not a 500
                get_logger().exception(
                    "chain-serve: cold scale-signal grading failed")
        if signal is None:  # grading itself failed; say so, don't 500
            return self._json(503, {"error": "scale signal unavailable"})
        return self._json(200, signal)

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
        arrived = time.time()  # the heat record's ts: request order
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
            # a recently-evicted plan re-requested = eviction regret
            self.heat.note_read_or_rebuild(key, via="read")
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
            # cheapest read the plane can serve. An edge-class hit in
            # the heat ledger (mode=not_modified), TTFB-only in the SLO
            # layer (there is no stream to time).
            ttfb = time.perf_counter() - t0
            _READ_TTFB_SECONDS.labels(
                tenant=tenant, size_class=size_class).observe(ttfb)
            self.heat.record_read(
                key, 0, mode="not_modified", size=size,
                size_class=size_class, tenant=tenant, ttfb_s=ttfb,
                ts=arrived,
            )
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
        # The open is tier-routed (store/tiers.py): a warm/cold hit is
        # promoted read-through, and the tier the bytes were FOUND in
        # lands in the heat journal with the read.
        try:
            hit_tier, path, fileobj, _ = self.store.open_object_read(
                manifest.object["sha256"], plan=key, heat=self.heat,
            )
        except FileNotFoundError:
            self.heat.note_read_or_rebuild(key, via="read")
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
        mode = "full"
        offset = 0
        length = None
        if rng is not None:
            offset, length = rng
            status = 206
            mode = "range"
            extra["Content-Range"] = (
                f"bytes {offset}-{offset + length - 1}/{size}")

        ttfb_box: list = []

        def _on_first_byte() -> None:
            ttfb_box.append(time.perf_counter() - t0)
            _READ_TTFB_SECONDS.labels(
                tenant=tenant, size_class=size_class
            ).observe(ttfb_box[0])

        def _on_complete(sent: int, ok: bool) -> None:
            dur = time.perf_counter() - t0
            if ok:
                _READ_SECONDS.labels(
                    tenant=tenant, size_class=size_class).observe(dur)
            # the ledger records every stream, aborted ones included —
            # bytes left the disk either way. Ranged reads are their
            # own mode so hot-set accounting can tell a sampler from a
            # full consumer.
            self.heat.record_read(
                key, sent, mode=mode, size=size, size_class=size_class,
                tenant=tenant, tier=hit_tier,
                ttfb_s=ttfb_box[0] if ttfb_box else None, dur_s=dur,
                ts=arrived,
            )

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
