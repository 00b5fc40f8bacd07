"""Queue-draining scheduler: weighted fairness, singleflight, waves (copy
of processing_chain_tpu/serve/scheduler.py).

Worker threads pull from the DurableQueue and execute through the
engine's JobRunner — so serve executions get exactly the batch chain's
crash sentinels, store commits, provenance and telemetry, not a
parallel implementation of them.

Scheduling policy, in order:

  1. **Fairness** — stride scheduling over (tenant × priority class)
     flows. Each flow carries a virtual `pass`; dispatching from a flow
     advances its pass by `SCALE / (tenant_weight × class_weight)`.
     The next seed job always comes from the flow with the smallest
     pass: an interactive flow (weight 16) drains ~16x the rate of a
     bulk flow (weight 1) under contention, yet every flow's pass
     eventually becomes the smallest — nothing starves. New flows join
     at the current minimum pass, so arriving tenants neither wait out
     history nor monopolize the near future.
  2. **Wave packing** — after the fairness pick chooses WHO goes next,
     the wave fills with other queued units sharing the seed's bucket
     key (parallel/p03_batch geometry semantics) regardless of tenant
     or request, up to `wave_width`: device sharing is free capacity,
     not a fairness question.
  3. **Singleflight** — `queue.claim` moves records queued→running
     under the queue lock; a plan hash can never be executing twice,
     and enqueue-time attachment (queue.py) means overlapping requests
     were already riding the one record.

Execution failures are CLASSIFIED before they are settled
(docs/SERVE.md "Failure taxonomy"): transient ones (disk pressure,
device unavailable, OOM) retry up to `max_attempts` with exponential
backoff + jitter — the record's `not_before` keeps a deterministic
failure from burning its whole attempts budget in milliseconds —
while permanent ones (bad params, corrupt SRC) QUARANTINE the plan
with forensics instead of retrying. The store stays the truth for what
actually completed: a commit that landed before a crash is a warm hit,
never a re-execution.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Optional

from .. import telemetry as tm
from ..engine.jobs import Job, JobRunner
from ..store import runtime as store_runtime
from ..utils import lockdebug
from ..utils.log import get_logger
from .api import PRIORITIES
from .executors import _unit_of
from .queue import DurableQueue, JobRecord

_INFLIGHT = tm.gauge(
    "chain_serve_inflight", "units currently executing in the serve scheduler"
)

#: exception types whose retry-worthiness is knowable without a
#: ChainError kind tag: environmental failures may succeed later;
#: programming/data errors will not.
_TRANSIENT_TYPES = (OSError, MemoryError, TimeoutError, ConnectionError)
_PERMANENT_TYPES = (ValueError, TypeError, KeyError, AssertionError)


#: the declared failure kinds (docs/SERVE.md "Failure taxonomy"):
#: `poison` is `permanent` plus a fleet-wide verdict about the SRC
#: BYTES — the settle path additionally quarantines the record's SRC
#: content digest so every plan referencing it fails fast.
FAILURE_KINDS = ("transient", "permanent", "poison")


def classify_failure(exc: BaseException) -> str:
    """'transient', 'permanent' or 'poison' for one execution failure.
    Walks the cause/context chain (the wave barrier and the runner both
    wrap the executor's exception): an explicit `kind` attribute
    anywhere wins — ChainError and io.medialib.MediaError both carry
    one — otherwise the first recognizably-environmental or
    recognizably-deterministic type decides. Unknown shapes default to
    transient — the attempts budget still bounds them, and retrying an
    unknown is cheaper than quarantining a recoverable plan."""
    seen: set = set()
    cursor: Optional[BaseException] = exc
    verdict: Optional[str] = None
    while cursor is not None and id(cursor) not in seen:
        seen.add(id(cursor))
        kind = getattr(cursor, "kind", None)
        if kind in FAILURE_KINDS:
            return kind
        if verdict is None:
            if isinstance(cursor, _TRANSIENT_TYPES):
                verdict = "transient"
            elif isinstance(cursor, _PERMANENT_TYPES):
                verdict = "permanent"
        cursor = cursor.__cause__ or cursor.__context__
    return verdict or "transient"


def extract_src_digest(exc: BaseException) -> Optional[str]:
    """The convicting SRC content digest a `poison` verdict carries
    (ChainError(src_digest=…), docs/ROBUSTNESS.md), walked through the
    cause/context chain like classify_failure. None = unattributed —
    the settle path then falls back to solo-wave blame."""
    seen: set = set()
    cursor: Optional[BaseException] = exc
    while cursor is not None and id(cursor) not in seen:
        seen.add(id(cursor))
        digest = getattr(cursor, "src_digest", None)
        if digest:
            return str(digest)
        cursor = cursor.__cause__ or cursor.__context__
    return None

#: stride virtual-time scale (anything ≫ max weight works; power of two
#: keeps the passes exact in floats far past any realistic uptime)
_SCALE = 1 << 20


class StridePicker:
    """Stride scheduling over (tenant, priority) flows. Not thread-safe
    by itself — the scheduler serializes picks under its own lock."""

    def __init__(self, tenant_weights: Optional[dict] = None) -> None:
        self._weights = dict(tenant_weights or {})
        self._pass: dict[tuple, float] = {}
        #: virtual time = the pass of the most recently dispatched flow.
        #: Joining/rejoining flows enter at vtime, not at the minimum
        #: over every flow EVER seen — a pass frozen while its flow sat
        #: idle would otherwise hand the next arrival (or the returning
        #: flow itself) a catch-up burst that starves every active
        #: tenant until the stale gap is consumed.
        self._vtime = 0.0

    def _stride(self, flow: tuple) -> float:
        tenant, priority = flow
        weight = max(float(self._weights.get(tenant, 1.0)), 1e-6)
        return _SCALE / (weight * PRIORITIES.get(priority, 1))

    def pick(self, queued: list[JobRecord]) -> JobRecord:
        """Choose the next seed among queued records (must be non-empty)
        and advance its flow's pass."""
        flows: dict[tuple, JobRecord] = {}
        for record in queued:  # queued is enqueue-ordered: first wins
            flow = (record.tenant, record.priority)
            if flow not in flows:
                flows[flow] = record
        for flow in flows:
            if flow not in self._pass or self._pass[flow] < self._vtime:
                # new flow, or one whose pass froze while it was idle
                # and vtime moved on: (re)join at NOW. For flows that
                # stayed active this is a no-op — vtime is the minimum
                # pass by construction, so active passes never trail it.
                self._pass[flow] = self._vtime
        chosen = min(
            flows,
            key=lambda f: (self._pass[f], -PRIORITIES.get(f[1], 1), f[0]),
        )
        self._vtime = self._pass[chosen]
        self._pass[chosen] += self._stride(chosen)
        return flows[chosen]


#: how long a wave member will wait for its siblings to ARRIVE at the
#: barrier. All members are submitted to a pool exactly as wide as the
#: wave, so arrival is thread-startup time (milliseconds) — a miss on
#: this timeout means a sibling job died before reaching its fn, and
#: waiting longer would deadlock the wave forever.
_ARRIVAL_TIMEOUT_S = 60.0


class _WaveBarrier:
    """One shared execution for a batch of engine Jobs: every planned
    job's fn arrives here; the LAST arrival (all sentinels down by then)
    runs the executor's batch once; everyone returns together. A batch
    failure surfaces in every member job, so the runner's fail-fast and
    the per-job telemetry stay truthful.

    Deadlock-proofing: waiters block UNBOUNDED only on the compute
    phase (which is genuinely unbounded — a device wave takes as long
    as it takes) but only BOUNDED on the arrival phase. If a sibling
    dies before reaching produce() (any unexpected pre-fn failure), the
    remaining members time out, fail their jobs, and the scheduler's
    settle path re-queues against the store instead of hanging the
    worker thread forever."""

    def __init__(self, executor, units: list, outputs: list) -> None:
        self._executor = executor
        self._units = units
        self._outputs = outputs
        self._lock = lockdebug.make_lock("serve_wave")
        self._expected: int = len(units)  # guarded-by: _lock
        self._arrived: int = 0            # guarded-by: _lock
        self._all_arrived = threading.Event()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    def produce(self) -> None:
        with self._lock:
            self._arrived += 1
            run_it = self._arrived == self._expected
        if run_it:
            self._all_arrived.set()
            try:
                self._executor.run_batch(self._units, self._outputs)
            except BaseException as exc:  # noqa: BLE001 - must release waiters
                self._error = exc
                raise
            finally:
                self._done.set()
        else:
            if not self._all_arrived.wait(timeout=_ARRIVAL_TIMEOUT_S):
                with self._lock:
                    arrived, expected = self._arrived, self._expected
                raise RuntimeError(
                    f"wave barrier: only {arrived}/{expected} members "
                    "arrived — a sibling job died before reaching its fn; "
                    "failing this member instead of deadlocking"
                )
            self._done.wait()
            if self._error is not None:
                raise RuntimeError(
                    f"wave execution failed: {self._error!r}"
                ) from self._error


#: worker idle-poll bounds: fast right after a dispatch (work begets
#: work), decaying when the queue stays empty (an idle fleet must not
#: hammer the shared queue lock)
_IDLE_MIN_S = 0.01
_IDLE_MAX_S = 0.25

#: how deep the same-bucket fill looks into the queued snapshot; with
#: cost budgets a skip no longer ends the scan, so the window must be
#: bounded — the packing pass runs under the scheduler lock
_FILL_SCAN_CAP = 256


class Scheduler:
    """Worker threads draining the queue (see module doc for policy)."""

    def __init__(
        self,
        queue: DurableQueue,
        executor,
        artifacts_root: str,
        workers: int = 2,
        wave_width: int = 4,
        tenant_weights: Optional[dict] = None,
        max_attempts: int = 2,
        retry_base_s: float = 0.25,
        retry_cap_s: float = 30.0,
        wave_budget_s: Optional[float] = None,
        on_done: Optional[Callable[[JobRecord], None]] = None,
        on_failed: Optional[Callable[[JobRecord], None]] = None,
    ) -> None:
        self.queue = queue
        self.executor = executor
        self.artifacts_root = artifacts_root
        self.workers = max(1, int(workers))
        self.wave_width = max(1, int(wave_width))
        #: cost-aware packing (serve/cost.py): fill waves until the
        #: members' PREDICTED seconds reach this budget instead of
        #: stopping at a unit count — None keeps count-based packing
        self.wave_budget_s = (
            float(wave_budget_s) if wave_budget_s else None
        )
        self.max_attempts = max(1, int(max_attempts))
        self.retry_base_s = max(0.0, float(retry_base_s))
        self.retry_cap_s = max(self.retry_base_s, float(retry_cap_s))
        self.on_done = on_done or (lambda record: None)
        self.on_failed = on_failed or (lambda record: None)
        self._picker = StridePicker(tenant_weights)
        self._lock = lockdebug.make_lock("serve_sched")
        self._wake = threading.Event()
        self._stop = threading.Event()
        #: drain gate (docs/SERVE.md "Draining a replica"): while set,
        #: _next_batch claims nothing — in-flight waves finish, queued
        #: work stays for peers or for resume()
        self._draining = threading.Event()
        self._threads: list[threading.Thread] = []

    # --------------------------------------------------------- lifecycle

    def start(self) -> "Scheduler":
        if not self._threads:
            for i in range(self.workers):
                t = threading.Thread(
                    target=self._worker, name=f"chain-serve-worker-{i}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []

    def notify(self) -> None:
        """New work arrived (submit path); wake idle workers now."""
        self._wake.set()

    def drain(self) -> None:
        """Stop claiming new work; waves already dispatched finish and
        settle normally (their leases stay live). Idempotent."""
        self._draining.set()

    def resume(self) -> None:
        """Leave draining: claiming resumes with the next wake."""
        self._draining.clear()
        self._wake.set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    # --------------------------------------------------------- main loop

    def _worker(self) -> None:
        log = get_logger()
        idle_wait = _IDLE_MIN_S
        while not self._stop.is_set():
            try:
                batch = self._next_batch()
                if not batch:
                    # idle backoff: stay responsive just after real work
                    # (a settling wave often unblocks more), decay to
                    # ~250 ms when the queue stays empty — an idle
                    # replica fleet must not spin N workers hot against
                    # the queue lock. A submit's notify() short-circuits
                    # the wait either way.
                    if self._wake.wait(timeout=idle_wait):
                        self._wake.clear()
                        idle_wait = _IDLE_MIN_S
                    else:
                        idle_wait = min(idle_wait * 2.0, _IDLE_MAX_S)
                    continue
                idle_wait = _IDLE_MIN_S
                self._dispatch(batch)
            except BaseException:  # noqa: BLE001 - a worker must survive anything
                # _next_batch is INSIDE the guard: a poisoned queue record
                # (e.g. unparseable params reaching bucket_key) must not
                # kill the worker. Back off briefly so a persistently bad
                # record cannot turn the loop into a log-spinning hot path.
                log.exception("serve scheduler: worker iteration crashed")
                self._stop.wait(timeout=0.5)

    def _next_batch(self) -> list[JobRecord]:
        """Fairness seed + same-bucket fill, all claimed atomically:
        the claimed batch is the seed plus up to `wave_width - 1` other
        queued records sharing its bucket key (p03_batch geometry
        semantics — same key ⟺ same compiled device step), in enqueue
        order. With `wave_budget_s` set, the fill also balances
        PREDICTED seconds (the records' `cost_s`, serve/cost.py): a
        member that would push the wave past the budget is skipped in
        favor of later, lighter same-bucket units — waves stop being
        "4 units" and start being "~budget seconds", which is what
        keeps one all-heavy wave from defining the e2e tail. The fill
        scans only a bounded window instead of packing the entire
        snapshot into waves to keep one — a deep queue must not cost
        O(queue) key calls under the scheduler lock per dispatch."""

        def safe_key(record: JobRecord):
            # totality guaranteed HERE, not re-audited per executor: one
            # record whose unit an executor's bucket_key cannot parse
            # must degrade to unbatchable (solo wave), never abort the
            # packing pass every worker runs over the queued snapshot
            try:
                return self.executor.bucket_key(record.unit)
            except Exception:  # noqa: BLE001 - any key failure = unbatchable
                return None

        if self._draining.is_set():
            # draining: never claim — queued work is for peers (or for
            # resume()); waves already in flight settle on their own
            return []
        with self._lock:
            queued = self.queue.queued_snapshot()
            if not queued:
                return []
            seed = self._picker.pick(queued)
            wave = [seed]
            wave_cost = seed.cost_s
            seed_key = safe_key(seed)
            if seed_key is not None:  # None = unbatchable: solo wave
                for record in queued[:_FILL_SCAN_CAP]:
                    if len(wave) >= self.wave_width:
                        break
                    if (record.job_id == seed.job_id
                            or safe_key(record) != seed_key):
                        continue
                    if (self.wave_budget_s is not None
                            and wave_cost + record.cost_s
                            > self.wave_budget_s):
                        continue  # too heavy for THIS wave; a lighter
                        # same-bucket unit further on may still fit
                    wave.append(record)
                    wave_cost += record.cost_s
            return self.queue.claim([r.job_id for r in wave])

    # --------------------------------------------------------- execution

    def _dispatch(self, batch: list[JobRecord]) -> None:
        """Execute one claimed batch. EVERY claimed record leaves this
        method settled — completed, requeued, or failed: an exception
        anywhere (planning, a mid-loop persist error, the runner itself)
        falls through to the settle path, because a claimed record left
        in state 'running' with no owner would hang its requests forever
        and soak up attaching newcomers."""
        settled: set[str] = set()
        _INFLIGHT.inc(len(batch))
        # the wave's predicted mass — what cost-aware packing balances;
        # the pack bench (tools serve-soak --pack-bench) grades packing
        # policies from exactly these records
        tm.emit("serve_wave", units=len(batch),
                predicted_s=round(sum(r.cost_s for r in batch), 4))
        try:
            os.makedirs(self.artifacts_root, exist_ok=True)
            runner = JobRunner(parallelism=len(batch), name="serve")
            # records per label — a LIST, not a single slot: the
            # cross-replica enqueue race can mint twin records for one
            # plan (docs/SERVE.md "eventual dedup"), and both twins can
            # be claimed into one wave (same plan ⟹ same bucket key).
            # They share one execution (JobRunner dedups the identical
            # job), but EVERY claimed record must settle — a twin left
            # in 'running' keeps its lease renewed forever and hangs
            # its requests. The trace-completeness chaos invariant is
            # what exposed this.
            by_label: dict[str, list[JobRecord]] = {}
            out_of: dict[str, str] = {}
            for record in batch:
                label = f"serve:{record.unit['pvs_id']}:{record.plan_hash[:8]}"
                by_label.setdefault(label, []).append(record)
                out_of[label] = os.path.join(
                    self.artifacts_root, record.output
                )
            for label, records in by_label.items():
                request_ids = list(dict.fromkeys(
                    r for rec in records for r in rec.requests))
                trace_ids = list(dict.fromkeys(
                    t for rec in records for t in rec.trace_ids))
                runner.add(Job(
                    label=label,
                    output_path=out_of[label],
                    fn=None,  # bound below, once planning has spoken
                    plan=records[0].plan,
                    provenance={
                        "tenant": records[0].tenant,
                        "priority": records[0].priority,
                        "executor": self.executor.kind,
                        "replica": self.queue.replica,
                    },
                    request_ids=tuple(request_ids),
                    trace_ids=tuple(trace_ids),
                ))
            planned = {job.label for job in runner.jobs}
            # store warm path: should_run already verified+materialized
            # the artifact for skipped jobs — complete them right now
            for label, records in by_label.items():
                if label not in planned:
                    for record in records:
                        self._complete(record, settled, warm=True)
            if not planned:
                return
            # the wave holds exactly the PLANNED members: a warm-skipped
            # unit must neither be recomputed nor waited for
            wave = _WaveBarrier(
                self.executor,
                [_unit_of(by_label[j.label][0].unit) for j in runner.jobs],
                [out_of[j.label] for j in runner.jobs],
            )
            for job in runner.jobs:
                job.fn = wave.produce
            runner.run()
            for label in planned:
                for record in by_label[label]:
                    self._complete(record, settled)
        except Exception as exc:
            self._settle_failure(batch, settled, exc)
        finally:
            _INFLIGHT.dec(len(batch))

    def _complete(self, record: JobRecord, settled: set,
                  warm: bool = False) -> None:
        done = self.queue.complete(record.job_id, warm=warm)
        settled.add(record.job_id)
        if done is not None:
            self.on_done(done)

    def _backoff_s(self, attempts: int) -> float:
        """Exponential retry backoff with ±25% jitter: attempt k waits
        ~base·2^k (capped). Without it a deterministic transient-looking
        failure is re-eligible instantly and burns its whole attempts
        budget in milliseconds; the jitter keeps a replica fleet from
        retrying a shared record in lockstep."""
        delay = min(self.retry_cap_s,
                    self.retry_base_s * (2.0 ** max(0, attempts)))
        return delay * (0.75 + 0.5 * random.random())

    def _settle_failure(self, batch: list[JobRecord], settled: set,
                        exc: Exception) -> None:
        """After a batch failure the STORE is the truth: members whose
        commit landed are done. The rest settle by failure CLASS
        (classify_failure): permanent failures quarantine the plan with
        forensics — retrying a determined outcome is waste — while
        transient ones retry under the attempts budget, re-eligible
        only after an exponential backoff (the record's not_before). A
        wave failure is collective, but completion is not — and neither
        is BLAME: a permanent verdict is applied only when exactly one
        unsettled member could have caused it, because quarantining a
        whole wave for one poisoned sibling would park healthy plans
        behind an operator re-arm. Ambiguous permanent failures retry
        like transients (jittered backoff desynchronizes the members,
        so a truly poisoned unit soon fails a wave it owns alone and
        quarantines then; the attempts budget terminates the rest).
        Per-record settling is itself fenced — one record's persist
        error must not strand its siblings in 'running'."""
        log = get_logger()
        store = store_runtime.active()
        kind = classify_failure(exc)
        # an attributed poison verdict names the convicting digest on
        # the exception — wave packing then never decides who parks
        poison_digest = extract_src_digest(exc) if kind == "poison" \
            else None
        suspects = sum(1 for r in batch if r.job_id not in settled)
        for record in batch:
            if record.job_id in settled:
                continue
            try:
                committed = False
                if store is not None:
                    try:
                        committed = store.lookup(record.plan_hash) is not None
                    except Exception:  # noqa: BLE001 - store probe is best-effort
                        committed = False
                if committed:
                    self._complete(record, settled)
                    continue
                # blame attribution: a deterministic verdict parks a
                # record when (a) it owned the failed wave alone, or
                # (b) the poison verdict NAMES this record's SRC digest
                # (extract_src_digest) — an attributed conviction from
                # any wave shape. A mis-attributed sibling keeps
                # retrying under backoff; a poison record whose budget
                # is spent quarantines anyway (terminal either way, and
                # 'failed' would hide it from the operator's quarantine
                # surface) but convicts NO digest — fleet-wide blame
                # needs solo ownership or an attributed verdict. An
                # EXONERATED record — the verdict names a different
                # digest — never rides that clause: it settles 'failed'
                # like any spent budget instead of parking a healthy
                # plan behind an operator re-arm.
                attributed = (
                    kind == "poison" and poison_digest is not None
                    and record.src_digest == poison_digest
                )
                exonerated = (
                    kind == "poison" and poison_digest is not None
                    and record.src_digest is not None
                    and record.src_digest != poison_digest
                )
                budget_spent = record.attempts + 1 >= self.max_attempts
                if kind in ("permanent", "poison") and \
                        (suspects == 1 or attributed or
                         (kind == "poison" and budget_spent
                          and not exonerated)):
                    quarantined = self.queue.quarantine(
                        record.job_id, error=repr(exc), kind=kind,
                    )
                    settled.add(record.job_id)
                    if quarantined is not None:
                        log.error("serve: job %s quarantined (%s "
                                  "failure): %r", record.job_id, kind, exc)
                        self.on_failed(quarantined)
                        if kind == "poison" and record.src_digest and \
                                ((suspects == 1 and not exonerated)
                                 or attributed):
                            # the verdict is about the SRC BYTES, not
                            # this one plan: quarantine the content
                            # digest fleet-wide and fail every queued
                            # sibling referencing it — one hostile
                            # upload must burn ONE attempts budget,
                            # not one per (HRC × tenant × replica)
                            swept = self.queue.poison_src(
                                record.src_digest,
                                src=record.unit.get("src"),
                                error=repr(exc), by_job=record.job_id,
                            )
                            for sibling in swept:
                                settled.add(sibling.job_id)
                                self.on_failed(sibling)
                    continue
                requeue = record.attempts + 1 < self.max_attempts
                failed = self.queue.fail(
                    record.job_id, error=repr(exc), requeue=requeue,
                    backoff_s=self._backoff_s(record.attempts) if requeue
                    else 0.0,
                    kind=kind,
                )
                settled.add(record.job_id)
                if failed is not None and not requeue:
                    log.error("serve: job %s failed permanently: %r",
                              record.job_id, exc)
                    self.on_failed(failed)
            except Exception:  # noqa: BLE001 - settle the rest regardless
                log.exception("serve: could not settle job %s",
                              record.job_id)
        self._wake.set()  # requeued members should not wait out the idle poll

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Test/soak helper: True once nothing is queued or running."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            counts = self.queue.counts()
            if not counts.get("queued") and not counts.get("running"):
                return True
            time.sleep(0.02)
        return False
