"""Job model: memoized units of pipeline work, keyed by plan hash
(trimmed copy of `Job` and `JobRunner` from
processing_chain_tpu/engine/jobs.py: the store path only, no force or
dry-run; the span around `Job.run` is the host wall-time span, the
reference's device trace is not carried over).

Replaces the reference's command-string + exists-check idiom (every
operator returns None when its output exists and --force is unset,
reference lib/ffmpeg.py:786-788, :964-970, :1022-1028, :1067-1073,
:1126-1132, :1271-1277) with a typed Job whose plan hash is its cache
key in the artifact store.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .. import telemetry as tm
from ..telemetry.heartbeat import HEARTBEATS
from ..store import keys
from ..store import runtime as store_runtime
from ..store.store import STORE_HITS, STORE_MISSES
from ..utils import tracing
from ..utils.log import get_logger
from ..utils.runner import ChainError, ParallelRunner

# Job accounting (docs/TELEMETRY.md): every planning decision and run
# outcome is counted per runner — except redos, decided inside
# Job.should_run where no runner context exists, counted chain-wide —
# and mirrored into the event log, so a report can answer "which PVSes
# were skipped vs. rebuilt and why".
_JOBS_PLANNED = tm.counter(
    "chain_jobs_planned_total", "jobs accepted for execution", ("runner",)
)
_JOBS_SKIPPED = tm.counter(
    "chain_jobs_skipped_total", "jobs skipped (output exists)", ("runner",)
)
_JOBS_DEDUPED = tm.counter(
    "chain_jobs_deduped_total", "identical plans submitted twice", ("runner",)
)
_JOBS_FAILED = tm.counter(
    "chain_jobs_failed_total", "jobs whose fn raised", ("runner",)
)
_JOBS_REDONE = tm.counter(
    "chain_jobs_redone_total",
    "jobs re-run over an existing output (crash sentinel)",
)
_JOB_SECONDS = tm.histogram(
    "chain_job_duration_seconds", "wall time of each executed job"
)


def mark_inprogress(output_path: str) -> bool:
    """Best-effort crash sentinel next to an output file: a run killed
    mid-write leaves it behind, and should_run then redoes the artifact
    instead of trusting a possibly-truncated file. Returns whether the
    sentinel was created (a missing parent dir leaves none)."""
    try:
        # CAS safety: a store-materialized output is HARDLINKED to its
        # object. The encoders open output paths with truncation, which
        # would destroy the shared inode — the store's bytes — while its
        # manifest still vouches for them. Breaking the link first makes
        # every rewrite copy-on-write with respect to the store.
        if os.path.isfile(output_path) and os.stat(output_path).st_nlink > 1:
            os.unlink(output_path)
        # chainlint: disable=atomic-write (crash sentinel: only its EXISTENCE is the signal — a zero-byte .inprogress is exactly as meaningful as any other)
        with open(output_path + ".inprogress", "w"):
            pass
        return True
    except OSError:
        return False


def _store():
    store = store_runtime.active()
    if store is None:
        raise ChainError("jobs need an active artifact store "
                         "(store.runtime.configure)")
    return store


def clear_inprogress(output_path: str) -> None:
    try:
        os.unlink(output_path + ".inprogress")
    except FileNotFoundError:
        pass


@dataclass
class Job:
    """One unit of work producing `output_path`, keyed by its plan.

    Stale-vs-fresh is plan-hash equality against the active store
    (store/runtime) instead of the reference's "output exists" bit: a
    committed plan is served from the store, and a corrupted cached
    object is detected on read and transparently rebuilt. The port's
    only caller, the serve scheduler, always has a plan and a store; the
    reference's jobs without either (skip-existing, adoption of
    pre-store outputs, sidecars, companion outputs, provenance logs)
    come back with the file-level chain.
    """

    label: str
    output_path: str
    fn: Callable[[], Any]
    #: plan payload (store/keys schema)
    plan: dict
    provenance: dict = field(default_factory=dict)
    #: serve-layer provenance: the request IDs this unit of work answers
    #: (chain-serve attaches overlapping requests to ONE execution, so a
    #: job may satisfy many); folded into provenance, store commits and
    #: job_* events so an artifact can always be traced back to who
    #: asked for it
    request_ids: tuple = ()
    #: distributed-trace ids riding with request_ids (serve requests
    #: mint one per POST): folded into the same provenance/event
    #: surfaces so a trace can be stitched from job events alone
    trace_ids: tuple = ()
    #: why should_run returned False ("store_hit")
    skip_reason: Optional[str] = None

    def should_run(self, runner: str = "") -> bool:
        """Plan-hash decision: hit → verify + materialize + skip;
        corrupt/miss → run. The serve plans name no input file, so the
        hash resolved here is the one the commit uses."""
        self.skip_reason = None
        store = _store()
        self._plan_hash = store.plan_hash(self.plan)
        manifest = store.lookup(self._plan_hash)
        if manifest is not None:
            if store.serve_hit(manifest, self.output_path):
                STORE_HITS.labels(runner=runner).inc()
                self.skip_reason = "store_hit"
                clear_inprogress(self.output_path)
                return False
            return True  # corruption converted to a miss; rebuild
        STORE_MISSES.labels(runner=runner).inc()
        if os.path.isfile(self._sentinel_path):
            # crashed writer: its output, if any, is never trusted
            get_logger().warning(
                "output %s: its producing run never completed (crashed?); "
                "re-running", self.output_path,
            )
            _JOBS_REDONE.inc()
            tm.emit(
                "job_redo", job=self.label,
                output=os.path.basename(self.output_path),
                reason="crash_sentinel",
            )
        return True

    @property
    def _sentinel_path(self) -> str:
        return self.output_path + ".inprogress"

    def commit_to_store(self) -> None:
        """Bind the freshly-produced artifact to its plan hash. Store I/O
        failures degrade to a warning (the artifact itself is complete)."""
        provenance = dict(self.provenance)
        if self.request_ids:
            provenance["requests"] = list(self.request_ids)
        if self.trace_ids:
            provenance["traces"] = list(self.trace_ids)
        try:
            _store().commit(
                self._plan_hash, self.output_path, producer=self.label,
                provenance=provenance,
            )
        except OSError as exc:
            get_logger().warning(
                "store: could not commit %s (%s); artifact left uncached",
                self.output_path, exc,
            )

    def run(self) -> Any:
        marked = mark_inprogress(self.output_path)
        req_fields: dict = {}
        if self.request_ids:
            req_fields["request_ids"] = list(self.request_ids)
        if self.trace_ids:
            req_fields["trace_id"] = self.trace_ids[0]
            if len(self.trace_ids) > 1:
                req_fields["trace_ids"] = list(self.trace_ids)
        tm.emit("job_start", job=self.label,
                output=os.path.basename(self.output_path), **req_fields)
        # live view: this job is in flight from here; its completion also
        # advances the enclosing stage's jobs-done progress (stage_span)
        hb = HEARTBEATS.register(self.label, kind="job")
        t0 = time.perf_counter()
        with tracing.span(self.label, output=os.path.basename(self.output_path)):
            try:
                result = self.fn()
            except BaseException as exc:
                # a partial artifact must never survive a failed job
                # (enforced here once, for every job)
                if os.path.isfile(self.output_path):
                    os.unlink(self.output_path)
                if marked:
                    clear_inprogress(self.output_path)
                hb.finish("fail")
                HEARTBEATS.stage_advance(1)
                tm.emit(
                    "job_end", job=self.label, status="fail",
                    duration_s=round(time.perf_counter() - t0, 4),
                    error=repr(exc)[:300], **req_fields,
                )
                raise
        dur = time.perf_counter() - t0
        hb.finish("ok")
        HEARTBEATS.stage_advance(1)
        _JOB_SECONDS.observe(dur)
        tm.emit("job_end", job=self.label, status="ok",
                duration_s=round(dur, 4), **req_fields)
        # commit before the sentinel clears: a crash inside the commit
        # leaves the sentinel, so the next run redoes the job instead of
        # trusting an output the store never vouched for
        self.commit_to_store()
        if marked:
            clear_inprogress(self.output_path)
        return result


class JobRunner:
    """Plans jobs against the store and executes them with fail-fast
    parallel execution."""

    def __init__(self, parallelism: int = 4, name: str = "jobs") -> None:
        self.parallelism = parallelism
        self.name = name
        self.jobs: list[Job] = []
        #: output path -> (label, canonical plan) of its writer
        self._writers: dict[str, tuple] = {}

    def add(self, job: Job) -> None:
        """Plan a job. Two *different* jobs targeting one output file is a
        write-write race the reference could silently hit (its pool dedups
        only identical command strings, reference cmd_utils.py:73-79, and
        concurrency safety rests on task independence — SURVEY.md §5);
        here it fails loudly at plan time. The same job added twice (the
        reference's dedup case, e.g. one unit shared by many requests)
        stays a silent dedup — but "same" means same label AND same plan:
        two different plans under one label targeting one output would
        hide a real divergence."""
        fp = keys.canonical_json(job.plan)
        prior = self._writers.get(job.output_path)
        if prior is not None:
            prior_label, prior_fp = prior
            if prior_label == job.label and fp == prior_fp:
                _JOBS_DEDUPED.labels(runner=self.name).inc()
                return  # same plan submitted again: dedup
            if prior_label == job.label:
                raise ChainError(
                    f"{self.name}: job '{job.label}' submitted twice "
                    f"with DIFFERENT plans for {job.output_path} — "
                    "write-write race hidden under one label"
                )
            raise ChainError(
                f"{self.name}: jobs '{prior_label}' and '{job.label}' "
                f"both write {job.output_path} — write-write race"
            )
        self._writers[job.output_path] = (job.label, fp)
        if job.should_run(runner=self.name):
            _JOBS_PLANNED.labels(runner=self.name).inc()
            # the live per-stage denominator: every planned job is one
            # unit of the enclosing stage's progress (stage_span)
            HEARTBEATS.stage_add_planned(1)
            tm.emit("job_planned", job=job.label, runner=self.name,
                    output=os.path.basename(job.output_path))
            self.jobs.append(job)
        else:
            _JOBS_SKIPPED.labels(runner=self.name).inc()
            tm.emit("job_skip", job=job.label, runner=self.name,
                    output=os.path.basename(job.output_path),
                    reason=job.skip_reason)

    def _run_job(self, job: Job) -> Any:
        """Execute one job, attributing a failure to this runner's
        telemetry series before the error propagates."""
        try:
            return job.run()
        except BaseException:
            _JOBS_FAILED.labels(runner=self.name).inc()
            raise

    def run(self) -> dict[str, Any]:
        runner = ParallelRunner(max_parallel=self.parallelism, name=self.name)
        for job in self.jobs:
            runner.add(self._run_job, job, label=job.label)
        self.jobs = []
        self._writers.clear()
        return runner.run()
