"""Job model: memoized, provenance-logged units of pipeline work (copy
of processing_chain_tpu/engine/jobs.py; the span around `Job.run` is the
host wall-time span, the reference's device trace is not carried over).

Replaces the reference's command-string + exists-check idiom (every
operator returns None when its output exists and --force is unset,
reference lib/ffmpeg.py:786-788, :964-970, :1022-1028, :1067-1073,
:1126-1132, :1271-1277) with a typed Job: the filesystem stays the
checkpoint/resume system (SURVEY.md §5), deterministic output paths are
the cache keys, and each job can write a provenance log capturing what
produced the artifact (reference p01:89-92, p03:41-59).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .. import telemetry as tm
from ..telemetry.heartbeat import HEARTBEATS
from ..store import runtime as store_runtime
from ..store.store import (
    STORE_ADOPTIONS,
    STORE_HITS,
    STORE_MISSES,
    StoreCorruption,
)
from ..utils import tracing
from ..utils.log import get_logger
from ..utils.runner import ChainError, ParallelRunner
from ..utils.version import get_processing_chain_version

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
    sentinel was created (a missing parent dir degrades to the
    reference's plain skip-existing behavior)."""
    if not output_path:
        return False
    try:
        # CAS safety: a store-materialized output is HARDLINKED to its
        # object. The encoders open output paths with truncation, which
        # would destroy the shared inode — the store's bytes — while its
        # manifest still vouches for them. Breaking the link first makes
        # every rewrite copy-on-write with respect to the store. This is
        # the one choke point every about-to-write site already passes
        # through (Job.run and the p03 batch lanes).
        if os.path.isfile(output_path) and os.stat(output_path).st_nlink > 1:
            os.unlink(output_path)
        # chainlint: disable=atomic-write (crash sentinel: only its EXISTENCE is the signal — a zero-byte .inprogress is exactly as meaningful as any other)
        with open(output_path + ".inprogress", "w"):
            pass
        return True
    except OSError:
        return False


def clear_inprogress(output_path: str) -> None:
    if not output_path:
        return
    try:
        os.unlink(output_path + ".inprogress")
    except FileNotFoundError:
        pass


@dataclass
class Job:
    """One unit of work producing `output_path`.

    With `plan` set and a store active (store/runtime), stale-vs-fresh is
    plan-hash equality against the store instead of the reference's
    "output exists" bit: one changed HRC parameter invalidates exactly
    the artifacts downstream of it, and a corrupted cached object is
    detected on read and transparently rebuilt. Jobs without a plan (or
    runs without a store) keep the legacy skip-existing semantics.
    """

    label: str
    output_path: str
    fn: Callable[[], Any]
    provenance: dict = field(default_factory=dict)
    logfile_path: Optional[str] = None
    #: plan payload (store/keys schema; file inputs via keys.file_ref)
    plan: Optional[dict] = None
    #: `output_path + suffix` files committed/materialized with the artifact
    sidecar_suffixes: tuple = ()
    #: companion files at their own absolute paths (multi-output jobs,
    #: e.g. p02's vfi/afi/buff next to the qchanges main output)
    extra_outputs: tuple = ()
    #: serve-layer provenance: the request IDs this unit of work answers
    #: (chain-serve attaches overlapping requests to ONE execution, so a
    #: job may satisfy many); folded into provenance, store commits and
    #: job_* events so an artifact can always be traced back to who
    #: asked for it
    request_ids: tuple = ()
    #: distributed-trace ids riding with request_ids (serve requests
    #: mint one per POST; docs/TELEMETRY.md "Fleet observability &
    #: tracing"): folded into the same provenance/event surfaces so a
    #: trace can be stitched from job events alone
    trace_ids: tuple = ()
    #: why should_run returned False
    #: ("output_exists" | "store_hit" | "store_adopted")
    skip_reason: Optional[str] = None

    @property
    def _sentinel_path(self) -> str:
        return self.output_path + ".inprogress"

    def _resolve_plan_hash(self, store) -> Optional[str]:
        """Hash this job's plan against the store; None (with a debug log)
        when an input file is unreadable — e.g. a removed intermediate —
        which degrades that one decision to the legacy exists-check."""
        try:
            return store.plan_hash(self.plan)
        except OSError as exc:
            get_logger().debug(
                "store: cannot resolve plan for %s (%s); using legacy "
                "skip-existing", self.label, exc,
            )
            return None

    def _store_should_run(
        self, store, force: bool, dry_run: bool, runner: str
    ) -> bool:
        """Plan-hash decision: hit → verify + materialize + skip;
        corrupt/miss → run. Only called when the plan hash resolved."""
        if force:
            return True
        manifest = store.lookup(self._plan_hash)
        if manifest is not None:
            if store.serve_hit(manifest, self.output_path,
                               materialize=not dry_run):
                STORE_HITS.labels(runner=runner).inc()
                self.skip_reason = "store_hit"
                if not dry_run:
                    clear_inprogress(self.output_path)
                return False
            return True  # corruption converted to a miss; rebuild
        STORE_MISSES.labels(runner=runner).inc()
        if not os.path.isfile(self.output_path):
            return True
        if os.path.isfile(self._sentinel_path):
            # crashed writer: never adopt a truncated output. Same redo
            # forensics as the legacy path — the sentinel story in the
            # event log must not disappear when --store is on.
            get_logger().warning(
                "output %s exists but its producing run never completed "
                "(crashed?); re-running", self.output_path,
            )
            _JOBS_REDONE.inc()
            tm.emit(
                "job_redo", job=self.label,
                output=os.path.basename(self.output_path),
                reason="crash_sentinel",
            )
            return True
        if not all(os.path.isfile(p) for p in self.extra_outputs):
            return True  # partial multi-output set: rebuild, never adopt
        if store.should_adopt(self.output_path):
            # pre-store artifact on its first store-enabled run: keep the
            # legacy skip-existing trust, but bind it to the current plan
            # hash (with the commit-time integrity probe) so every LATER
            # change is detected by hash inequality. A failed probe means
            # the existing file is corrupt — rebuild it now.
            if dry_run:  # planning must not mutate the store
                self.skip_reason = "store_adopted"
                return False
            try:
                store.commit(
                    self._plan_hash, self.output_path, producer=self.label,
                    provenance=self.provenance,
                    sidecar_suffixes=self.sidecar_suffixes,
                    extra_outputs=self.extra_outputs, adopted=True,
                )
            except (StoreCorruption, OSError) as exc:
                get_logger().warning(
                    "output %s exists but cannot be adopted into the store "
                    "(%s); rebuilding", self.output_path, exc,
                )
                return True
            STORE_ADOPTIONS.inc()
            self.skip_reason = "store_adopted"
            get_logger().info(
                "output %s adopted into the artifact store (pre-store "
                "artifact, first sight)", self.output_path,
            )
            return False
        # the legacy idiom would have trusted this file; hash inequality
        # against the plans that previously produced it says its plan
        # changed under it
        get_logger().info(
            "output %s exists but its plan hash changed; rebuilding",
            self.output_path,
        )
        _JOBS_REDONE.inc()
        tm.emit(
            "job_redo", job=self.label,
            output=os.path.basename(self.output_path),
            reason="plan_changed",
        )
        return True

    def should_run(self, force: bool, dry_run: bool = False,
                   runner: str = "") -> bool:
        self.skip_reason = None
        self._plan_hash = None
        store = store_runtime.active()
        if store is not None and self.plan is not None and self.output_path:
            self._plan_hash = self._resolve_plan_hash(store)
        if self._plan_hash is not None:
            return self._store_should_run(store, force, dry_run, runner)
        if force or not self.output_path:
            return True
        if any(not os.path.isfile(p) for p in self.extra_outputs):
            # a missing companion file must regenerate even when the main
            # output exists (p02's tables are one artifact set; the model
            # layer's per-file guards keep existing files untouched)
            return True
        if os.path.isfile(self.output_path):
            if os.path.isfile(self._sentinel_path):
                # crash consistency: a SIGKILLed/power-lost run leaves a
                # possibly-truncated output that plain skip-existing (the
                # reference's idiom — it shares this hole) would wrongly
                # accept. The sentinel marks an unfinished run; databases
                # produced elsewhere carry no sentinels and are untouched.
                get_logger().warning(
                    "output %s exists but its producing run never "
                    "completed (crashed?); re-running",
                    self.output_path,
                )
                _JOBS_REDONE.inc()
                tm.emit(
                    "job_redo", job=self.label,
                    output=os.path.basename(self.output_path),
                    reason="crash_sentinel",
                )
                return True
            get_logger().warning(
                "output %s already exists, will not convert. Use --force to "
                "force overwriting.",
                self.output_path,
            )
            self.skip_reason = "output_exists"
            return False
        return True

    def commit_to_store(self) -> None:
        """Bind the freshly-produced artifact to its plan hash. The hash
        is ALWAYS re-resolved here: an input produced earlier in the same
        run (p03's stalling pass reads the wo_buffer render) makes any
        plan-time hash stale, and committing under it would bind the new
        bytes to the old inputs. Store I/O failures degrade to a warning
        (the artifact itself is complete); a failed container read-back
        probe raises — an output that does not decode must fail HERE, not
        when something consumes it."""
        store = store_runtime.active()
        if store is None or self.plan is None or not self.output_path:
            return
        self._plan_hash = self._resolve_plan_hash(store)
        if self._plan_hash is None or not os.path.isfile(self.output_path):
            return
        provenance = dict(self.provenance)
        if self.request_ids:
            provenance["requests"] = list(self.request_ids)
        if self.trace_ids:
            provenance["traces"] = list(self.trace_ids)
        try:
            store.commit(
                self._plan_hash, self.output_path, producer=self.label,
                provenance=provenance,
                sidecar_suffixes=self.sidecar_suffixes,
                extra_outputs=self.extra_outputs,
            )
        except StoreCorruption:
            raise
        except OSError as exc:
            get_logger().warning(
                "store: could not commit %s (%s); artifact left uncached",
                self.output_path, exc,
            )

    def complete_externally(self) -> None:
        """Finalize an output whose bytes were produced OUTSIDE run() —
        the p03 batch waves and the fused p03+p04 driver (models/fused)
        render many member artifacts in one pass, then bind each to its
        own existing plan hash through this: provenance, the store
        commit (plan hash re-resolved against the final input bytes,
        exactly as run()'s tail does), and only then the crash-sentinel
        clear — a crash inside the commit leaves the sentinel, so the
        next run redoes the artifact instead of trusting bytes the
        store never vouched for."""
        self.write_provenance()
        self.commit_to_store()
        clear_inprogress(self.output_path)

    def write_provenance(self) -> None:
        if not self.logfile_path:
            return
        record = {
            "output": os.path.basename(self.output_path),
            "processingChain": get_processing_chain_version(),
            "job": self.label,
            **self.provenance,
        }
        if self.request_ids:
            record["requests"] = list(self.request_ids)
        if self.trace_ids:
            record["traces"] = list(self.trace_ids)
        os.makedirs(os.path.dirname(self.logfile_path), exist_ok=True)
        from ..utils.fsio import atomic_write_text

        atomic_write_text(self.logfile_path, "".join(
            f"{key}: {json.dumps(value) if not isinstance(value, str) else value}\n"
            for key, value in record.items()
        ))

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
                # streaming jobs surface decode errors mid-write: a partial
                # artifact must never survive to satisfy a later run's
                # skip-existing check (enforced here once, for every job)
                if self.output_path and os.path.isfile(self.output_path):
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
        self.write_provenance()
        # commit before the sentinel clears: a crash inside the commit
        # leaves the sentinel, so the next run redoes the job instead of
        # trusting an output the store never vouched for
        self.commit_to_store()
        # removed only after the output (and its provenance) are complete:
        # a crash anywhere above leaves the sentinel and the next run redoes
        # the job instead of trusting a possibly-truncated artifact
        if marked:
            clear_inprogress(self.output_path)
        return result


def device_stage_parallelism(requested: int, stage: str, cap: int = 4) -> int:
    """Clamp a device stage's `-p` to `cap`, telling the user when it bites.

    Device-stage jobs pipeline decode→device→encode internally
    (engine/prefetch) in O(CHUNK) memory, so extra width buys host
    decode/encode overlap across PVSes at ~CHUNK×depth frames of RAM each;
    compiled-graph executions still serialize through the chip's queue, so
    past the reference's own pool width (4, lib/parse_args.py:67-72) more
    workers only queue."""
    capped = max(1, min(requested, cap))
    if requested > capped:
        get_logger().info(
            "%s: capping parallelism %d -> %d (device jobs pipeline "
            "decode/compute/encode internally; wider only costs host RAM)",
            stage, requested, capped,
        )
    return capped


class JobRunner:
    """Plans and executes jobs with skip-existing / force / dry-run
    semantics and fail-fast parallel execution."""

    def __init__(self, force: bool = False, dry_run: bool = False,
                 parallelism: int = 4, name: str = "jobs") -> None:
        self.force = force
        self.dry_run = dry_run
        self.parallelism = parallelism
        self.name = name
        self.jobs: list[Job] = []
        #: output path -> (label, plan fingerprint | None) of its writer
        self._writers: dict[str, tuple] = {}

    @staticmethod
    def _plan_fingerprint(job: Job) -> Optional[str]:
        """Canonical serialization of the UNRESOLVED plan (no file I/O):
        cheap, deterministic, and exactly what distinguishes two plans
        submitted under one label."""
        if job.plan is None:
            return None
        from ..store import keys

        try:
            return keys.canonical_json(job.plan)
        except keys.PlanError:
            # an unhashable plan will surface at should_run/commit time;
            # the dedup decision degrades to the legacy label compare
            return None

    def add(self, job: Optional[Job]) -> None:
        """Plan a job. Two *different* jobs targeting one output file is a
        write-write race the reference could silently hit (its pool dedups
        only identical command strings, reference cmd_utils.py:73-79, and
        concurrency safety rests on task independence — SURVEY.md §5);
        here it fails loudly at plan time. The same job added twice (the
        reference's dedup case, e.g. one segment shared by many PVSes)
        stays a silent dedup — but "same" means same label AND same plan:
        two different plans under one label targeting one output used to
        dedup silently, hiding a real divergence."""
        if job is None:
            return
        if job.output_path:
            fp = self._plan_fingerprint(job)
            prior = self._writers.get(job.output_path)
            if prior is not None:
                prior_label, prior_fp = prior
                if prior_label == job.label and (
                    fp is None or prior_fp is None or fp == prior_fp
                ):
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
        if job.should_run(self.force, self.dry_run, runner=self.name):
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
                    reason=job.skip_reason or "output_exists")

    def _run_job(self, job: Job) -> Any:
        """Execute one job, attributing a failure to this runner's
        telemetry series before the error propagates."""
        try:
            return job.run()
        except BaseException:
            _JOBS_FAILED.labels(runner=self.name).inc()
            raise

    def run(self) -> dict[str, Any]:
        log = get_logger()
        if self.dry_run:
            for job in self.jobs:
                log.info("[dry-run] %s -> %s", job.label, job.output_path)
            planned = self.jobs
            self.jobs = []
            self._writers.clear()
            return {j.label: None for j in planned}
        runner = ParallelRunner(max_parallel=self.parallelism, name=self.name)
        for job in self.jobs:
            runner.add(self._run_job, job, label=job.label)
        self.jobs = []
        self._writers.clear()
        return runner.run()

    def run_serial(self) -> dict[str, Any]:
        """Run jobs one by one in order (for device-bound stages — one chip,
        serialized device queue). Failures become ChainError so the CLI can
        map them to a clean exit 1."""
        log = get_logger()
        results = {}
        jobs, self.jobs = self.jobs, []
        self._writers.clear()
        for job in jobs:
            if self.dry_run:
                log.info("[dry-run] %s -> %s", job.label, job.output_path)
                results[job.label] = None
            else:
                try:
                    results[job.label] = self._run_job(job)
                except Exception as exc:
                    raise ChainError(
                        f"{self.name}: job '{job.label}' failed: {exc!r}"
                    ) from exc
        return results
