"""The port's telemetry NAME catalog: every metric and event it emits,
declared once (the port's counterpart of
processing_chain_tpu/telemetry/catalog.py, trimmed to what the port
emits).

Every name here is one the reference catalog already registers, with
the same kind: a dashboard or report that reads the reference daemon
reads the port's the same way, and chainlint's `telemetry-name` rule
(which checks call sites against the reference catalog) holds for the
port's call sites unchanged. The SLO histogram buckets and the
artifact size classes are the reference's too.
"""

from __future__ import annotations

#: metric name -> prometheus kind
METRICS: dict[str, str] = {
    # engine/jobs.py — job accounting
    "chain_jobs_planned_total": "counter",
    "chain_jobs_skipped_total": "counter",
    "chain_jobs_deduped_total": "counter",
    "chain_jobs_failed_total": "counter",
    "chain_jobs_redone_total": "counter",
    "chain_job_duration_seconds": "histogram",
    # utils/runner.py — host task execution
    "chain_runner_in_flight": "gauge",
    "chain_task_duration_seconds": "histogram",
    # store/store.py
    "chain_store_hits_total": "counter",
    "chain_store_misses_total": "counter",
    "chain_store_corrupt_total": "counter",
    "chain_store_object_bytes": "gauge",
    "chain_store_objects": "gauge",
    # serve/
    "chain_serve_requests_total": "counter",
    "chain_serve_units_total": "counter",
    "chain_serve_request_seconds": "histogram",
    "chain_serve_warm_request_seconds": "histogram",
    "chain_serve_queue_depth": "gauge",
    "chain_serve_inflight": "gauge",
    "chain_serve_waves_total": "counter",
    "chain_serve_wave_lanes": "histogram",
    "chain_serve_lease_steals_total": "counter",
    "chain_serve_fenced_settles_total": "counter",
    "chain_serve_claim_reverts_total": "counter",
    "chain_serve_quarantined_total": "counter",
    "chain_serve_poisoned_total": "counter",
    "chain_serve_queue_wait_seconds": "histogram",
    "chain_serve_execution_seconds": "histogram",
    "chain_serve_e2e_seconds": "histogram",
    "chain_serve_read_ttfb_seconds": "histogram",
    "chain_serve_read_seconds": "histogram",
    # parallel/pipeline.py — instrumented device steps
    "chain_device_step_seconds": "histogram",
    # parallel/distributed.py + parallel/halo.py — multi-process visibility
    "chain_dist_collective_bytes_total": "counter",
    "chain_dist_barrier_seconds_total": "counter",
}

#: structured event-log record names
EVENTS: frozenset = frozenset({
    "job_planned",
    "job_skip",
    "job_redo",
    "job_start",
    "job_end",
    "store_corrupt",
    "task_recovered",
    "serve_request",       # serve/service.py — request accepted
    "serve_request_done",  # serve/service.py — request completed/failed
    "serve_requeued",      # serve/queue.py — interrupted job requeued
    "serve_drain",         # serve/service.py — replica drain state flipped
    "serve_lease_stolen",  # serve/queue.py — dead/expired lease reclaimed
    "serve_lease_lost",    # serve/queue.py — heartbeat found its lease gone
    "serve_settle_fenced",     # serve/queue.py — stale-epoch settle refused
    "serve_claim_reverted",    # serve/queue.py — mid-claim disk error undone
    "serve_quarantined",   # serve/queue.py — permanent failure parked
    "serve_src_poisoned",  # serve/queue.py — SRC digest quarantined
    "serve_wave",          # serve/scheduler.py — one wave dispatched
    "device_step",         # parallel/pipeline.py — first call of a step
    "dist_init",           # parallel/distributed.py — process group joined
    "dist_collective",     # parallel/distributed.py — one cross-process
                           # collective with its payload bytes
    "barrier_wait",        # parallel/distributed.py — stage barrier wait
})

#: bucket layout of the serve SLO phase histograms (queue wait,
#: execution, end to end): the reference's, extended past every band of
#: its SLO_BANDS
SLO_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0, 600.0, 1800.0, 3600.0,
)

#: artifact size (bytes, exclusive upper bound; None = unbounded)
#: -> size-class label of the read-path histograms, checked in order
READ_SIZE_CLASSES: tuple = (
    (1 << 20, "lt1m"),
    (16 << 20, "lt16m"),
    (256 << 20, "lt256m"),
    (None, "ge256m"),
)


def read_size_class(nbytes: int) -> str:
    """The size-class label of one artifact's byte count."""
    for bound, label in READ_SIZE_CLASSES:
        if bound is None or nbytes < bound:
            return label
    return READ_SIZE_CLASSES[-1][1]


#: bucket layout of the two read histograms (TTFB and full stream)
READ_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)
