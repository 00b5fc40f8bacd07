"""The port's telemetry NAME catalog: every metric and event it emits,
declared once (the port's counterpart of
processing_chain_tpu/telemetry/catalog.py, trimmed to what the port
emits).

Every name here is one the reference catalog already registers, with
the same kind: a dashboard or report that reads the reference daemon
reads the port's the same way. The port's `tools chain-lint`
(tools/chainlint) checks the port's call sites against this catalog and
this catalog against docs/TELEMETRY.md. The SLO histogram buckets and the
artifact size classes are the reference's too.
"""

from __future__ import annotations

#: metric name -> prometheus kind
METRICS: dict[str, str] = {
    # telemetry/__init__.py — cross-layer counters and stage spans
    "chain_frames_decoded_total": "counter",
    "chain_frames_encoded_total": "counter",
    "chain_bytes_encoded_total": "counter",
    "chain_stage_wall_seconds": "gauge",
    "chain_stage_items": "gauge",
    # models/fused.py — fan-out members dropped to the staged pass
    "chain_fused_members_degraded_total": "counter",
    # engine/prefetch.py — bounded-queue pipeline
    "chain_queue_depth": "histogram",
    "chain_pipeline_wait_seconds_total": "counter",
    # io/video.py, io/medialib.py, io/sharedscan.py, io/framesizes.py — the
    # media boundary: chunk-granular crossings, decoder opens, demux/parse
    # passes that are not decoder opens, the shared post-encode scan cache
    # and the frame-size memo
    "chain_io_batch_calls_total": "counter",
    "chain_io_decoder_opens_total": "counter",
    "chain_io_framesizes_cache_hits_total": "counter",
    "chain_io_scan_passes_total": "counter",
    "chain_io_sharedscan_hits_total": "counter",
    "chain_io_sharedscan_misses_total": "counter",
    # io/bufpool.py — host block recycling
    "chain_bufpool_hits_total": "counter",
    "chain_bufpool_misses_total": "counter",
    "chain_bufpool_recycled_bytes_total": "counter",
    # parallel/p03_batch.py — the wave loop's host<->device copies
    "chain_device_transfer_seconds_total": "counter",
    "chain_device_transfer_bytes_total": "counter",
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
    "chain_store_adoptions_total": "counter",
    "chain_store_corrupt_total": "counter",
    "chain_store_object_bytes": "gauge",
    "chain_store_objects": "gauge",
    "chain_store_evictions_total": "counter",
    # store/heat.py — read accounting and eviction regret
    "chain_store_reads_total": "counter",
    "chain_store_read_bytes_total": "counter",
    "chain_store_eviction_regret_total": "counter",
    # store/tiers.py — hot/warm/cold placement
    "chain_store_tier_hits_total": "counter",
    "chain_store_tier_promotions_total": "counter",
    "chain_store_tier_demotions_total": "counter",
    "chain_store_tier_bytes": "gauge",
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
    # serve/pressure.py — bytes the budget pass evicted
    "chain_serve_gc_evicted_bytes_total": "counter",
    # serve/cost.py — predicted-cost model and admission
    "chain_serve_cost_predicted_seconds_total": "counter",
    "chain_serve_cost_observed_seconds_total": "counter",
    "chain_serve_cost_error_ratio": "histogram",
    "chain_serve_cost_rejected_total": "counter",
    "chain_serve_cost_calibration_scale": "gauge",
    # parallel/pipeline.py — instrumented device steps
    "chain_device_step_seconds": "histogram",
    # telemetry/profiling.py — resource monitor
    "chain_resource_rss_bytes": "gauge",
    "chain_resource_open_fds": "gauge",
    "chain_resource_cpu_percent": "gauge",
    "chain_resource_queue_depth": "gauge",
    "chain_bufpool_free_bytes": "gauge",
    "chain_bufpool_outstanding_bytes": "gauge",
    "chain_device_memory_bytes": "gauge",
    # parallel/meshobs.py — wave occupancy and the step ledger
    "chain_mesh_waves_total": "counter",
    "chain_mesh_wave_slots_total": "counter",
    "chain_mesh_wave_seconds": "histogram",
    "chain_mesh_waste_fraction": "gauge",
    "chain_mesh_recompiles_total": "counter",
    "chain_mesh_compile_seconds_total": "counter",
    # parallel/distributed.py + parallel/halo.py — multi-process visibility
    "chain_dist_collective_bytes_total": "counter",
    "chain_dist_barrier_seconds_total": "counter",
    # telemetry/alerts.py — the burn-rate engine
    "chain_alerts_fired_total": "counter",
    "chain_alerts_resolved_total": "counter",
    "chain_alerts_active": "gauge",
    # serve/autoscale.py — the scale signal
    "chain_scale_desired_replicas": "gauge",
    "chain_scale_backlog_seconds": "gauge",
}

#: structured event-log record names
EVENTS: frozenset = frozenset({
    "log_meta",        # head record of every events_<ts>.jsonl
    "run_start",       # cli.py — a stage CLI run with telemetry on
    "run_end",
    "stage_start",     # telemetry.stage_span
    "stage_end",
    "queue_depth",     # engine/prefetch.py — every 64th depth sample
    "task_stalled",    # telemetry/watchdog.py — soft threshold crossed
    "task_hard_timeout",  # telemetry/watchdog.py — hard threshold crossed
    "mesh_wave",       # parallel/meshobs.py — one wave step dispatched
    "mesh_compile",    # parallel/meshobs.py — first dispatch of a step
    "log",             # WARNING+ chain log records (EventLogHandler),
                       # a profile's missing device trace
    "fused_member_degraded",  # models/fused.py — member dropped mid-stream
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
    "store_evict",         # store/gc.py — manifest evicted
    "serve_gc",            # serve/pressure.py — budget pass ran
    "store_regret",        # store/heat.py — recently-evicted plan re-read
                           # or rebuilt (cache undersizing)
    "store_promote",       # store/tiers.py — object moved toward hot
    "store_demote",        # store/tiers.py — object moved toward cold
    "serve_admission_rejected",  # serve/cost.py — over-budget POST refused
    "alert_fired",         # telemetry/alerts.py — a burn-rate rule tripped
    "alert_resolved",      # telemetry/alerts.py — a firing rule cleared
    "scale_signal",        # serve/autoscale.py — a desired-replica
                           # recommendation was (re)graded
})

# --------------------------------------------------------------- SLOs
#
# The serve fleet's latency bands, per SLO phase and priority class
# (seconds), the reference's: queue_wait_s (enqueue/requeue -> claim),
# execution_s (claim -> settle), e2e_s (submit -> done). A
# (tenant x priority) flow is "ok" when at least SLO_TARGET_FRACTION of
# its observations fall inside the band (telemetry/fleet.py grades them,
# telemetry/alerts.py burns against them).

#: phase -> {priority class -> band, seconds}
SLO_BANDS: dict[str, dict[str, float]] = {
    "queue_wait_s": {"interactive": 2.5, "normal": 30.0, "bulk": 300.0},
    "execution_s": {"interactive": 30.0, "normal": 120.0, "bulk": 600.0},
    "e2e_s": {"interactive": 60.0, "normal": 300.0, "bulk": 1800.0},
}

#: a flow meets its SLO when this fraction of observations is in-band
SLO_TARGET_FRACTION = 0.99

#: bucket layout of the serve SLO phase histograms (queue wait,
#: execution, end to end): the reference's, extended past every band of
#: SLO_BANDS above
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


#: read phase -> {size class -> band, seconds}
READ_SLO_BANDS: dict[str, dict[str, float]] = {
    "read_ttfb_s": {"lt1m": 0.05, "lt16m": 0.1, "lt256m": 0.25,
                    "ge256m": 0.5},
    "read_s": {"lt1m": 0.25, "lt16m": 2.5, "lt256m": 30.0,
               "ge256m": 120.0},
}

#: bucket layout of the two read histograms (TTFB and full stream)
READ_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# ---------------------------------------------------------- alert rules
#
# The burn-rate engine (telemetry/alerts.py) grades every rule below
# against the fleet-merged view; the rules and windows are the
# reference's, so a port replica and a reference replica on one root
# fire the same alerts.

#: multi-window multi-burn-rate pairs: a pair trips only when BOTH its
#: short and long windows burn error budget faster than `burn_rate` x
#: the steady rate that would exactly exhaust it. Window seconds scale
#: uniformly via the engine's `window_scale`.
BURN_RATE_WINDOWS: dict[str, dict[str, float]] = {
    "fast": {"short_s": 300.0, "long_s": 3600.0, "burn_rate": 14.4},
    "slow": {"short_s": 1800.0, "long_s": 21600.0, "burn_rate": 6.0},
}

#: alert rule name -> declaration; `source` picks the fleet-view plane
#: the rule reads
ALERT_RULES: dict[str, dict] = {
    # SLO burn over the fleet-merged request-phase histograms
    "slo_burn_queue_wait": {"source": "slo", "phase": "queue_wait_s",
                            "severity": "page"},
    "slo_burn_execution": {"source": "slo", "phase": "execution_s",
                           "severity": "page"},
    "slo_burn_e2e": {"source": "slo", "phase": "e2e_s",
                     "severity": "page"},
    # SLO burn over the artifact read path (TTFB / full stream)
    "slo_burn_read_ttfb": {"source": "read_slo", "phase": "read_ttfb_s",
                           "severity": "page"},
    "slo_burn_read_stream": {"source": "read_slo", "phase": "read_s",
                             "severity": "ticket"},
    # watchdog stall episodes (telemetry/watchdog.py)
    "watchdog_task_stalled": {"source": "stalls", "incident": "stalled",
                              "severity": "ticket"},
    "watchdog_hard_timeout": {"source": "stalls",
                              "incident": "hard_timeout",
                              "severity": "page"},
    # eviction-regret records (store/heat.py)
    "store_eviction_regret": {"source": "heat", "severity": "ticket",
                              "min_regrets": 1},
    # wave fragmentation (parallel/meshobs.py): a geometry bucket wasting
    # more than the fragmentation threshold over at least `min_waves`
    "mesh_waste_high": {"source": "mesh", "severity": "ticket",
                        "min_waves": 3},
    # a replica whose serve-info exists but whose process stopped
    # answering
    "fleet_replica_stale": {"source": "replicas", "severity": "page",
                            "stale_after_s": 30.0},
}
