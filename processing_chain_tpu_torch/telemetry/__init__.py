"""Telemetry subsystem of the port: metrics registry + structured run
events (copy of processing_chain_tpu/telemetry/__init__.py).

The quantitative observability layer the span recorder (utils/tracing)
does not cover: counters/gauges/histograms for throughput and queueing,
and a structured JSONL event log for run forensics. Metric and event
names are the reference catalog's (telemetry/catalog.py).

Enablement is process-wide and OFF by default; every instrumentation
site is guarded so a disabled run pays one attribute check per call
site, with zero allocation. `write_outputs(DIR, stamp)` persists three
artifacts into DIR:

    metrics_<ts>.json    registry snapshot (counters/gauges/histograms)
    metrics_<ts>.prom    Prometheus textfile-collector export
    events_<ts>.jsonl    the structured event log

under one collision-safe <ts> stamp, which `profiling.Profiler` and
`utils.tracing.write_report` share so telemetry/report.py (`tools
run-report`) and tools/chain_profile.py can join them.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from .events import (  # noqa: F401  (re-exports)
    EVENTS,
    EventLog,
    emit,
    read_jsonl,
)
from .heartbeat import (  # noqa: F401
    HEARTBEATS,
    HeartbeatRegistry,
    TaskCancelled,
)
from ..utils import lockdebug
from .metrics import (  # noqa: F401
    DEFAULT_DEPTH_BUCKETS,
    DEFAULT_LATENCY_BUCKETS,
    REGISTRY,
    MetricError,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)


def enabled() -> bool:
    return REGISTRY.enabled


def enable() -> None:
    REGISTRY.enabled = True
    EVENTS.enabled = True
    HEARTBEATS.enabled = True


def disable() -> None:
    REGISTRY.enabled = False
    EVENTS.enabled = False
    HEARTBEATS.enabled = False


def reset() -> None:
    """Zero all series, drop all events and heartbeats (for a fresh run
    in one process — registrations and bound handles stay valid)."""
    REGISTRY.reset()
    EVENTS.clear()
    HEARTBEATS.reset()


def unique_stamp() -> str:
    """Wall-clock stamp that never collides within a process even when
    two callers hit the same second: pid + a monotonic counter."""
    global _STAMP_SEQ
    with _STAMP_LOCK:
        _STAMP_SEQ += 1
        seq = _STAMP_SEQ
    return f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}-{seq}"


_STAMP_SEQ = 0
_STAMP_LOCK = lockdebug.make_lock("stamp")

# Cross-layer counters the stage spans diff against (the reference's
# decode and encode choke points increment them; the port has neither
# yet, so they read 0 until its media boundary lands).
FRAMES_DECODED = counter(
    "chain_frames_decoded_total", "video frames decoded into the pipeline"
)
FRAMES_ENCODED = counter(
    "chain_frames_encoded_total", "video frames written back out"
)
BYTES_ENCODED = counter(
    "chain_bytes_encoded_total", "raw plane bytes handed to writers"
)
STAGE_SECONDS = gauge(
    "chain_stage_wall_seconds", "wall time of the last run of each stage",
    ("stage",),
)


@contextmanager
def stage_span(stage: str, **fields) -> Iterator[None]:
    """Wrap one stage run: emits stage_start/stage_end events
    carrying the frames/bytes counter deltas, from which a report derives
    per-stage throughput without any per-stage plumbing inside the
    models layer. Also opens the stage's live heartbeat (units = jobs;
    planned by JobRunner.add, advanced by Job completion) so /status can
    answer per-stage progress + ETA while the stage runs."""
    if not REGISTRY.enabled and not HEARTBEATS.enabled:
        yield
        return
    from . import profiling as _profiling

    before = (
        FRAMES_DECODED.get(), FRAMES_ENCODED.get(), BYTES_ENCODED.get(),
    )
    # component seconds (decode/encode blocked time, device transfer,
    # device step) diffed across the stage: the per-stage grounding of
    # the attribution engine's bottleneck verdicts
    before_comp = (
        _profiling.components_from_live()[0] if REGISTRY.enabled else None
    )
    # decoder opens diffed per stage: the attribution engine refuses a
    # decode_bound verdict for a stage that opened ZERO decoders (its
    # consumer-blocked seconds are in-memory plumbing, not decode;
    # telemetry/profiling.attribute_run)
    before_opens = (
        REGISTRY.sum_series("chain_io_decoder_opens_total", None)
        if REGISTRY.enabled else None
    )
    emit("stage_start", stage=stage, **fields)
    HEARTBEATS.stage_begin(stage)
    t0 = time.perf_counter()
    status = "ok"
    try:
        yield
    except BaseException:
        status = "fail"
        raise
    finally:
        wall = time.perf_counter() - t0
        STAGE_SECONDS.labels(stage=stage).set(wall)
        HEARTBEATS.stage_end(stage, status)
        extra = dict(fields)
        if before_comp is not None:
            # only components measured by the END of the stage get a
            # delta (a series born mid-stage starts from 0); components
            # with no series at all stay absent — the attribution engine
            # reports them as unmeasured instead of zero
            after_comp = _profiling.components_from_live()[0]
            extra["components"] = {
                comp: round(total - before_comp.get(comp, 0.0), 4)
                for comp, total in after_comp.items()
            }
            after_opens = REGISTRY.sum_series(
                "chain_io_decoder_opens_total", None
            )
            if after_opens is not None:
                extra["decoder_opens"] = int(
                    after_opens - (before_opens or 0.0)
                )
        emit(
            "stage_end",
            stage=stage,
            status=status,
            duration_s=round(wall, 4),
            frames_decoded=FRAMES_DECODED.get() - before[0],
            frames_encoded=FRAMES_ENCODED.get() - before[1],
            bytes_encoded=BYTES_ENCODED.get() - before[2],
            **extra,
        )


def write_outputs(out_dir: str, stamp: Optional[str] = None) -> dict[str, str]:
    """Persist the registry + event log into `out_dir` under one stamp.
    Returns {"metrics": path, "prom": path, "events": path, "stamp": s}."""
    stamp = stamp or unique_stamp()
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "metrics": REGISTRY.write_json(
            os.path.join(out_dir, f"metrics_{stamp}.json")
        ),
        "prom": REGISTRY.write_prometheus(
            os.path.join(out_dir, f"metrics_{stamp}.prom")
        ),
        "events": EVENTS.write_jsonl(
            os.path.join(out_dir, f"events_{stamp}.jsonl")
        ),
        "stamp": stamp,
    }
    return paths
