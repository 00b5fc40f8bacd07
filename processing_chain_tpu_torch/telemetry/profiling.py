"""Profiling & performance attribution layer of the port (copy of
processing_chain_tpu/telemetry/profiling.py, its device parts on torch).

Three answers the metrics/events layers cannot give on their own:

1. **Where did the resources go while the run was alive?** —
   `ResourceMonitor`, a low-overhead sampling thread (RSS, open fds,
   CPU%, BufferPool free/outstanding bytes, live prefetch queue depths,
   and — when this process has already initialised CUDA — each card's
   allocated bytes from `torch.cuda.memory_stats`) recorded as a bounded
   timeseries, mirrored into resource gauges so `/metrics`, the
   Prometheus export, and `/status` carry the current values.

2. **What was each execution resource doing WHEN?** — `build_chrome_trace`
   merges the host span recorder (`utils/tracing.Tracer`: jobs, stage
   spans, prefetch chunks, transfer:device_put/get, and the
   `device:<step>` spans `parallel/pipeline._instrument_step` and the wave
   loop record around each blocking device wait) with the structured
   event log into ONE Chrome-trace JSON (`chrome://tracing` / Perfetto).
   Host and device-step spans share the tracer's `perf_counter` clock by
   construction. Beside it, `Profiler` captures a `torch.profiler` trace
   (CPU activity, plus CUDA activity where CUDA is available: kernels,
   copies, memsets) into `device_<stamp>/`. That trace has a clock of its
   own and stays a separate file.

3. **Why was the run slow?** — the attribution engine reduces the
   component seconds the chain measures (consumer blocked time = starved
   by decode, producer blocked time = backed up behind encode, device
   transfer seconds, device step seconds) into a per-stage verdict:
   `decode_bound | transfer_bound | compute_bound | encode_bound |
   balanced | fragmentation_bound`, with contributor percentages.
   `telemetry.stage_span` embeds the per-stage component deltas in each
   stage_end event; `classify_components` is the pure classifier the
   report and `tools chain-profile` render.

The `active()` flag gates the extra per-chunk spans in engine/prefetch,
parallel/p03_batch and parallel/pipeline so ordinary runs record nothing
new.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Iterable, Optional, Sequence

from .metrics import REGISTRY, gauge
from ..utils import lockdebug

# --------------------------------------------------------------- gauges
# Mirrored from every ResourceMonitor sample (and any sample_resources
# call) so the live /metrics render and the post-run Prometheus export
# carry the latest values without a second collection path.

_RSS = gauge("chain_resource_rss_bytes", "resident set size of the chain process")
_FDS = gauge("chain_resource_open_fds", "open file descriptors of the chain process")
_CPU = gauge(
    "chain_resource_cpu_percent",
    "process CPU usage over the last sampling interval (100 = one core)",
)
_POOL_FREE = gauge(
    "chain_bufpool_free_bytes", "bytes parked on the buffer pool's free lists"
)
_POOL_OUT = gauge(
    "chain_bufpool_outstanding_bytes",
    "bytes of pool blocks currently owned by the pipeline",
)
_QDEPTH = gauge(
    "chain_resource_queue_depth",
    "current depth of the live bounded pipeline queues (summed per name)",
    ("queue",),
)
_DEVMEM = gauge(
    "chain_device_memory_bytes",
    "allocated bytes per card from torch.cuda.memory_stats (bytes_in_use, "
    "peak_bytes_in_use) and its total memory (bytes_limit); device=\"all\" "
    "carries the sum over the process's cards",
    ("device", "kind"),
)

#: Verdicts the attribution engine can return.
VERDICTS = (
    "decode_bound", "transfer_bound", "compute_bound", "encode_bound",
    "balanced", "fragmentation_bound",
)

#: a "balanced" run whose mesh waves padded away at least this fraction
#: of their dispatched frame-slots is reclassified fragmentation_bound —
#: no single component dominates because the device time itself is spent
#: on padding, and "balanced" would hide the one thing to fix
#: (docs/PERF.md "my waves are wasteful")
FRAGMENTATION_WASTE_THRESHOLD = 0.25

#: component -> (metric name, label filter) — the measured seconds each
#: verdict is grounded in. "decode" and "encode" are the BLOCKED times of
#: the pipeline (a starved consumer is waiting on decode; a blocked
#: producer is backed up behind encode) — the directly-attributable cost
#: of those phases to the critical path, not their raw busy time.
COMPONENT_METRICS = {
    "decode": ("chain_pipeline_wait_seconds_total", {"side": "consumer"}),
    "encode": ("chain_pipeline_wait_seconds_total", {"side": "producer"}),
    "transfer": ("chain_device_transfer_seconds_total", None),
    "compute": ("chain_device_step_seconds", None),
}

_ACTIVE = False


def active() -> bool:
    """Whether a profile capture is in flight (gates the per-chunk
    prefetch/transfer/device spans — one module-flag check)."""
    return _ACTIVE


def maybe_span(name: str, **meta):
    """A tracer span while a profile capture is active, else a no-op
    context — THE gate for the per-chunk lane spans, expressed once so a
    future change (e.g. a sampling rate) has one home. `meta` rides the
    span into the merged Chrome trace as `args` (the wave spans carry
    their valid/pad slot breakdown this way)."""
    if not _ACTIVE:
        from contextlib import nullcontext

        return nullcontext()
    from ..utils import tracing

    return tracing.span(name, **meta)


# ---------------------------------------------------------------- sampling


_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _read_rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return None


def _read_open_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def _read_cpu_ticks() -> Optional[float]:
    try:
        with open("/proc/self/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        # fields 14/15 of /proc/<pid>/stat (utime, stime) land at index
        # 11/12 after the comm field is stripped
        return float(int(parts[11]) + int(parts[12]))
    except (OSError, ValueError, IndexError):
        return None


class _CpuTracker:
    """CPU% between consecutive calls on ONE tracker. Each consumer owns
    its own (the monitor loop, the shared /status default) — a shared
    baseline would let any caller shrink every other caller's interval
    to milliseconds, where utime+stime quantize to whole scheduler ticks
    and read as 0% or thousand-percent spikes."""

    #: below this the tick granularity (1/_CLK_TCK) dominates the signal
    MIN_INTERVAL_S = 0.2

    def __init__(self) -> None:
        self._lock = lockdebug.make_lock("resource_monitor")
        self._last: Optional[tuple[float, float]] = None  # (perf_counter, ticks)

    def percent(self) -> Optional[float]:
        ticks = _read_cpu_ticks()
        if ticks is None:
            return None
        now = time.perf_counter()
        with self._lock:
            last = self._last
            if last is not None and now - last[0] < self.MIN_INTERVAL_S:
                # keep the old baseline: a fast re-poll must not destroy
                # the interval the next honest call will measure over
                return None
            self._last = (now, ticks)
        if last is None:
            return None
        return 100.0 * (ticks - last[1]) / _CLK_TCK / (now - last[0])


#: default tracker for one-shot callers (/status, ad-hoc samples)
_SHARED_CPU = _CpuTracker()


def _device_memory() -> tuple[dict[str, float], dict[str, dict]]:
    """(summed totals, per-card stats) of the CUDA caching allocator —
    ONLY when this process has already initialised CUDA (sampling must
    never create a context: from the monitor thread that would start a
    backend the run never asked for). Per-card entries are keyed
    "cuda:<i>", the `device` label of chain_device_memory_bytes:
    `bytes_in_use` is `allocated_bytes.all.current`, `peak_bytes_in_use`
    `allocated_bytes.all.peak` (since the last reset_peak_memory_stats),
    `bytes_limit` the card's total memory (its properties'
    `total_memory`, the total `torch.cuda.mem_get_info` reports, read
    without entering the card: on a card this process never used,
    mem_get_info would create a context). Bytes the allocator holds
    reserved but has not handed out are not counted. Reads neither change
    nor depend on the calling thread's current device."""
    import torch

    if not torch.cuda.is_initialized():
        return {}, {}
    totals: dict[str, float] = {}
    per_device: dict[str, dict] = {}
    try:
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            entry = {
                "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": float(torch.cuda.get_device_properties(i).total_memory),
            }
            for key, val in entry.items():
                totals[key] = totals.get(key, 0.0) + val
            per_device[f"cuda:{i}"] = entry
    except RuntimeError:  # a card lost mid-run: sampling must not raise
        return {}, {}
    return totals, per_device


def sample_resources(
    include_device: bool = True, cpu: Optional[_CpuTracker] = None,
) -> dict:
    """One cheap resource snapshot (also the `/status` `resources`
    section, so it must stay safe to call with the full profiler off).
    Mirrors current values into the resource gauges when telemetry is
    enabled. Periodic callers pass their own `cpu` tracker so their
    CPU%% interval is theirs alone."""
    from ..engine import prefetch as _prefetch
    from ..io import bufpool as _bufpool

    pool = _bufpool.DEFAULT_POOL.stats()
    queues = _prefetch.live_queue_depths()
    sample: dict = {
        "rss_bytes": _read_rss_bytes(),
        "open_fds": _read_open_fds(),
        "cpu_percent": (cpu or _SHARED_CPU).percent(),
        "pool_free_bytes": pool["free_bytes"],
        "pool_outstanding_bytes": pool["outstanding_bytes"],
        "pool_free_blocks": pool["free_blocks"],
        "pool_outstanding_blocks": pool["outstanding"],
        "queues": {name: entry["depth"] for name, entry in queues.items()},
    }
    if include_device:
        devmem, per_device = _device_memory()
        if devmem:
            sample["device_memory"] = devmem
        if per_device:
            sample["device_memory_by_device"] = per_device
    if REGISTRY.enabled:
        if sample["rss_bytes"] is not None:
            _RSS.set(sample["rss_bytes"])
        if sample["open_fds"] is not None:
            _FDS.set(sample["open_fds"])
        if sample["cpu_percent"] is not None:
            _CPU.set(round(sample["cpu_percent"], 2))
        _POOL_FREE.set(sample["pool_free_bytes"])
        _POOL_OUT.set(sample["pool_outstanding_bytes"])
        for name, depth in sample["queues"].items():
            _QDEPTH.labels(queue=name).set(depth)
        # a queue that died since the last sample must read 0, not stay
        # latched at its final depth in /metrics and the end-of-run
        # snapshot (a phantom full queue reads as a stall)
        with _SEEN_QUEUES_LOCK:
            gone = _SEEN_QUEUES - set(sample["queues"])
            _SEEN_QUEUES.update(sample["queues"])
        for name in gone:
            _QDEPTH.labels(queue=name).set(0)
        for kind, val in sample.get("device_memory", {}).items():
            _DEVMEM.labels(device="all", kind=kind).set(val)
        for dev_label, stats in sample.get(
                "device_memory_by_device", {}).items():
            for kind, val in stats.items():
                _DEVMEM.labels(device=dev_label, kind=kind).set(val)
    return sample


_SEEN_QUEUES: set = set()
_SEEN_QUEUES_LOCK = lockdebug.make_lock("seen_queues")


def format_resource_peaks(peaks: dict) -> list[str]:
    """The shared one-line-per-peak rendering both surfaces (run-report's
    resources section, chain-profile) print — one home so a new peak
    field cannot appear on one surface and silently drop from the other."""
    lines = []
    if peaks.get("rss_bytes"):
        lines.append(f"peak rss: {peaks['rss_bytes'] / 1e6:.0f} MB")
    if peaks.get("pool_outstanding_bytes"):
        lines.append(
            "peak pool outstanding: "
            f"{peaks['pool_outstanding_bytes'] / 1e6:.0f} MB"
        )
    for q, d in sorted(peaks.get("queue_depths", {}).items()):
        lines.append(f"peak queue depth {q}: {int(d)}")
    if peaks.get("device_memory_bytes"):
        lines.append(
            f"peak device memory: {peaks['device_memory_bytes'] / 1e6:.0f} MB"
        )
    for dev_label, val in sorted(
            peaks.get("device_memory_by_device", {}).items()):
        lines.append(
            f"peak device memory {dev_label}: {val / 1e6:.0f} MB")
    return lines


def resource_peaks(timeseries: dict) -> dict:
    """Peaks of a resource timeseries (a loaded resources_<ts>.json or a
    raw {"samples": [...]}). Stored peak fields are preferred, samples
    are the fallback — the single home both renderers (report's
    resources section, chain-profile) draw from."""
    samples = timeseries.get("samples", [])
    peaks: dict = {}
    rss = timeseries.get("peak_rss_bytes") or max(
        (s.get("rss_bytes") or 0 for s in samples), default=0
    )
    if rss:
        peaks["rss_bytes"] = rss
    pool = timeseries.get("peak_pool_outstanding_bytes")
    if pool is None:
        pool = max(
            (s.get("pool_outstanding_bytes", 0) for s in samples), default=0
        )
    if pool:
        peaks["pool_outstanding_bytes"] = pool
    queues = timeseries.get("peak_queue_depths")
    if queues is None:
        queues = {}
        for s in samples:
            for q, d in s.get("queues", {}).items():
                queues[q] = max(queues.get(q, 0), d)
    if queues:
        peaks["queue_depths"] = dict(queues)
    dev = max(
        (s.get("device_memory", {}).get("peak_bytes_in_use", 0)
         for s in samples), default=0,
    )
    if dev:
        peaks["device_memory_bytes"] = dev
    per_device: dict = {}
    for s in samples:
        for dev_label, stats in s.get("device_memory_by_device",
                                      {}).items():
            per_device[dev_label] = max(
                per_device.get(dev_label, 0),
                stats.get("peak_bytes_in_use", 0))
    if per_device:
        peaks["device_memory_by_device"] = per_device
    return peaks


class ResourceMonitor:
    """Sampling thread recording `sample_resources()` as a bounded
    timeseries. `max_samples` caps host memory (a week-long run keeps
    the most recent window, and the gauges always carry the current
    values); `interval_s` is clamped to >= 0.05 so a typo cannot turn
    the monitor into a busy loop."""

    def __init__(self, interval_s: float = 1.0, max_samples: int = 7200) -> None:
        self.interval_s = max(0.05, float(interval_s))
        self._samples: deque = deque(maxlen=max(1, int(max_samples)))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0_perf = time.perf_counter()
        self._cpu = _CpuTracker()  # private interval, immune to /status polls

    def _sample_once(self) -> None:
        now = time.perf_counter()
        try:
            sample = sample_resources(cpu=self._cpu)
        except Exception:  # noqa: BLE001 - monitoring must never kill a run
            return
        sample["t"] = round(now - self._t0_perf, 3)
        sample["t_perf"] = now
        self._samples.append(sample)

    def start(self) -> "ResourceMonitor":
        if self._thread is None:
            self._stop.clear()
            self._t0_perf = time.perf_counter()
            self._sample_once()  # a run shorter than one interval still records

            def loop() -> None:
                while not self._stop.wait(self.interval_s):
                    self._sample_once()

            self._thread = threading.Thread(
                target=loop, name="chain-resource-monitor", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
            self._sample_once()  # final snapshot: how the run ended

    def samples(self) -> list[dict]:
        return list(self._samples)

    def to_timeseries(self) -> dict:
        samples = self.samples()
        out = {
            "schema": 1,
            "interval_s": self.interval_s,
            "n_samples": len(samples),
            "samples": [
                {k: v for k, v in s.items() if k != "t_perf"} for s in samples
            ],
        }
        peaks = resource_peaks({"samples": samples})
        if "rss_bytes" in peaks:
            out["peak_rss_bytes"] = peaks["rss_bytes"]
        if "pool_outstanding_bytes" in peaks:
            out["peak_pool_outstanding_bytes"] = peaks["pool_outstanding_bytes"]
        if "queue_depths" in peaks:
            out["peak_queue_depths"] = peaks["queue_depths"]
        return out

    def write_json(self, path: str) -> str:
        from ..utils.fsio import atomic_write

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        doc = self.to_timeseries()

        def write(tmp: str) -> None:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)

        atomic_write(path, write)  # a teardown SIGKILL must not leave a torn file
        return path

    def __enter__(self) -> "ResourceMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# --------------------------------------------------------- merged timeline

#: event kinds worth a timeline marker (the queue-depth sampler alone
#: could contribute thousands of records that say nothing a counter
#: track doesn't)
_TRACE_EVENT_KINDS = (
    "stage_start", "stage_end", "job_start", "job_end", "device_step",
    "task_stalled", "task_hard_timeout", "task_recovered", "barrier_wait",
    "mesh_compile", "dist_init", "dist_collective",
)


def _span_lane(name: str) -> tuple[str, str]:
    """(category, display name) for one span. Device-step and transfer
    spans get their own lanes so the timeline reads decode | compute |
    transfer | encode at a glance."""
    for prefix, cat in (
        ("device:", "device"),
        ("transfer:", "transfer"),
        ("prefetch:", "decode"),
        ("writeback:", "encode"),
    ):
        if name.startswith(prefix):
            return cat, name[len(prefix):]
    return "host", name


def build_chrome_trace(
    spans: Sequence,
    events: Iterable[dict] = (),
    resources: Iterable[dict] = (),
    events_offset_s: float = 0.0,
    tracer_t0_perf: Optional[float] = None,
) -> dict:
    """Merge host spans (`utils.tracing.Span` objects — device-step spans
    included, same perf_counter clock), selected event-log records, and
    resource samples into one Chrome-trace document.

    `events_offset_s` maps event timestamps (relative to the event log's
    t0) onto the tracer clock: `EVENTS t0_perf - tracer t0_perf`.
    Resource samples carry an absolute `t_perf`; `tracer_t0_perf` maps
    them the same way. All timestamps clamp at 0 (an event emitted
    before the tracer was reset cannot produce a negative tick)."""
    pid = os.getpid()
    trace_events: list[dict] = []
    tids: dict[str, int] = {}

    def tid_for(thread: str, cat: str) -> int:
        # device/transfer lanes render as their own pseudo-threads so the
        # viewer shows host rows and device rows separately even though
        # the recording thread is a host thread
        key = f"{cat}:{thread}" if cat in ("device", "transfer") else thread
        if key not in tids:
            tids[key] = len(tids) + 1
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tids[key], "args": {"name": key},
            })
        return tids[key]

    for span in spans:
        cat, name = _span_lane(span.name)
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "pid": pid,
            "tid": tid_for(span.thread, cat),
            "ts": max(0, int(span.start * 1e6)),
            "dur": max(1, int(span.duration * 1e6)),
        }
        if span.meta:
            # same primitive filter as event args: span(**meta) accepts
            # arbitrary values, and one Path/ndarray must not make the
            # whole document unserializable at run teardown
            args = {
                k: v for k, v in span.meta.items()
                if isinstance(v, (str, int, float, bool))
            }
            if args:
                ev["args"] = args
        trace_events.append(ev)

    for rec in events:
        kind = rec.get("event")
        if kind not in _TRACE_EVENT_KINDS:
            continue
        ts = max(0.0, float(rec.get("t", 0.0)) + events_offset_s)
        args = {
            k: v for k, v in rec.items()
            if k not in ("event", "t") and isinstance(v, (str, int, float, bool))
        }
        trace_events.append({
            "name": kind, "cat": "events", "ph": "i", "s": "p",
            "pid": pid, "tid": tid_for("events", "events"),
            "ts": int(ts * 1e6), "args": args,
        })

    counter_tid = None
    for sample in resources:
        t_perf = sample.get("t_perf")
        if t_perf is None or tracer_t0_perf is None:
            continue
        ts = max(0, int((t_perf - tracer_t0_perf) * 1e6))
        if counter_tid is None:
            counter_tid = tid_for("resources", "resources")
        counters = {
            "rss_mb": round((sample.get("rss_bytes") or 0) / 1e6, 1),
            "pool_outstanding_mb": round(
                sample.get("pool_outstanding_bytes", 0) / 1e6, 1
            ),
        }
        for queue, depth in sample.get("queues", {}).items():
            counters[f"queue_{queue}"] = depth
        for name, value in counters.items():
            trace_events.append({
                "name": name, "cat": "resources", "ph": "C",
                "pid": pid, "tid": counter_tid, "ts": ts,
                "args": {"value": value},
            })

    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "processing_chain_tpu_torch --profile"},
    }


def device_annotation(name: str):
    """`torch.profiler.record_function(name)` while a profile capture is
    active (so the capture's trace labels the step's launches), else a
    no-op context."""
    from contextlib import nullcontext

    if not _ACTIVE:
        return nullcontext()
    import torch

    return torch.profiler.record_function(name)


# ------------------------------------------------------- device trace reads

#: Chrome-trace categories of torch.profiler's events on the card's
#: timeline, by kind of work
DEVICE_EVENT_KINDS = {"kernel": ("kernel",), "copy": ("gpu_memcpy",),
                      "memset": ("gpu_memset",)}


def load_device_trace(trace_dir: str) -> dict:
    """The torch.profiler Chrome trace a `Profiler` capture wrote."""
    from ..utils.tracing import DeviceProfiler

    with open(os.path.join(trace_dir, DeviceProfiler.TRACE_FILE)) as f:
        return json.load(f)


def device_events(trace: dict, kind: str) -> list[dict]:
    """Complete ("X") events of one kind (DEVICE_EVENT_KINDS) of a
    torch.profiler trace, in start order."""
    cats = DEVICE_EVENT_KINDS[kind]
    return sorted((e for e in trace.get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("cat") in cats),
                  key=lambda e: float(e["ts"]))


def annotation_range(trace: dict, name: str) -> Optional[tuple[float, float]]:
    """(start, end) µs of the host-side `record_function(name)` range in a
    torch.profiler trace (its first occurrence), or None. Host and card
    events share the trace's one timeline, which is not the span
    tracer's clock."""
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == name:
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
    return None


def busy_share(events: Sequence[dict], lo: float, hi: float) -> float:
    """Share of [lo, hi] (µs) covered by the union of the events'
    [ts, ts + dur] intervals."""
    if hi <= lo:
        return 0.0
    covered, end = 0.0, lo
    for e in sorted(events, key=lambda e: float(e["ts"])):
        a = max(float(e["ts"]), end)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), hi)
        if b > a:
            covered += b - a
            end = b
    return covered / (hi - lo)


# ------------------------------------------------------------- attribution


def components_from_metrics(metrics: dict) -> tuple[dict[str, float], list[str]]:
    """(component seconds, missing components) from a metrics snapshot
    (the live `REGISTRY.snapshot()` or a loaded metrics_<ts>.json — same
    shape). A component is MISSING when its metric has no series at all
    (e.g. no device ever dispatched); a present metric at 0.0 is a real
    measurement."""
    def series(name: str) -> list[dict]:
        return metrics.get(name, {}).get("series", [])

    def total(name: str, labels: Optional[dict]) -> float:
        out = 0.0
        for s in series(name):
            if labels is None or s.get("labels", {}) == labels:
                out += float(s.get("value", s.get("sum", 0.0)))
        return out

    components: dict[str, float] = {}
    missing: list[str] = []
    for comp, (metric, labels) in COMPONENT_METRICS.items():
        has = any(
            labels is None or s.get("labels", {}) == labels
            for s in series(metric)
        )
        if has:
            components[comp] = round(total(metric, labels), 4)
        else:
            missing.append(comp)
    return components, missing


def components_from_live() -> tuple[dict[str, float], list[str]]:
    """Current component seconds straight from the live registry
    (targeted per-metric reads — never a full snapshot under the
    registry lock). Components whose metric has no series are in the
    missing list, same contract as `components_from_metrics` —
    `telemetry.stage_span` diffs this across a stage so stage_end
    events carry measured deltas only, and never-recorded components
    stay distinguishable as *unmeasured* per stage."""
    components: dict[str, float] = {}
    missing: list[str] = []
    for comp, (metric, labels) in COMPONENT_METRICS.items():
        total = REGISTRY.sum_series(metric, labels)
        if total is None:
            missing.append(comp)
        else:
            components[comp] = round(total, 4)
    return components, missing


def classify_components(
    components: dict[str, Optional[float]],
    missing: Iterable[str] = (),
    min_total_s: float = 0.05,
    dominance: float = 0.4,
    lead: float = 1.5,
) -> dict:
    """Pure bottleneck classifier. `components` maps component name ->
    measured seconds (None entries are treated as missing). The verdict
    is `<top>_bound` when the top contributor holds >= `dominance` of
    the measured total AND leads the runner-up by `lead`x; anything
    flatter is `balanced`. A measured total under `min_total_s` is
    `balanced` with `insufficient_data` set — there is nothing to
    attribute, and the report says so instead of inventing a verdict."""
    present = {
        k: max(0.0, float(v)) for k, v in components.items() if v is not None
    }
    missing = sorted(set(missing) | (set(components) - set(present)))
    total = sum(present.values())
    contributors = sorted(present.items(), key=lambda kv: -kv[1])
    out = {
        "components_s": {k: round(v, 4) for k, v in present.items()},
        "missing": missing,
        "total_s": round(total, 4),
    }
    pct = [
        {"component": name, "seconds": round(sec, 4),
         "pct": round(100.0 * sec / total, 1)}
        for name, sec in contributors
    ] if total > 1e-9 else []
    out["contributors"] = pct
    if total < min_total_s or not contributors:
        # nothing substantial to attribute: the percentages (if any) are
        # still reported, but no *_bound verdict is invented from noise
        out["verdict"] = "balanced"
        out["insufficient_data"] = True
        return out
    top_name, top_sec = contributors[0]
    runner_up = contributors[1][1] if len(contributors) > 1 else 0.0
    if top_sec / total >= dominance and top_sec >= lead * max(runner_up, 1e-9):
        out["verdict"] = f"{top_name}_bound"
    else:
        out["verdict"] = "balanced"
    return out


def attribute_run(metrics: dict, events: Sequence[dict]) -> dict[str, dict]:
    """Per-stage verdicts for one run. Prefers the per-stage component
    deltas `stage_span` embeds in stage_end events; a run without them
    (older artifacts, single-layer runs) degrades to ONE whole-run
    verdict from the global metrics under the pseudo-stage "run"."""
    verdicts: dict[str, dict] = {}
    for rec in events:
        if rec.get("event") != "stage_end":
            continue
        comps = rec.get("components")
        if not isinstance(comps, dict):
            continue
        stage = rec.get("stage", "?")
        # components absent from the event were unmeasured for the whole
        # stage (no series existed) — report them as such, not as zeros
        reattributed = False
        if rec.get("decoder_opens") == 0 and comps.get("decode"):
            # consumer-blocked seconds in a stage that opened ZERO
            # decoders cannot be decode time: the stage consumed
            # in-memory streams (the fused p04 fan-out renders CPVS
            # from device-resident frames) and the waits are pipeline
            # plumbing. Without this gate a fused run's p03/p04 stages
            # could report decode_bound on a decode that never happened
            # — the exact verdict the fusion exists to retire.
            comps = dict(comps, decode=0.0)
            reattributed = True
        result = classify_components(
            comps, missing=set(COMPONENT_METRICS) - set(comps)
        )
        if reattributed:
            result["decode_reattributed"] = True
        result["wall_s"] = rec.get("duration_s")
        verdicts[stage] = result
    if not verdicts and metrics:
        components, missing = components_from_metrics(metrics)
        verdicts["run"] = classify_components(components, missing)
    # bucket-fragmentation input (parallel/meshobs.py): a run whose
    # device time is mostly padding has no dominant component to blame —
    # the flat profile IS the symptom, and "balanced" would bury it
    waste = mesh_waste_from_metrics(metrics) if metrics else None
    if waste is not None:
        for result in verdicts.values():
            result["mesh_waste_fraction"] = waste
            if (result.get("verdict") == "balanced"
                    and not result.get("insufficient_data")
                    and waste >= FRAGMENTATION_WASTE_THRESHOLD):
                result["verdict"] = "fragmentation_bound"
    return verdicts


def mesh_waste_from_metrics(metrics: dict) -> Optional[float]:
    """Padded-slot fraction of all dispatched wave slots, from the
    chain_mesh_wave_slots_total series of a metrics snapshot. None when
    the wave loop never dispatched (no series) — absence of evidence,
    not a 0.0 measurement."""
    series = metrics.get("chain_mesh_wave_slots_total",
                         {}).get("series", [])
    valid = padded = 0.0
    for s in series:
        kind = s.get("labels", {}).get("kind")
        value = float(s.get("value", 0.0))
        if kind == "valid":
            valid += value
        elif kind:
            padded += value
    total = valid + padded
    if total <= 0:
        return None
    return round(padded / total, 4)


# ------------------------------------------------------------ orchestration


class Profiler:
    """Profile capture: resource monitor + `torch.profiler` capture
    (utils/tracing.DeviceProfiler) while the run is in flight;
    `stop(stamp)` persists

        profile_<stamp>.trace.json    merged Chrome trace (host spans + events)
        resources_<stamp>.json        the resource timeseries
        device_<stamp>/trace.json     the torch.profiler trace (CPU ops, and
                                      on a CUDA host the kernels, copies and
                                      memsets on the card's own clock)

    into DIR. Start/stop are idempotent and never raise: profiling is
    diagnosis, not a new way to fail a run. A device trace that was asked
    for and not written is never hidden: `stop()`'s paths carry
    `device_trace_error` and the event log an ERROR `log` record."""

    def __init__(
        self, out_dir: str, interval_s: float = 1.0,
        device_trace: Optional[bool] = None,
    ) -> None:
        self.out_dir = out_dir
        self.monitor = ResourceMonitor(interval_s=interval_s)
        self._device = None  # the capture's DeviceProfiler
        self._started = False
        #: None = auto (on when this process has initialised CUDA); True
        #: = always (a CPU-only torch.profiler capture where CUDA is not
        #: initialised); False = never — for a caller that already runs
        #: its own torch.profiler session (two profilers in one process
        #: collide)
        self._device_trace = device_trace

    def _want_device_trace(self) -> bool:
        if self._device_trace is not None:
            return self._device_trace
        # default: only where there is device activity worth the capture
        # overhead — CPU runs take the host-only profile
        import torch

        return torch.cuda.is_initialized()

    def start(self, stamp: str) -> "Profiler":
        global _ACTIVE
        if self._started:
            return self
        self._started = True
        _ACTIVE = True
        os.makedirs(self.out_dir, exist_ok=True)
        self.monitor.start()
        if self._want_device_trace():
            from ..utils.tracing import DeviceProfiler

            self._device = DeviceProfiler(os.path.join(self.out_dir, f"device_{stamp}"))
            self._device.start()
        return self

    def stop(self, stamp: str) -> dict[str, str]:
        global _ACTIVE
        if not self._started:
            return {}
        self._started = False
        _ACTIVE = False
        self.monitor.stop()
        device, self._device = self._device, None
        device_trace = device.stop() if device is not None else None
        paths: dict[str, str] = {}
        try:
            paths["resources"] = self.monitor.write_json(
                os.path.join(self.out_dir, f"resources_{stamp}.json")
            )
        except OSError:
            pass
        try:
            from ..utils import tracing

            from .events import EVENTS

            tracer = tracing.get_tracer()
            doc = build_chrome_trace(
                tracer.spans(),
                events=EVENTS.records(),
                resources=self.monitor.samples(),
                events_offset_s=EVENTS._t0_perf - tracer._t0,
                tracer_t0_perf=tracer._t0,
            )
            from ..utils.fsio import atomic_write

            path = os.path.join(self.out_dir, f"profile_{stamp}.trace.json")

            def write(tmp: str) -> None:
                with open(tmp, "w") as f:
                    json.dump(doc, f)

            # atomic: a torn trace under the LATEST stamp would break
            # chain-profile's default-stamp path even with older intact
            # captures present
            atomic_write(path, write)
            paths["trace"] = path
        except (OSError, TypeError, ValueError):
            # the never-raise contract: a teardown serialization surprise
            # must not replace the run's own outcome
            pass
        if device is not None:
            if device_trace is not None:
                paths["device_trace_dir"] = device.trace_dir
            else:
                from .events import emit

                error = device.error or "torch.profiler wrote no trace"
                paths["device_trace_error"] = error
                emit("log", level="ERROR", message=f"device trace: {error}")
        return paths
