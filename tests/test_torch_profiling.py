"""The port's profiling and attribution plane against the JAX package's
(telemetry/profiling, telemetry/report, tools/chain_profile), on the CPU.

The attribution engine, the merged Chrome trace, the report and the
chain-profile summary are plain Python on dicts: the same inputs through
both packages must give EQUAL outputs. The device parts are the port's
own: `sample_resources` reads `torch.cuda.memory_stats` (checked here
through a monkeypatched torch.cuda, and never initialising CUDA),
`Profiler` captures a torch.profiler trace (CPU activity here). A
profiled `run_bucket` on a 4-slot CPU mesh records the same
`chain_mesh_*` slot and wave counts as JAX `run_bucket` on the 8-device
mesh, and transfer bytes that differ from the JAX package's by exactly
what the two wave loops move differently (below)."""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from processing_chain_tpu import telemetry as jtm
from processing_chain_tpu.parallel import make_mesh as jmake_mesh
from processing_chain_tpu.parallel import meshobs as jmeshobs
from processing_chain_tpu.parallel import p03_batch as jb
from processing_chain_tpu.telemetry import profiling as jprof
from processing_chain_tpu.telemetry import report as jreport
from processing_chain_tpu.tools import chain_profile as jcp
from processing_chain_tpu.utils import tracing as jtracing
from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.engine import prefetch as tpf
from processing_chain_tpu_torch.io.bufpool import DEFAULT_POOL, BufferPool
from processing_chain_tpu_torch.ops import cuda_kernels as ck
from processing_chain_tpu_torch.parallel import mesh as tmesh
from processing_chain_tpu_torch.parallel import meshobs as tmeshobs
from processing_chain_tpu_torch.parallel import p03_batch as tb
from processing_chain_tpu_torch.parallel import pipeline as tpipe
from processing_chain_tpu_torch.telemetry import profiling as prof
from processing_chain_tpu_torch.telemetry import report as treport
from processing_chain_tpu_torch.tools import chain_profile as tcp
from processing_chain_tpu_torch.utils import tracing

SH, SW, DH, DW = 36, 64, 72, 128


@pytest.fixture(autouse=True)
def clean_telemetry():
    for pkg in (tm, jtm):
        pkg.reset()
        pkg.enable()
    yield
    for pkg in (tm, jtm):
        pkg.disable()
        pkg.reset()
    tmeshobs.detach_journal()
    jmeshobs.detach_journal()


# ------------------------------------------------------------- classifier

CLASSIFY_CASES = [
    ({"decode": 20.0, "encode": 0.5, "transfer": 0.5, "compute": 0.5}, {}),
    ({"decode": 0.5, "encode": 20.0, "transfer": 0.5, "compute": 0.5}, {}),
    ({"decode": 0.5, "encode": 0.5, "transfer": 20.0, "compute": 0.5}, {}),
    ({"decode": 0.5, "encode": 0.5, "transfer": 0.5, "compute": 20.0}, {}),
    ({"decode": 1.0, "encode": 1.1}, {}),
    ({"decode": 1.0, "encode": 1.0, "transfer": 1.0, "compute": 1.0}, {}),
    ({"a": 4.0, "b": 2.0, "c": 2.0, "d": 2.0}, {"dominance": 0.4, "lead": 1.5}),
    ({"a": 4.0, "b": 3.0, "c": 2.0, "d": 1.0}, {}),
    ({"decode": 0.01, "encode": 0.002}, {}),
    ({"decode": 6.0, "compute": None}, {"missing": ["transfer"]}),
    ({}, {"missing": ["decode", "encode", "transfer", "compute"]}),
]


@pytest.mark.parametrize("components,kw", CLASSIFY_CASES)
def test_classifier_equals_jax(components, kw):
    """tests/test_profiling.py's classifier cases through both packages."""
    out = prof.classify_components(components, **kw)
    assert out == jprof.classify_components(components, **kw)
    if set(components) <= set(prof.COMPONENT_METRICS):
        assert out["verdict"] in prof.VERDICTS


_SNAP_WAITS = {"chain_pipeline_wait_seconds_total": {"series": [
    {"labels": {"side": "consumer"}, "value": 3.5},
    {"labels": {"side": "producer"}, "value": 0.0},
]}}
_SNAP_SLOTS = {
    "chain_pipeline_wait_seconds_total": {"series": [
        {"labels": {"side": "consumer"}, "value": 1.0},
        {"labels": {"side": "producer"}, "value": 1.1}]},
    "chain_device_transfer_seconds_total": {"series": [
        {"labels": {"direction": "put"}, "value": 0.9}]},
    "chain_mesh_wave_slots_total": {"series": [
        {"labels": {"bucket": "b", "kind": "valid"}, "value": 30.0},
        {"labels": {"bucket": "b", "kind": "pad_tail"}, "value": 10.0},
        {"labels": {"bucket": "b", "kind": "pad_mesh"}, "value": 8.0}]},
}
_STAGE_END = {"event": "stage_end", "stage": "p03", "duration_s": 10.0,
              "components": {"decode": 8.0, "encode": 0.5, "transfer": 0.2,
                             "compute": 0.4}}

ATTRIBUTION_CASES = [
    ({}, [_STAGE_END]),
    ({"chain_pipeline_wait_seconds_total": {"series": [
        {"labels": {"side": "producer"}, "value": 9.0},
        {"labels": {"side": "consumer"}, "value": 1.0}]}}, []),
    (_SNAP_WAITS, []),
    (_SNAP_SLOTS, []),
    (_SNAP_SLOTS, [dict(_STAGE_END, components={"decode": 1.0, "encode": 1.0})]),
    ({}, [{"event": "stage_end", "stage": "p04", "duration_s": 3.0,
           "decoder_opens": 0, "components": {"decode": 5.0, "compute": 1.0}}]),
    ({}, [{"event": "stage_end", "stage": "pX", "components": {"decode": 2.5, "encode": 0.0}}]),
]


@pytest.mark.parametrize("metrics,events", ATTRIBUTION_CASES)
def test_attribution_equals_jax(metrics, events):
    """components_from_metrics, mesh_waste_from_metrics and attribute_run
    (stage deltas, the whole-run fallback, the zero-decoder reattribution,
    fragmentation_bound) give the JAX package's results."""
    assert prof.components_from_metrics(metrics) == jprof.components_from_metrics(metrics)
    assert prof.mesh_waste_from_metrics(metrics) == jprof.mesh_waste_from_metrics(metrics)
    got = prof.attribute_run(metrics, events)
    assert got == jprof.attribute_run(metrics, events)
    assert all(v["verdict"] in prof.VERDICTS for v in got.values())


def test_stage_span_component_deltas_equal_jax():
    """Both packages' stage_span embed the same component deltas: a measured
    zero stays a zero, a never-recorded component stays absent."""
    for pkg in (tm, jtm):
        wait = pkg.counter("chain_pipeline_wait_seconds_total",
                           "time the pipeline spent blocked on a bounded queue, by side",
                           ("side",))
        with pkg.stage_span("pX"):
            wait.labels(side="consumer").inc(2.5)
            wait.labels(side="producer").inc(0.0)
    ends = [[e for e in pkg.EVENTS.records() if e["event"] == "stage_end"][-1]
            for pkg in (tm, jtm)]
    keys = ("stage", "status", "components", "frames_decoded", "frames_encoded",
            "bytes_encoded")
    assert {k: ends[0][k] for k in keys} == {k: ends[1][k] for k in keys}
    assert ends[0]["components"] == {"decode": 2.5, "encode": 0.0}
    assert prof.components_from_live() == jprof.components_from_live()


# ------------------------------------------------------------ merged trace


def _spans_events_samples():
    tracer = tracing.Tracer()
    with tracer.span("job outer", frames=48, label="a", path=object()):
        with tracer.span("device:step_a"):
            time.sleep(0.002)
        with tracer.span("transfer:device_put"):
            pass
        with tracer.span("prefetch:decode"):
            pass
    events = [{"event": "stage_end", "t": 0.001, "stage": "p03"},
              {"event": "queue_depth", "t": 0.002, "depth": 1},
              {"event": "mesh_compile", "t": 0.003, "bucket": "b", "seconds": 0.1}]
    samples = [{"t_perf": tracer._t0 + 0.001, "rss_bytes": 1e9,
                "pool_outstanding_bytes": 5e6, "queues": {"decode": 2}},
               {"t_perf": None, "rss_bytes": 1.0}]
    return tracer, events, samples


def test_chrome_trace_equals_jax():
    """The same spans, events and resource samples give JSON-equal
    documents; only the producer tag names the package."""
    tracer, events, samples = _spans_events_samples()
    kw = dict(events=events, resources=samples, events_offset_s=0.0005,
              tracer_t0_perf=tracer._t0)
    ours = json.loads(json.dumps(prof.build_chrome_trace(tracer.spans(), **kw)))
    ref = json.loads(json.dumps(jprof.build_chrome_trace(tracer.spans(), **kw)))
    assert ours["otherData"] == {"producer": "processing_chain_tpu_torch --profile"}
    ours.pop("otherData"), ref.pop("otherData")
    assert ours == ref
    cats = {e["cat"] for e in ours["traceEvents"] if e["ph"] == "X"}
    assert {"host", "device", "transfer", "decode"} <= cats


# ----------------------------------------------------- a profiled CPU wave


def _lanes(pkg, lengths, seed, sink=None):
    rng = np.random.default_rng(seed)
    lanes = []
    for i, n in enumerate(lengths):
        yuv = [rng.integers(0, 256, s).astype(np.uint8)
               for s in ((n, SH, SW), (n, SH // 2, SW // 2), (n, SH // 2, SW // 2))]
        parts = [[p[:3] for p in yuv], [p[3:] for p in yuv]] if n > 3 else [yuv]
        lanes.append(pkg.Lane(chunks=iter(parts), emit=sink or (lambda planes: None),
                              n_frames_hint=n, name=f"lane{i:02d}"))
    return lanes


def _series(snapshot, name):
    return {tuple(sorted(s["labels"].items())): s.get("value", s.get("count"))
            for s in snapshot.get(name, {}).get("series", [])}


def test_profiled_run_bucket_metrics_match_jax(devices8):
    """The port's run_bucket on make_mesh(["cpu"] * 4) and JAX run_bucket
    on the 8-device mesh (pvs 4, time 2; t_step 4 both) over the same
    lanes: equal chain_mesh_waves_total and chain_mesh_wave_slots_total
    series and waste fraction. Transfer bytes: the JAX loop uploads the TI
    carry with every block (n_pvs x DH x DW u8) and counts the three
    fetched planes; the port keeps the carry on the device and counts all
    five fetched outputs (the planes + SI and TI, n_pvs x t_step f32
    each). Past those the byte counts are equal."""
    lengths = [11, 4, 2, 7, 5]
    bucket = tb.bucket_label(DH, DW, False, SH, SW)
    tb.run_bucket(_lanes(tb, lengths, 3), tmesh.make_mesh(["cpu"] * 4), DH, DW,
                  "bicubic", (2, 2), False, chunk=4, bucket=bucket)
    jb.run_bucket(_lanes(jb, lengths, 3), jmake_mesh(devices8, time_parallel=2), DH, DW,
                  "bicubic", (2, 2), False, chunk=4, bucket=bucket)
    ours, ref = tm.REGISTRY.snapshot(), jtm.REGISTRY.snapshot()
    for name in ("chain_mesh_waves_total", "chain_mesh_wave_slots_total"):
        assert _series(ours, name) == _series(ref, name), name
    assert prof.mesh_waste_from_metrics(ours) == jprof.mesh_waste_from_metrics(ref) > 0
    assert _series(ours, "chain_mesh_wave_seconds") == _series(ref, "chain_mesh_wave_seconds")
    blocks = sum(_series(ours, "chain_mesh_waves_total").values())
    assert blocks == 4  # 11-frame lane: 3 blocks; the 2-frame lane alone: 1
    n_pvs, t_step = 4, 4
    put, get = (_series(ours, "chain_device_transfer_bytes_total")[(("direction", d),)]
                for d in ("put", "get"))
    jput, jget = (_series(ref, "chain_device_transfer_bytes_total")[(("direction", d),)]
                  for d in ("put", "get"))
    assert put == jput - blocks * n_pvs * DH * DW
    assert get == jget + blocks * n_pvs * t_step * 4 * 2
    assert put == blocks * n_pvs * t_step * (SH * SW * 3 // 2)
    for pkg_snap in (ours, ref):
        seconds = _series(pkg_snap, "chain_device_transfer_seconds_total")
        assert set(seconds) == {(("direction", "put"),), (("direction", "get"),)}
        assert all(v > 0 for v in seconds.values())
    # the consumer side of each lane's prefetcher is measured (decode)
    comps, missing = prof.components_from_metrics(ours)
    assert "decode" in comps and "transfer" in comps and comps["transfer"] > 0


def _write_run(out, stamp):
    """One profiled port run written the way a caller writes it: the
    profile artifacts, the telemetry outputs, the span report and a wave
    journal, all under one stamp."""
    tracing.get_tracer().clear()
    tmeshobs.attach_journal(os.path.join(out, f"meshobs_{stamp}"), replica="r0")
    p = prof.Profiler(out, interval_s=0.05, device_trace=False).start(stamp)
    try:
        with tm.stage_span("p03"):
            tb.run_bucket(_lanes(tb, [9, 5, 3], 5), tmesh.make_mesh(["cpu"] * 2), DH, DW,
                          chunk=4, bucket=tb.bucket_label(DH, DW, False, SH, SW))
            step = tpipe._instrument_step(tpipe.avpvs_siti_step, "avpvs_siti_step")
            y = torch.zeros((4, SH, SW), dtype=torch.uint8)
            u = torch.zeros((4, SH // 2, SW // 2), dtype=torch.uint8)
            step(y, u, u.clone(), DH, DW)
        paths = p.stop(stamp)
    finally:
        tmeshobs.detach_journal()
    tm.write_outputs(out, stamp)
    tracing.get_tracer().write_report(out, stamp)
    return paths


def test_report_and_chain_profile_render_as_jax(tmp_path):
    """A run directory written by the port renders the same text through
    the port's and the JAX package's run-report and chain-profile."""
    out = str(tmp_path)
    paths = _write_run(out, "s1")
    assert set(paths) == {"resources", "trace"}
    run = treport.load_run(out)
    text = treport.render_report(run)
    assert text == jreport.render_report(jreport.load_run(out))
    for section in ("bottleneck attribution:", "resources:", "mesh efficiency:",
                    "device steps:", "host frame path:"):
        assert section in text, section
    assert "device:avpvs_siti_step" in text and "transfer:device_put" in text
    profile = tcp.load_profile(out)
    rendered = tcp.render(profile)
    assert rendered == jcp.render(jcp.load_profile(out))
    assert "lanes (busy seconds" in rendered and "bottleneck verdicts:" in rendered
    assert treport.main([out]) == 0 and tcp.main([out]) == 0
    assert treport.main([out, "--list"]) == 0
    assert tcp.main([str(tmp_path / "absent")]) == 1


def test_chain_profile_tolerates_torn_sidecars(tmp_path):
    stamp = "s1"
    (tmp_path / f"profile_{stamp}.trace.json").write_text(json.dumps({"traceEvents": []}))
    (tmp_path / f"resources_{stamp}.json").write_text("{torn")
    (tmp_path / f"metrics_{stamp}.json").write_text("{torn")
    profile = tcp.load_profile(str(tmp_path))
    assert "resources" not in profile and "metrics" not in profile
    assert tcp.render(profile) == jcp.render(jcp.load_profile(str(tmp_path)))
    (tmp_path / f"profile_{stamp}.trace.json").write_text("{torn")
    with pytest.raises(tcp.ProfileError):
        tcp.load_profile(str(tmp_path))


# -------------------------------------------------------- resource monitor


def test_sample_resources_basics_and_never_initialises_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("sampling touched CUDA")

    monkeypatch.setattr(torch.cuda, "memory_stats", refuse)
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    s = prof.sample_resources()
    assert not torch.cuda.is_initialized()
    assert s["rss_bytes"] is None or s["rss_bytes"] > 1_000_000
    assert s["open_fds"] is None or s["open_fds"] > 0
    assert s["pool_free_bytes"] >= 0 and s["pool_outstanding_bytes"] >= 0
    assert isinstance(s["queues"], dict)
    assert "device_memory" not in s and "device_memory_by_device" not in s
    assert set(s) == set(jprof.sample_resources(include_device=False))


def test_device_memory_keys_labels_and_sum(monkeypatch):
    """With CUDA initialised (monkeypatched: two cards), each card's
    allocator stats map to the JAX package's keys under "cuda:<i>", and
    chain_device_memory_bytes carries them and their device="all" sum."""
    stats = {0: {"allocated_bytes.all.current": 100, "allocated_bytes.all.peak": 300,
                 "reserved_bytes.all.current": 999},
             1: {"allocated_bytes.all.current": 7, "allocated_bytes.all.peak": 8}}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=1000 * (i + 1)))
    s = prof.sample_resources()
    assert s["device_memory_by_device"] == {
        "cuda:0": {"bytes_in_use": 100.0, "peak_bytes_in_use": 300.0, "bytes_limit": 1000.0},
        "cuda:1": {"bytes_in_use": 7.0, "peak_bytes_in_use": 8.0, "bytes_limit": 2000.0},
    }
    assert s["device_memory"] == {"bytes_in_use": 107.0, "peak_bytes_in_use": 308.0,
                                  "bytes_limit": 3000.0}
    gauge = _series(tm.REGISTRY.snapshot(), "chain_device_memory_bytes")
    assert gauge[(("device", "cuda:0"), ("kind", "peak_bytes_in_use"))] == 300.0
    assert gauge[(("device", "all"), ("kind", "bytes_in_use"))] == 107.0
    assert {dict(k)["device"] for k in gauge} == {"all", "cuda:0", "cuda:1"}
    peaks = prof.resource_peaks({"samples": [s]})
    assert peaks == jprof.resource_peaks({"samples": [s]})
    assert prof.format_resource_peaks(peaks) == jprof.format_resource_peaks(peaks)


def test_sample_resources_sees_pool_and_queues():
    block = DEFAULT_POOL.acquire((4, 8, 8), np.uint8)
    release = threading.Event()
    try:
        def slow():
            yield [np.zeros((2, 8, 8), np.uint8)]
            release.wait(5.0)

        with tpf.Prefetcher(slow(), depth=2):
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                s = prof.sample_resources()
                if "decode" in s["queues"]:
                    break
                time.sleep(0.01)
            release.set()
        assert "decode" in s["queues"]
        assert s["pool_outstanding_bytes"] >= block.nbytes
    finally:
        release.set()
        DEFAULT_POOL.release(block)
    assert "chain_bufpool_outstanding_bytes" in tm.REGISTRY.snapshot()


def test_queue_registry_prunes_and_stale_gauge_reads_zero():
    import gc

    p = tpf.Prefetcher(iter([1, 2]), depth=2)
    key = id(p._q)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not prof.sample_resources()["queues"].get("decode"):
        time.sleep(0.01)
    assert key in tpf._QUEUE_REGISTRY
    p.close()
    del p
    gc.collect()
    assert key not in tpf._QUEUE_REGISTRY
    prof.sample_resources()
    assert tm.REGISTRY.sum_series("chain_resource_queue_depth", {"queue": "decode"}) == 0.0


def test_prefetcher_records_depth_and_consumer_wait():
    with tpf.Prefetcher(iter(range(5)), depth=2) as p:
        assert list(p) == list(range(5))
    snap = tm.REGISTRY.snapshot()
    assert _series(snap, "chain_queue_depth")[(("queue", "decode"),)] == 6
    assert (("side", "consumer"),) in _series(snap, "chain_pipeline_wait_seconds_total")
    assert any(e["event"] == "queue_depth" for e in tm.EVENTS.records())


def test_bufpool_stats_byte_accounting():
    pool = BufferPool()
    a = pool.acquire((8, 16), np.uint8)
    stats = pool.stats()
    assert stats["outstanding_bytes"] == a.nbytes and stats["free_bytes"] == 0
    assert (stats["outstanding"], stats["free_blocks"]) == (1, 0)
    pool.release(a)
    stats = pool.stats()
    assert stats["free_bytes"] == a.nbytes and stats["outstanding_bytes"] == 0
    assert (stats["outstanding"], stats["free_blocks"]) == (0, 1)


def test_resource_monitor_start_stop_and_bounded_buffer():
    mon = prof.ResourceMonitor(interval_s=0.02, max_samples=7)
    mon.start()
    mon.start()
    time.sleep(0.3)
    mon.stop()
    mon.stop()
    n = len(mon.samples())
    assert 1 <= n <= 7
    ts = mon.to_timeseries()
    assert ts["n_samples"] == n
    json.dumps(ts)
    mon.start()
    mon.stop()


def test_cpu_tracker_and_resource_peaks_equal_jax():
    a = prof._CpuTracker()
    assert a.percent() is None and a.percent() is None and a._last is not None
    for series in ({"peak_rss_bytes": 5e9, "peak_queue_depths": {"decode": 7},
                    "samples": [{"rss_bytes": 1, "queues": {"decode": 1}}]},
                   {"samples": [
                       {"rss_bytes": 10, "pool_outstanding_bytes": 3, "queues": {"encode": 2}},
                       {"rss_bytes": 30, "pool_outstanding_bytes": 1, "queues": {"encode": 5}}]}):
        assert prof.resource_peaks(series) == jprof.resource_peaks(series)


# ---------------------------------------------------------------- Profiler


def test_profiler_writes_all_three_artifacts_on_cpu(tmp_path):
    p = prof.Profiler(str(tmp_path), interval_s=0.02, device_trace=True)
    p.start("stamp1")
    assert prof.active()
    with tracing.span("device:unit_step"), prof.device_annotation("unit_step"):
        torch.ones(64).sum()
    paths = p.stop("stamp1")
    assert not prof.active() and p.stop("stamp1") == {}
    assert os.path.isfile(paths["trace"]) and os.path.isfile(paths["resources"])
    assert paths["device_trace_dir"] == os.path.join(str(tmp_path), "device_stamp1")
    trace = prof.load_device_trace(paths["device_trace_dir"])
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "unit_step" in names  # the record_function range
    assert prof.annotation_range(trace, "unit_step") is not None
    assert prof.device_events(trace, "kernel") == []  # no card here
    with open(paths["trace"]) as f:
        doc = json.load(f)
    assert any(e.get("cat") == "device" for e in doc["traceEvents"] if e.get("ph") == "X")
    assert tcp.list_stamps(str(tmp_path)) == ["stamp1"]
    assert "device" in tcp.render(tcp.load_profile(str(tmp_path)))


def test_profiler_reports_a_device_trace_that_did_not_start(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    p = prof.Profiler(str(tmp_path), interval_s=0.02, device_trace=True).start("s")
    paths = p.stop("s")
    assert "device_trace_dir" not in paths
    assert "no profiler here" in paths["device_trace_error"]
    assert os.path.isfile(paths["trace"])  # the host profile still lands
    logs = [e for e in tm.EVENTS.records() if e["event"] == "log"]
    assert logs and logs[-1]["level"] == "ERROR" and "device trace" in logs[-1]["message"]


def test_profiler_auto_follows_cuda_initialisation(monkeypatch, tmp_path):
    assert prof.Profiler(str(tmp_path))._want_device_trace() is torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert prof.Profiler(str(tmp_path))._want_device_trace() is True
    assert prof.Profiler(str(tmp_path), device_trace=False)._want_device_trace() is False
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert prof.Profiler(str(tmp_path))._want_device_trace() is False
    assert prof.Profiler(str(tmp_path), device_trace=True)._want_device_trace() is True


def test_device_annotation_is_a_noop_without_a_capture():
    from contextlib import nullcontext

    assert isinstance(prof.device_annotation("x"), nullcontext)


def test_busy_share_unions_overlaps():
    evs = [{"ts": 0, "dur": 10}, {"ts": 5, "dur": 10}, {"ts": 30, "dur": 10},
           {"ts": 32, "dur": 2}, {"ts": 95, "dur": 20}]
    assert prof.busy_share(evs, 0, 100) == pytest.approx(0.30)
    assert prof.busy_share([], 0, 100) == 0.0 and prof.busy_share(evs, 5, 5) == 0.0


def test_trace_symbols_map_to_launch_counters():
    """Each csrc/*.cu kernel, demangled or mangled, maps to the wrappers
    that launch it; a kernel of torch's own maps to none."""
    cases = {
        "void (anonymous namespace)::resize_ring<unsigned char, true, 4>"
        "((anonymous namespace)::ResizeArgs)": ("resize_frames_fused",),
        "_ZN12_GLOBAL__N_113resize_streamItLb0ELi3EEEvNS_10ResizeArgsE": ("resize_frames_fused",),
        "void (anonymous namespace)::siti_partials<unsigned char, false>(unsigned char const*)":
            ("si_frames_fused",),
        "void (anonymous namespace)::siti_partials<unsigned short, true>(unsigned short const*)":
            ("siti_frames_fused", "siti_frames_fused_batch"),
        "_ZN12_GLOBAL__N_113siti_partialsIhLb1EEEvPKT_S3_iiiiiPdPxS6_S6_":
            ("siti_frames_fused", "siti_frames_fused_batch"),
        "void (anonymous namespace)::ti_partials<unsigned char>(unsigned char const*)":
            ("ti_frames_fused",),
        "_ZN12_GLOBAL__N_111ti_partialsItEEvPKT_S3_xiPxS4_": ("ti_frames_fused",),
        "void at::native::reduce_kernel<512, 1>(...)": (),
    }
    for symbol, names in cases.items():
        assert ck.launch_names(symbol) == names, symbol
    assert {n for names in cases.values() for n in names} == set(ck.LAUNCHES)


def test_tracer_report_and_drops_as_jax(tmp_path):
    """The span report's layout and drop accounting are the JAX package's."""
    docs = []
    for i, tracer in enumerate((tracing.Tracer(max_spans=5), jtracing.Tracer(max_spans=5))):
        for _ in range(9):
            with tracer.span("x"):
                pass
        with open(tracer.write_report(str(tmp_path / str(i)), "s")) as f:
            docs.append(json.load(f))
    ours, ref = docs
    assert ours["dropped_spans"] == ref["dropped_spans"] == 4
    assert ours["summary"]["x"]["count"] == ref["summary"]["x"]["count"] == 5
    strip = [{k: v for k, v in s.items() if k not in ("start_s", "duration_s")}
             for s in ours["spans"]]
    assert strip == [{k: v for k, v in s.items() if k not in ("start_s", "duration_s")}
                     for s in ref["spans"]]


def test_device_profiler_writes_a_trace(tmp_path):
    with tracing.DeviceProfiler(str(tmp_path / "dev")) as dp:
        torch.ones(8).sum()
    assert dp.error is None
    assert os.path.isfile(tmp_path / "dev" / tracing.DeviceProfiler.TRACE_FILE)
    assert tracing.DeviceProfiler(None).stop() is None
