"""Aggregate one run's telemetry artifacts into a human-readable report
(copy of processing_chain_tpu/telemetry/report.py).

Joins the three `telemetry.write_outputs` artifacts (metrics_<ts>.json,
events_<ts>.jsonl, metrics_<ts>.prom) with the span report
(trace_<ts>.json) and the profile's resources_<ts>.json under the same
stamp and renders:

  * run header (stage selection, status, wall time),
  * per-stage throughput table (frames decoded/encoded, frames/sec, MB/s),
  * job accounting per runner (planned / skipped / deduped / failed / redone),
  * top wall-time spans,
  * pipeline stall diagnosis from queue-depth samples + blocked-time
    counters (starved consumer vs. backed-up producer),
  * bottleneck attribution, host frame path, resources, device steps and
    mesh efficiency.

Entry point: `python -m processing_chain_tpu_torch tools run-report DIR`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .events import read_jsonl

_STAMP_RE = re.compile(r"metrics_(?P<stamp>.+)\.json$")
_EVENTS_STAMP_RE = re.compile(r"events_(?P<stamp>.+)\.jsonl$")


@dataclass
class RunData:
    directory: str
    stamp: str
    metrics: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    trace: dict = field(default_factory=dict)
    #: resources_<ts>.json timeseries when the run carried --profile
    resources: dict = field(default_factory=dict)
    #: events JSONL present but no metrics snapshot: the run crashed (or
    #: is still in flight) before telemetry.write_outputs persisted it
    partial: bool = False


class ReportError(ValueError):
    """Raised when a run directory has no loadable telemetry artifacts."""


def list_stamps(directory: str) -> list[str]:
    """Run stamps in the directory, oldest first. Ordered by artifact
    mtime, not stamp text: stamps embed an unpadded pid/sequence, so a
    lexicographic sort could call an older run 'latest'. Stamps with
    only a (streamed) events file — a run still in flight, or one that
    crashed before its metrics snapshot — are included: run-report must
    be able to answer for exactly those runs."""
    entries = []
    seen = set()
    for pattern, regex in (
        ("metrics_*.json", _STAMP_RE),
        ("events_*.jsonl", _EVENTS_STAMP_RE),
    ):
        for path in glob.glob(os.path.join(directory, pattern)):
            m = regex.search(os.path.basename(path))
            if m and m.group("stamp") not in seen:
                try:
                    mtime = os.path.getmtime(path)
                except OSError:
                    continue
                seen.add(m.group("stamp"))
                entries.append((mtime, m.group("stamp")))
    return [stamp for _, stamp in sorted(entries)]


def load_run(directory: str, stamp: Optional[str] = None) -> RunData:
    """Load the artifacts of one run (latest stamp unless given). A
    stamp whose metrics snapshot is absent but whose events JSONL exists
    loads as a PARTIAL run (crashed or still in flight) instead of
    raising — the events are exactly the forensics an operator needs."""
    if not os.path.isdir(directory):
        raise ReportError(f"not a directory: {directory}")
    stamps = list_stamps(directory)
    if stamp is None:
        if not stamps:
            raise ReportError(
                f"no metrics_<ts>.json (or events_<ts>.jsonl) in "
                f"{directory} — was the run started with --telemetry?"
            )
        stamp = stamps[-1]
    elif stamp not in stamps:
        raise ReportError(f"no metrics_{stamp}.json in {directory}")
    run = RunData(directory=directory, stamp=stamp)
    metrics_path = os.path.join(directory, f"metrics_{stamp}.json")
    events_path = os.path.join(directory, f"events_{stamp}.jsonl")
    if os.path.isfile(metrics_path):
        with open(metrics_path) as f:
            run.metrics = json.load(f)
    elif os.path.isfile(events_path):
        run.partial = True
    else:
        raise ReportError(f"no artifacts for stamp {stamp} in {directory}")
    if os.path.isfile(events_path):
        run.events = read_jsonl(events_path)
    trace_path = os.path.join(directory, f"trace_{stamp}.json")
    if os.path.isfile(trace_path):
        with open(trace_path) as f:
            run.trace = json.load(f)
    resources_path = os.path.join(directory, f"resources_{stamp}.json")
    if os.path.isfile(resources_path):
        try:
            with open(resources_path) as f:
                run.resources = json.load(f)
        except (OSError, ValueError):
            pass  # a torn/unreadable profile sidecar must not sink the report
    return run


# ------------------------------------------------------------- accessors


def _series(run: RunData, name: str) -> list[dict]:
    return run.metrics.get(name, {}).get("series", [])


def _value(run: RunData, name: str, **labels) -> float:
    for s in _series(run, name):
        if s.get("labels", {}) == labels or not labels:
            return float(s.get("value", s.get("sum", 0.0)))
    return 0.0


def _by_label(run: RunData, name: str, label: str) -> dict[str, dict]:
    out: dict[str, dict] = {}
    for s in _series(run, name):
        out[s["labels"].get(label, "")] = s
    return out


def _events(run: RunData, kind: str) -> list[dict]:
    return [e for e in run.events if e.get("event") == kind]


# -------------------------------------------------------------- sections


def _fmt_table(header: Sequence[str], rows: list[Sequence[str]]) -> list[str]:
    widths = [len(h) for h in header]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(str(cell)))
    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()
    out = [line(header), line("-" * w for w in widths)]
    out.extend(line(r) for r in rows)
    return out


def _header_section(run: RunData) -> list[str]:
    lines = [f"run {run.stamp}  ({run.directory})"]
    starts = _events(run, "run_start")
    ends = _events(run, "run_end")
    if starts:
        s = starts[0]
        lines.append(
            f"  command: {s.get('name', '?')}  argv: {' '.join(s.get('argv', []))}"
        )
    if ends:
        e = ends[-1]
        lines.append(
            f"  status: {e.get('status', '?')}  wall: {e.get('duration_s', '?')}s"
        )
    elif run.partial:
        last_t = run.events[-1].get("t", "?") if run.events else "?"
        lines.append(
            "  status: RUN DID NOT COMPLETE (events streamed, no metrics "
            f"snapshot) — crashed or still in flight; last event at "
            f"t={last_t}s"
        )
    return lines


def _partial_section(run: RunData) -> list[str]:
    """Forensics for a run without an end: which jobs started but never
    ended, and any watchdog incidents the stream captured."""
    started = {e.get("job"): e for e in _events(run, "job_start")}
    ended = {e.get("job") for e in _events(run, "job_end")}
    open_jobs = [j for j in started if j not in ended]
    lines = []
    if open_jobs:
        last_t = run.events[-1].get("t", 0.0) if run.events else 0.0
        lines.append(f"jobs started but never finished ({len(open_jobs)}):")
        for job in open_jobs[:10]:
            t_start = started[job].get("t", 0.0)
            lines.append(
                f"  {job}  (started t={t_start}s, "
                f"{float(last_t) - float(t_start):.1f}s before the stream ended)"
            )
    incidents = (
        _events(run, "task_stalled") + _events(run, "task_hard_timeout")
        + _events(run, "barrier_wait")
    )
    if incidents:
        lines.append(f"watchdog/barrier incidents ({len(incidents)}):")
        for e in incidents[:10]:
            desc = e.get("task") or f"missing {e.get('missing')}"
            lines.append(
                f"  t={e.get('t')}s {e['event']}: {desc} "
                f"(no progress for {e.get('beat_age_s', e.get('waited_s', '?'))}s)"
            )
        lines.append(
            "  (full stack dumps are in the task_stalled/task_hard_timeout "
            "event records)"
        )
    if not lines:
        lines.append("no in-flight jobs captured before the stream ended")
    return lines


def _stage_section(run: RunData) -> list[str]:
    stage_ends = _events(run, "stage_end")
    if not stage_ends:
        starts = _events(run, "stage_start")
        if starts and run.partial:
            return [
                f"stage {s.get('stage', '?')} started at t={s.get('t')}s "
                "and never ended" for s in starts
            ]
        return ["no stage_end events (single-layer run?)"]
    rows = []
    for e in stage_ends:
        wall = float(e.get("duration_s", 0.0)) or 1e-9
        frames = float(e.get("frames_encoded", 0.0))
        dec = float(e.get("frames_decoded", 0.0))
        mb = float(e.get("bytes_encoded", 0.0)) / 1e6
        rows.append((
            e.get("stage", "?"),
            e.get("status", "?"),
            f"{wall:.2f}",
            f"{int(dec)}",
            f"{int(frames)}",
            f"{frames / wall:.1f}",
            f"{mb / wall:.1f}",
        ))
    return _fmt_table(
        ("stage", "status", "wall_s", "frames_dec", "frames_enc",
         "frames/s", "MB/s"),
        rows,
    )


def _jobs_section(run: RunData) -> list[str]:
    names = {
        "planned": "chain_jobs_planned_total",
        "skipped": "chain_jobs_skipped_total",
        "deduped": "chain_jobs_deduped_total",
        "failed": "chain_jobs_failed_total",
    }
    per_runner: dict[str, dict[str, int]] = {}
    for col, metric in names.items():
        for runner, s in _by_label(run, metric, "runner").items():
            per_runner.setdefault(runner, {})[col] = int(s.get("value", 0))
    # chain-wide (the redo decision predates runner attribution)
    redone = int(_value(run, "chain_jobs_redone_total"))
    if not per_runner and not redone:
        return ["no job counters recorded"]
    rows = [
        (runner, *(per_runner[runner].get(c, 0) for c in names))
        for runner in sorted(per_runner)
    ]
    lines = _fmt_table(("runner", *names), rows) if rows else []
    if redone:
        lines.append(f"redone over crash sentinels (chain-wide): {redone}")
    return lines


def _spans_section(run: RunData, top: int = 10) -> list[str]:
    summary = run.trace.get("summary", {})
    if not summary:
        return ["no span report (trace_<ts>.json missing)"]
    items = sorted(summary.items(), key=lambda kv: -kv[1]["total_s"])[:top]
    rows = [
        (name[:56], e["count"], f"{e['total_s']:.3f}", f"{e['max_s']:.3f}")
        for name, e in items
    ]
    return _fmt_table(("span", "count", "total_s", "max_s"), rows)


def _serve_section(run: RunData, top: int = 15) -> list[str]:
    """Serve requests with their trace context: `serve_request` joined
    to `serve_request_done` by request id, trace id included so `tools
    trace show <trace-id>` picks up exactly where the report leaves
    off (docs/TELEMETRY.md "Fleet observability & tracing")."""
    accepted = _events(run, "serve_request")
    done = {e.get("request"): e
            for e in _events(run, "serve_request_done")}
    if not accepted and not done:
        return []
    rows = []
    for e in accepted[-top:]:
        req = e.get("request", "?")
        end = done.get(req, {})
        outcome = end.get("status", "in-flight")
        if end.get("warm"):
            outcome += " (warm)"
        dur = end.get("duration_s")
        rows.append((
            req, e.get("trace_id", "-") or "-",
            f"{e.get('tenant', '?')}/{e.get('priority', '?')}",
            e.get("units", "?"), outcome,
            f"{dur:.3f}" if dur is not None else "-",
        ))
    lines = _fmt_table(
        ("request", "trace", "tenant/priority", "units", "outcome", "s"),
        rows,
    )
    unmatched = sorted(set(done) - {e.get("request") for e in accepted})
    if unmatched:
        lines.append(f"settled without an accept event in this log "
                     f"(peer-replica executions): {len(unmatched)}")
    return lines


def _queue_stats(run: RunData) -> dict[str, dict]:
    """{queue: {samples, mean_depth}} from the depth histogram."""
    out = {}
    for queue, s in _by_label(run, "chain_queue_depth", "queue").items():
        n = int(s.get("count", 0))
        out[queue] = {
            "samples": n,
            "mean_depth": (float(s.get("sum", 0.0)) / n) if n else 0.0,
        }
    return out


def _stall_section(run: RunData) -> list[str]:
    queues = _queue_stats(run)
    waits = {
        side: float(s.get("value", 0.0))
        for side, s in _by_label(
            run, "chain_pipeline_wait_seconds_total", "side"
        ).items()
    }
    if not queues and not waits:
        return ["no pipeline samples (no prefetch activity in this run)"]
    lines = []
    for queue, st in sorted(queues.items()):
        lines.append(
            f"  queue {queue}: {st['samples']} samples, "
            f"mean depth {st['mean_depth']:.2f}"
        )
    for side, total in sorted(waits.items()):
        lines.append(f"  blocked on {side}: {total:.2f}s total")
    # diagnosis: a consumer repeatedly finding its decode queue empty is
    # starved (decode-bound run); a producer blocked pushing into a full
    # encode queue means writeback can't keep up (encode-bound run).
    consumer_wait = waits.get("consumer", 0.0)
    producer_wait = waits.get("producer", 0.0)
    decode_depth = queues.get("decode", {}).get("mean_depth")
    encode_depth = queues.get("encode", {}).get("mean_depth")
    if decode_depth is not None and decode_depth < 0.5 and consumer_wait > max(
        1.0, 2 * producer_wait
    ):
        lines.append(
            "  diagnosis: consumer starved (decode queue mostly empty, "
            "device/compute waiting on decode) — raise decode workers or "
            "prefetch depth"
        )
    elif encode_depth is not None and encode_depth >= 2.0 and producer_wait > max(
        1.0, 2 * consumer_wait
    ):
        lines.append(
            "  diagnosis: producer blocked (encode queue full, writeback "
            "can't keep up) — raise FFV1 workers or writer depth"
        )
    else:
        lines.append("  diagnosis: no stall signature (pipeline balanced)")
    return lines


def _host_path_section(run: RunData) -> list[str]:
    """The host frame path: buffer-pool recycling, chunk-granular
    native I/O crossings, and host<->device transfer volume — the
    metrics that explain whether the batched path was actually engaged."""
    hits = _value(run, "chain_bufpool_hits_total")
    misses = _value(run, "chain_bufpool_misses_total")
    recycled = _value(run, "chain_bufpool_recycled_bytes_total")
    io_calls = _by_label(run, "chain_io_batch_calls_total", "op")
    xfer_s = _by_label(run, "chain_device_transfer_seconds_total", "direction")
    xfer_b = _by_label(run, "chain_device_transfer_bytes_total", "direction")
    if not (hits or misses or io_calls or xfer_s):
        return []
    lines = []
    if hits or misses:
        rate = hits / max(1.0, hits + misses)
        lines.append(
            f"  buffer pool: {int(hits)} hits / {int(misses)} misses "
            f"(hit rate {rate:.2f}), {recycled / 1e6:.1f} MB recycled"
        )
        if rate < 0.25 and hits + misses >= 8:
            lines.append(
                "    note: low hit rate — chunk geometries churn faster "
                "than the free lists recycle (mixed resolutions?)"
            )
    decoded = _value(run, "chain_frames_decoded_total")
    encoded = _value(run, "chain_frames_encoded_total")
    for op, s in sorted(io_calls.items()):
        calls = float(s.get("value", 0.0))
        if not calls:
            continue
        frames = decoded if op == "decode" else encoded
        lines.append(
            f"  native {op} crossings: {int(calls)} "
            f"(~{frames / calls:.1f} frames per GIL release)"
        )
    if not io_calls and (decoded or encoded):
        lines.append(
            "  no batched native I/O crossings — per-frame fallback "
            "(PC_HOST_BATCH=0 or a non-batch reader/writer)"
        )
    for direction, s in sorted(xfer_s.items()):
        seconds = float(s.get("value", 0.0))
        mb = float(xfer_b.get(direction, {}).get("value", 0.0)) / 1e6
        if seconds or mb:
            lines.append(
                f"  device {direction}: {mb:.1f} MB in {seconds:.2f}s"
                + (f" ({mb / seconds:.0f} MB/s)" if seconds > 1e-9 else "")
            )
    return lines


def _attribution_section(run: RunData) -> list[str]:
    """Per-stage bottleneck verdicts from the attribution engine
    (telemetry/profiling.py): stage_end component deltas when present,
    else one whole-run verdict from the global metrics."""
    from .profiling import attribute_run

    verdicts = attribute_run(run.metrics, run.events)
    if not verdicts:
        return []
    lines = []
    for stage, v in verdicts.items():
        contributors = ", ".join(
            f"{c['component']} {c['pct']}% ({c['seconds']:.2f}s)"
            for c in v["contributors"]
        )
        if v.get("insufficient_data"):
            lines.append(
                f"  {stage}: balanced (insufficient data — measured "
                f"components total {v['total_s']:.3f}s"
                + (f"; {contributors}" if contributors else "") + ")"
            )
        else:
            line = f"  {stage}: {v['verdict']} — {contributors}"
            if v["verdict"] == "fragmentation_bound":
                line += (f" (mesh waste "
                         f"{v.get('mesh_waste_fraction', 0.0):.1%} — "
                         "see the mesh efficiency section / "
                         "`tools mesh-top`)")
            lines.append(line)
        if v.get("missing"):
            lines.append(
                f"    unmeasured: {', '.join(v['missing'])} (no series "
                "recorded — component idle or instrumentation not on this "
                "path)"
            )
    return lines


def _resources_section(run: RunData) -> list[str]:
    """Peaks from the --profile resource timeseries when present, else
    the last-known resource gauges from the metrics snapshot."""
    lines = []
    res = run.resources
    if res:
        from .profiling import format_resource_peaks, resource_peaks

        lines.append(
            f"  {res.get('n_samples', 0)} samples @ "
            f"{res.get('interval_s', '?')}s"
        )
        lines.extend(f"  {l}" for l in format_resource_peaks(resource_peaks(res)))
        return lines
    rss = _value(run, "chain_resource_rss_bytes")
    if rss:
        lines.append(f"  last rss: {rss / 1e6:.0f} MB")
        pool_out = _value(run, "chain_bufpool_outstanding_bytes")
        pool_free = _value(run, "chain_bufpool_free_bytes")
        if pool_out or pool_free:
            lines.append(
                f"  pool bytes: {pool_out / 1e6:.0f} MB outstanding, "
                f"{pool_free / 1e6:.0f} MB free"
            )
    return lines


def _device_section(run: RunData) -> list[str]:
    compiles = _events(run, "device_step")
    steps = _by_label(run, "chain_device_step_seconds", "step")
    if not compiles and not steps:
        return []
    lines = ["device steps:"]
    for step, s in sorted(steps.items()):
        n = int(s.get("count", 0))
        if n:
            lines.append(
                f"  {step}: {n} dispatches, {float(s['sum']):.3f}s total"
            )
    for e in compiles:
        if e.get("first"):
            lines.append(
                f"  {e.get('step', '?')}: first dispatch (incl. compile) "
                f"{e.get('duration_s', '?')}s"
            )
    return lines


def _mesh_section(run: RunData) -> list[str]:
    """Mesh efficiency (parallel/meshobs.py): per-bucket wave occupancy,
    padding waste and the compile ledger. The run's wave journal
    (`meshobs_<stamp>/`, written alongside the event stream) is the
    preferred source — it survives crashes and carries the lane→wave
    schedule; the chain_mesh_* series are the fallback for runs whose
    journal was moved or pruned."""
    journal_dir = os.path.join(run.directory, f"meshobs_{run.stamp}")
    if os.path.isdir(journal_dir):
        # lazy: only pay the import when a wave journal actually exists
        from ..parallel import meshobs

        agg = meshobs.aggregate(journal_dir)
        if agg["buckets"]:
            lines = []
            for bucket, a in sorted(agg["buckets"].items()):
                lines.append(
                    f"  {bucket}: {a['waves']} wave(s), {a['valid']} valid"
                    f" + {a['pad_tail']} tail / {a['pad_exhausted']} "
                    f"exhausted / {a['pad_mesh']} mesh pad slots — waste "
                    f"{a['waste_fraction']:.1%}, {a['recompiles']} "
                    f"compile(s) ({a['compile_s']:.2f}s)"
                )
            tot = agg["totals"]
            if len(agg["buckets"]) > 1:
                lines.append(
                    f"  total: waste {tot['waste_fraction']:.1%} over "
                    f"{tot['dispatched']} dispatched slots, "
                    f"{tot['recompiles']} compile(s)"
                )
            if agg["invariant_violations"]:
                lines.append(
                    f"  !! {agg['invariant_violations']} wave record(s) "
                    "broke valid+pad == dispatched (wave-loop accounting bug)"
                )
            lines.append(f"  journal: {journal_dir}")
            return lines
    slots = _by_label(run, "chain_mesh_wave_slots_total", "bucket")
    if not slots:
        return []
    waves = _by_label(run, "chain_mesh_waves_total", "bucket")
    recompiles = _by_label(run, "chain_mesh_recompiles_total", "bucket")
    lines = []
    for bucket in sorted(waves):
        valid = _value(run, "chain_mesh_wave_slots_total",
                       bucket=bucket, kind="valid")
        padded = sum(
            _value(run, "chain_mesh_wave_slots_total",
                   bucket=bucket, kind=kind)
            for kind in ("pad_tail", "pad_exhausted", "pad_mesh")
        )
        total = valid + padded
        waste = padded / total if total else 0.0
        n_compiles = int(float(
            recompiles.get(bucket, {}).get("value", 0)))
        lines.append(
            f"  {bucket}: "
            f"{int(float(waves[bucket].get('value', 0)))} wave(s), "
            f"{int(valid)} valid + {int(padded)} pad slots — waste "
            f"{waste:.1%}, {n_compiles} compile(s)"
        )
    return lines


def render_report(run: RunData) -> str:
    parts = [
        "\n".join(_header_section(run)),
    ]
    if run.partial:
        parts.append(
            "partial run:\n" + "\n".join(f"  {l}" for l in _partial_section(run))
        )
    parts += [
        "stage throughput:\n" + "\n".join(f"  {l}" for l in _stage_section(run)),
        "jobs:\n" + "\n".join(f"  {l}" for l in _jobs_section(run)),
        "top spans:\n" + "\n".join(f"  {l}" for l in _spans_section(run)),
        "pipeline:\n" + "\n".join(_stall_section(run)),
    ]
    serve = _serve_section(run)
    if serve:
        parts.append("serve requests:\n" + "\n".join(
            f"  {l}" for l in serve))
    attribution = _attribution_section(run)
    if attribution:
        parts.append("bottleneck attribution:\n" + "\n".join(attribution))
    host_path = _host_path_section(run)
    if host_path:
        parts.append("host frame path:\n" + "\n".join(host_path))
    resources = _resources_section(run)
    if resources:
        parts.append("resources:\n" + "\n".join(resources))
    device = _device_section(run)
    if device:
        parts.append("\n".join(device))
    mesh = _mesh_section(run)
    if mesh:
        parts.append("mesh efficiency:\n" + "\n".join(mesh))
    warnings = [
        e for e in _events(run, "log")
        if e.get("level") in ("WARNING", "ERROR", "CRITICAL")
    ]
    if warnings:
        parts.append(
            f"log anomalies ({len(warnings)}):\n" + "\n".join(
                f"  [{e['level']}] {e.get('message', '')[:100]}"
                for e in warnings[:15]
            )
        )
    return "\n\n".join(parts) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tools run-report",
        description="Render a human-readable report from a telemetry DIR"
    )
    parser.add_argument("directory", help="directory holding metrics_<ts>.json etc.")
    parser.add_argument(
        "--stamp", default=None,
        help="specific run stamp (default: latest in the directory)",
    )
    parser.add_argument(
        "--list", action="store_true", help="list run stamps and exit"
    )
    args = parser.parse_args(argv)
    if args.list:
        for stamp in list_stamps(args.directory):
            print(stamp)
        return 0
    try:
        run = load_run(args.directory, args.stamp)
    except ReportError as exc:
        print(f"run-report: {exc}")
        return 1
    print(render_report(run), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
