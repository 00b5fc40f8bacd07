"""mesh-report: the mesh-scaling report of the wave render (port of
processing_chain_tpu/tools/mesh_report.py).

    python -m processing_chain_tpu_torch tools mesh-report sweep
        [--device cpu|cuda:N] [--slots 8] [--frames 8] [--out FILE]
        [--journal DIR]

A toy corpus driven through the real wave driver
(parallel/p03_batch.run_bucket) on a slot mesh (parallel/mesh.py) of
`--slots` slots of one device, `time_parallel=2` when the count is even,
with the wave journal (parallel/meshobs.py) attached:

  * throughput against lane count: one geometry at 1x, 2x and 4x the
    mesh's "pvs" width, valid frames per second a point, each point's
    journal checked for valid + pads == dispatched;
  * waste against spread: uniform lane lengths against a ragged mix in
    one bucket; the padded share must rise with the spread;
  * the step ledger: three distinct geometries, then the first again:
    new steps == distinct geometries, and the revisit adds none;
  * a resource sample after each throughput point
    (telemetry/profiling.sample_resources: process RSS, and the card's
    allocated bytes on a card): the double-buffered wave loop must not
    grow host memory with the lane count;
  * the journal against the recorder's `chain_mesh_*` metrics: the
    metrics' padded-slot fraction is present and equals the one the
    journals of the whole sweep give.

The device defaults to `cuda:0` and raises without CUDA; `--device cpu`
runs the sweep on the CPU. Telemetry is on for the sweep. Prints one JSON
report line and exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

from ..utils.fsio import atomic_write_text
from ..utils.log import get_logger


def _run_lanes(mesh, lengths, dh, dw, journal_dir, *, ten_bit=False,
               chunk=8, sh=36, sw=64):
    """One sweep point: `lengths[i]` frames of seeded YUV a lane through
    run_bucket with the journal attached to `journal_dir`. Returns
    (aggregate, elapsed_s, emitted frames)."""
    import numpy as np

    from ..parallel import meshobs, p03_batch

    rng = np.random.default_rng(0x18)
    dtype, hi = (np.uint16, 1023) if ten_bit else (np.uint8, 255)
    emitted = [0]
    lanes = []
    for i, n in enumerate(lengths):
        yuv = [rng.integers(0, hi + 1, size=s).astype(dtype)
               for s in ((n, sh, sw), (n, sh // 2, sw // 2), (n, sh // 2, sw // 2))]

        def emit(planes) -> None:
            emitted[0] += planes[0].shape[0]

        lanes.append(p03_batch.Lane(chunks=iter([yuv]), emit=emit,
                                    n_frames_hint=n, name=f"lane{i:02d}"))
    meshobs.attach_journal(journal_dir, replica="sweep")
    try:
        t0 = time.perf_counter()
        p03_batch.run_bucket(
            lanes, mesh, dh, dw, "bicubic", (2, 2), ten_bit, chunk=chunk,
            bucket=p03_batch.bucket_label(dh, dw, ten_bit, sh, sw),
        )
        elapsed = time.perf_counter() - t0
    finally:
        meshobs.detach_journal()
    return meshobs.aggregate(journal_dir), elapsed, emitted[0]


def _check_point(tag: str, agg: dict, want_valid: int, failures: list) -> None:
    tot = agg["totals"]
    if agg["invariant_violations"]:
        failures.append(f"{tag}: {agg['invariant_violations']} wave record(s) broke "
                        "valid+pad == dispatched")
    if tot["valid"] != want_valid:
        failures.append(f"{tag}: journal counts {tot['valid']} valid slots, the "
                        f"corpus has {want_valid} frames")
    padded = tot["pad_tail"] + tot["pad_exhausted"] + tot["pad_mesh"]
    if tot["valid"] + padded != tot["dispatched"]:
        failures.append(f"{tag}: totals {tot['valid']}+{padded} != {tot['dispatched']} "
                        "dispatched")


def _slot_totals(snapshot: dict) -> tuple:
    """(valid, padded) frame-slots of chain_mesh_wave_slots_total."""
    valid = padded = 0
    for series in snapshot.get("chain_mesh_wave_slots_total", {}).get("series", []):
        n = int(series.get("value", 0))
        if series["labels"].get("kind") == "valid":
            valid += n
        else:
            padded += n
    return valid, padded


def _cmd_sweep(args) -> int:
    import torch

    from .. import telemetry as tm
    from ..parallel import meshobs
    from ..parallel.mesh import make_mesh
    from ..telemetry import profiling
    from ..utils.device import resolve_device

    log = get_logger()
    device = resolve_device(args.device)
    tm.enable()
    journal_root = args.journal or tempfile.mkdtemp(prefix="mesh-report-")
    time_parallel = 2 if args.slots % 2 == 0 else 1
    mesh = make_mesh([device] * args.slots, time_parallel=time_parallel)
    n_pvs = mesh.shape["pvs"]
    t_step = max(1, 8 // mesh.shape["time"]) * mesh.shape["time"]
    report: dict = {
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "slots": args.slots,
        "mesh": dict(mesh.shape),
        "t_step": t_step,
        "journal_root": journal_root,
    }
    failures: list[str] = []
    before = _slot_totals(tm.REGISTRY.snapshot())

    # warm-up first, so that no sweep point carries the kernel build
    _run_lanes(mesh, [t_step] * n_pvs, 72, 128, os.path.join(journal_root, "warmup"),
               chunk=t_step)
    scaling = []
    for mult in (1, 2, 4):
        lengths = [args.frames] * (n_pvs * mult)
        agg, elapsed, emitted = _run_lanes(
            mesh, lengths, 72, 128, os.path.join(journal_root, f"scale_{len(lengths):03d}"),
            chunk=t_step)
        _check_point(f"scale x{mult}", agg, sum(lengths), failures)
        if emitted != sum(lengths):
            failures.append(f"scale x{mult}: {emitted} frames emitted, {sum(lengths)} fed")
        sample = profiling.sample_resources()
        scaling.append({
            "lanes": len(lengths),
            "frames": sum(lengths),
            "waves": agg["totals"]["waves"],
            "seconds": elapsed,
            "frames_per_s": sum(lengths) / elapsed,
            "waste_fraction": agg["totals"]["waste_fraction"],
            "rss_bytes": sample["rss_bytes"],
            "device_bytes_in_use": sample.get("device_memory", {}).get("bytes_in_use"),
        })
    report["scaling"] = scaling
    rss = [p["rss_bytes"] for p in scaling if p["rss_bytes"]]
    if len(rss) >= 2:
        # one wave is double-buffered whatever the lane count: host memory
        # must plateau, not scale with lanes
        report["rss_plateau_ratio"] = round(rss[-1] / rss[0], 3)
        if report["rss_plateau_ratio"] > 3.0:
            failures.append(f"RSS grew {report['rss_plateau_ratio']}x from "
                            f"{scaling[0]['lanes']} to {scaling[-1]['lanes']} lanes")

    frag = {}
    ragged = [t_step if i % 2 else max(1, t_step // 4) for i in range(n_pvs)]
    for tag, lengths in (("uniform", [t_step] * n_pvs), ("ragged", ragged)):
        agg, _, _ = _run_lanes(mesh, lengths, 72, 128,
                               os.path.join(journal_root, f"frag_{tag}"), chunk=t_step)
        _check_point(f"frag {tag}", agg, sum(lengths), failures)
        tot = agg["totals"]
        frag[tag] = {"lengths": lengths, "waste_fraction": tot["waste_fraction"],
                     "pad_tail": tot["pad_tail"], "pad_exhausted": tot["pad_exhausted"],
                     "pad_mesh": tot["pad_mesh"]}
    report["fragmentation"] = frag
    if frag["uniform"]["waste_fraction"] != 0.0:
        failures.append(f"t_step-aligned uniform lanes padded "
                        f"{frag['uniform']['waste_fraction']:.2%}")
    if frag["ragged"]["waste_fraction"] <= frag["uniform"]["waste_fraction"]:
        failures.append("ragged lanes show no more waste than uniform ones")

    # the step ledger: three geometries new to this process, then the first
    # again (the first-dispatch detector is process-wide)
    ledger_dir = os.path.join(journal_root, "compiles")
    geometries = [dict(dh=80, dw=144, ten_bit=False), dict(dh=90, dw=160, ten_bit=False),
                  dict(dh=80, dw=144, ten_bit=True)]
    for geo in geometries + [geometries[0]]:
        agg, _, _ = _run_lanes(mesh, [t_step] * n_pvs, geo["dh"], geo["dw"], ledger_dir,
                               ten_bit=geo["ten_bit"], chunk=t_step)
    recompiles = agg["totals"]["recompiles"]
    report["compile_ledger"] = {
        "distinct_geometries": len(geometries),
        "dispatch_rounds": len(geometries) + 1,
        "recompiles": recompiles,
        "buckets": {b: e["recompiles"] for b, e in agg["buckets"].items()},
    }
    if recompiles != len(geometries):
        failures.append(f"{recompiles} new step(s) over {len(geometries)} distinct "
                        "geometries + 1 revisit")
    stats = meshobs.journal_stats(ledger_dir)
    report["ledger_journal"] = stats
    if not stats["waves"]:
        failures.append("the step-ledger journal holds no wave records")

    # the metrics side of the recorder against every journal of the sweep
    # (the metrics are process-wide: the sweep's share is their change)
    after = _slot_totals(tm.REGISTRY.snapshot())
    valid, padded = after[0] - before[0], after[1] - before[1]
    journals = [meshobs.aggregate(os.path.join(journal_root, d))["totals"]
                for d in sorted(os.listdir(journal_root))
                if os.path.isdir(os.path.join(journal_root, d))]
    j_valid = sum(t["valid"] for t in journals)
    j_dispatched = sum(t["dispatched"] for t in journals)
    report["metrics_waste_fraction"] = profiling.mesh_waste_from_metrics(
        tm.REGISTRY.snapshot())
    report["metrics_vs_journal_slots"] = {
        "metrics": [valid, valid + padded], "journals": [j_valid, j_dispatched]}
    if report["metrics_waste_fraction"] is None:
        failures.append("chain_mesh_wave_slots_total carries no series "
                        "— the metrics side of the recorder is dark")
    elif (valid, valid + padded) != (j_valid, j_dispatched):
        failures.append(f"metrics count {valid} valid of {valid + padded} slots, "
                        f"the journals {j_valid} of {j_dispatched}")

    report["failures"] = failures
    report["ok"] = not failures
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        atomic_write_text(args.out, line + "\n")
    for f in failures:
        log.error("mesh-report sweep: %s", f)
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(
        prog="tools mesh-report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sweep = sub.add_parser("sweep", help="mesh-occupancy scaling sweep on a slot mesh")
    p_sweep.add_argument("--device", default=None,
                         help="device of the slots (default cuda:0; 'cpu' for the CPU)")
    p_sweep.add_argument("--slots", type=int, default=8, help="slots of the mesh")
    p_sweep.add_argument("--frames", type=int, default=8,
                         help="frames per lane in the throughput sweep")
    p_sweep.add_argument("--out", default=None, help="write the JSON report here too")
    p_sweep.add_argument("--journal", default=None,
                         help="journal root (default: a fresh temp dir)")
    args = parser.parse_args(argv)
    return _cmd_sweep(args)


if __name__ == "__main__":
    raise SystemExit(main())
