"""Metadata model — the p02 stage (a copy of
processing_chain_tpu/models/metadata.py; reference
p02_generateMetadata.py:33-152).

Per PVS:
  * .qchanges — one row per segment from probe.get_segment_info, with
    video_bitrate recomputed from the exact bitstream frame sizes
    (reference :112-116);
  * .buff — stall/freeze events in media time, one python-repr per line
    (reference :59-71);
  * .vfi / .afi — per-packet frame tables with ffprobe sizes replaced by
    the exact parsed sizes, frame-count consistency enforced
    (reference :119-124 hard-exits on mismatch; here it raises);
  * VP9 superframe packets merged before size replacement (reference :100-104).

Where this copy departs from the JAX module: the job's plan records the
buffer events as `ops/overlay.buff_event_pairs` gives them, as the port's
`apply_stalling` does. A stall HRC's pairs pass through unchanged (the plan
hash is the JAX package's); a frame-freeze HRC's bare durations become
back-to-back pairs, where the JAX plan raises TypeError building
`[float(e[0]), float(e[1])]` from a float.

Design note — why p02 parses files instead of consuming device tensors
(BASELINE.json's north star routes "device-side feature tensors" to the
stages that handle PIXELS: p03's SI/TI sidecars, tools/quality_metrics,
src-analysis --siti): p02's artifacts are BITSTREAM metadata, and their
value contract is the reference's exact annexb/IVF frame sizes
(reference get_framesize.py). Those differ from what any in-memory
shortcut could supply — encoder-mux packet sizes diverge from annexb
sizes (start-code vs length-prefix framing, parameter-set placement on
keyframes), which is the very discrepancy the reference built its parsers
to avoid (vs ffprobe, :119-124). Re-parsing the written file is therefore
load-bearing for parity; the hot loop is native demux + vectorized numpy
NAL/IVF scanning (io/framesizes.py), not the reference's byte-at-a-time
Python state machine.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from ..config.domain import Pvs
from ..engine.jobs import Job
from ..io import framesizes, probe
from ..io.medialib import MediaError
from ..ops.overlay import buff_event_pairs
from ..store import keys as store_keys
from ..utils.fsio import atomic_write
from ..utils.log import get_logger


class MetadataError(RuntimeError):
    pass


def metadata_paths(pvs: Pvs) -> dict:
    """The four p02 artifact paths for one PVS (buff only for buffering
    HRCs)."""
    tc = pvs.test_config
    paths = {
        "qchanges": os.path.join(
            tc.get_quality_change_event_files_path(), pvs.pvs_id + ".qchanges"
        ),
        "vfi": os.path.join(
            tc.get_video_frame_information_path(), pvs.pvs_id + ".vfi"
        ),
        "afi": os.path.join(
            tc.get_audio_frame_information_path(), pvs.pvs_id + ".afi"
        ),
    }
    if pvs.has_buffering():
        paths["buff"] = os.path.join(
            tc.get_buff_event_files_path(), pvs.pvs_id + ".buff"
        )
    return paths


def metadata_job(pvs: Pvs, force: bool = False) -> Job:
    """p02 as a Job: qchanges is the main output, vfi/afi/buff ride as
    extra outputs, and the plan is the segment digests + stall schedule
    (everything the four tables derive from). With a store active the
    inner per-file force is unconditional — the job only runs when the
    plan says these tables are stale, and a rebuild must refresh ALL of
    them; without one, the legacy per-file `_maybe_write` semantics are
    preserved bit for bit."""
    paths = metadata_paths(pvs)
    extras = tuple(p for k, p in paths.items() if k != "qchanges")

    def run() -> str:
        from ..store import runtime as store_runtime

        generate_pvs_metadata(
            pvs, force=force or store_runtime.active() is not None
        )
        return paths["qchanges"]

    return Job(
        label=f"metadata {pvs.pvs_id}",
        output_path=paths["qchanges"],
        fn=run,
        plan={
            "op": "pvs_metadata",
            "segments": [
                store_keys.file_ref(s.file_path) for s in pvs.segments
            ],
            "events": (
                [[t, d] for t, d in buff_event_pairs(pvs.get_buff_events_media_time())]
                if pvs.has_buffering() else None
            ),
        },
        extra_outputs=extras,
        provenance={"pvs": pvs.pvs_id, "artifacts": sorted(paths)},
    )


def _maybe_write(path: str, force: bool, write_fn) -> None:
    log = get_logger()
    if not force and os.path.isfile(path):
        log.warning(
            "file %s already exists, not overwriting. Use -f/--force to "
            "force overwriting", path,
        )
        return
    log.info("writing %s", path)
    # atomic: a run killed mid-write must never leave a truncated table
    # (the sibling of engine/jobs' .inprogress discipline, for these
    # small multi-file outputs)
    atomic_write(path, write_fn)


def generate_pvs_metadata(pvs: Pvs, force: bool = False) -> dict:
    """Produce all four metadata artifacts for one PVS. Returns the frames
    tables for downstream use (device feature extraction in p03/bench)."""
    tc = pvs.test_config

    qchanges_rows = []
    vfi_parts = []
    afi_parts = []
    for segment in pvs.segments:
        if not segment.exists():
            raise MetadataError(f"segment {segment.filename} does not exist!")
        qchanges_rows.append(dict(segment.get_segment_info()))
        vfi_parts.append(
            probe.get_video_frame_info(segment.file_path, segment.filename)
        )
        try:
            afi_parts.append(
                probe.get_audio_frame_info(segment.file_path, segment.filename)
            )
        except MediaError as exc:
            # short tests have no audio stream; anything else propagates
            get_logger().debug("no audio frame info for %s: %s", segment.filename, exc)
    vfi = pd.concat(vfi_parts, ignore_index=True)
    afi = (
        pd.concat(afi_parts, ignore_index=True)
        if afi_parts
        else pd.DataFrame(columns=["segment", "index", "dts", "size", "duration"])
    )

    # exact frame sizes per segment; recompute qchanges video_bitrate.
    # VP9 superframe packets are merged first, restricted to each VP9
    # segment's own rows (reference :100-104 merges before size replacement)
    vp9_segments = {
        pvs.segments[i].filename
        for i in range(len(pvs.segments))
        if str(qchanges_rows[i]["video_codec"]).lower() == "vp9"
    }
    if vp9_segments:
        is_vp9 = vfi["segment"].isin(vp9_segments)
        merged = framesizes.merge_superframes(vfi[is_vp9])
        vfi = pd.concat([vfi[~is_vp9], merged], ignore_index=True)
        # restore the PVS's segment playout order (not lexicographic)
        order = {s.filename: i for i, s in enumerate(pvs.segments)}
        vfi = (
            vfi.assign(_seg_order=vfi["segment"].map(order))
            .sort_values(["_seg_order", "index"], kind="stable")
            .drop(columns="_seg_order")
            .reset_index(drop=True)
        )
    all_sizes: list[int] = []
    for i, segment in enumerate(pvs.segments):
        codec = str(qchanges_rows[i]["video_codec"]).lower()
        seg_sizes = framesizes.get_framesizes(
            segment.file_path, "h265" if codec == "hevc" else codec, force
        )
        all_sizes.extend(seg_sizes)
        qchanges_rows[i]["video_bitrate"] = round(
            sum(seg_sizes) / 1024 * 8 / qchanges_rows[i]["video_duration"], 2
        )

    if len(vfi) != len(all_sizes):
        raise MetadataError(
            f"Number of frames detected for {pvs.pvs_id} does not match: "
            f"vfi={len(vfi)} exact={len(all_sizes)}"
        )
    vfi = vfi.assign(size=np.asarray(all_sizes, dtype=np.int64))

    qchanges_file = os.path.join(
        tc.get_quality_change_event_files_path(), pvs.pvs_id + ".qchanges"
    )
    _maybe_write(
        qchanges_file, force,
        lambda p: pd.DataFrame(qchanges_rows).to_csv(p, index=False),
    )

    if pvs.has_buffering():
        buff_file = os.path.join(
            tc.get_buff_event_files_path(), pvs.pvs_id + ".buff"
        )
        events = pvs.get_buff_events_media_time()
        _maybe_write(
            buff_file, force,
            lambda p: open(p, "w").write("\n".join(str(b) for b in events) + "\n"),
        )

    vfi_file = os.path.join(
        tc.get_video_frame_information_path(), pvs.pvs_id + ".vfi"
    )
    afi_file = os.path.join(
        tc.get_audio_frame_information_path(), pvs.pvs_id + ".afi"
    )
    _maybe_write(vfi_file, force, lambda p: vfi.to_csv(p, index=False))
    _maybe_write(afi_file, force, lambda p: afi.to_csv(p, index=False))

    return {"qchanges": qchanges_rows, "vfi": vfi, "afi": afi}
