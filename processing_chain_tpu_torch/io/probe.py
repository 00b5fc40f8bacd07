"""Probing built on the port's media boundary, with reference-compatible
outputs (copy of processing_chain_tpu/io/probe.py).

Parity targets: reference lib/ffmpeg.py get_segment_info (:433-563),
get_src_info + .yaml sidecar cache (:566-633), get_video_frame_info /
get_audio_frame_info (:636-769), fix_durations VP9 patch (:718-741).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from fractions import Fraction
from typing import Optional

import numpy as np
import pandas as pd
import yaml

from . import medialib, sharedscan


def _select(info: dict, codec_type: str) -> Optional[dict]:
    return next(
        (s for s in info["streams"] if s["codec_type"] == codec_type), None
    )


def fix_video_profile_string(video_profile: str) -> str:
    """Normalize codec profile names for the .qchanges column exactly as
    the reference does (lib/ffmpeg.py:420-431): drop spaces/"Profile"/
    colons, High->Hi, Predictive->P (e.g. "Constrained Baseline" ->
    "ConstrainedBaseline", "High 4:4:4 Predictive" -> "Hi444P")."""
    for old, new in (
        (" ", ""),
        ("Profile", ""),
        ("High", "Hi"),
        (":", ""),
        ("Predictive", "P"),
    ):
        video_profile = video_profile.replace(old, new)
    return video_profile


class LibavProber:
    """The SrcProber implementation used outside tests (config/probe_api)."""

    def src_info(self, file_path: str, sidecar_path: Optional[str] = None) -> dict:
        """Video stream info with .yaml sidecar caching (reference
        ffmpeg.py:604-632; the sidecar is also written by util SRC analysis).
        """
        if sidecar_path and os.path.isfile(sidecar_path):
            with open(sidecar_path) as f:
                ydata = yaml.safe_load(f)
            if ydata and "get_src_info" in ydata:
                return ydata["get_src_info"]
        info = medialib.probe(file_path, coded_dims=True)
        v = _select(info, "video")
        if v is None:
            raise medialib.MediaError(f"no video stream in {file_path}")
        data = dict(v)
        data["video_duration"] = v["duration"]
        if sidecar_path:
            scan = sharedscan.get_scan(file_path)
            sizes = {
                "v": int(np.sum(scan["video"]["size"])),
                "a": int(np.sum(scan["audio"]["size"]))
                if scan["audio"] is not None else 0,
            }
            from ..utils.fsio import atomic_write_text

            atomic_write_text(sidecar_path, yaml.safe_dump(
                {"md5sum": "-", "get_stream_size": sizes,
                 "get_src_info": data},
                default_flow_style=False,
            ))
        return data

    def duration(self, file_path: str, sidecar_path: Optional[str] = None) -> float:
        info = self.src_info(file_path, sidecar_path)
        return float(info.get("video_duration") or info.get("duration") or 0.0)


def get_segment_info(
    file_path: str,
    filename: Optional[str] = None,
    target_video_bitrate=None,
) -> OrderedDict:
    """Segment info for .qchanges rows (reference :433-563, same keys)."""
    info = medialib.probe(file_path)
    v = _select(info, "video")
    a = _select(info, "audio")
    if v is None:
        raise medialib.MediaError(f"No video stream found in {file_path}")

    video_pk = None  # lazily demuxed at most once

    video_duration = float(v["duration"]) if v["duration"] else 0.0
    if not video_duration:
        # derive from packet timing (reference :487-498)
        video_pk = sharedscan.video(file_path)
        dts = video_pk["dts_time"]
        dur = video_pk["duration_time"]
        valid = ~np.isnan(dts)
        if valid.any():
            last = np.nonzero(valid)[0][-1]
            d = dur[last] if not np.isnan(dur[last]) else 0.0
            video_duration = float(dts[last] + d)
    if not video_duration:
        raise medialib.MediaError(f"Video duration of {file_path} is zero")

    if v["bit_rate"]:
        video_bitrate = round(float(v["bit_rate"]) / 1024.0, 2)
    else:
        if video_pk is None:
            video_pk = sharedscan.video(file_path)
        stream_size = int(np.sum(video_pk["size"]))
        video_bitrate = round((stream_size * 8 / 1024.0) / video_duration, 2)

    ret = OrderedDict(
        [
            ("segment_filename", filename or os.path.basename(file_path)),
            ("file_size", info["format"]["size"]),
            ("video_duration", video_duration),
            ("video_frame_rate", float(Fraction(v["r_frame_rate"]))),
            ("video_bitrate", video_bitrate),
            ("video_target_bitrate", target_video_bitrate if target_video_bitrate is not None else 0),
            ("video_width", v["width"]),
            ("video_height", v["height"]),
            ("video_codec", v["codec_name"]),
            ("video_profile", fix_video_profile_string(v.get("profile", ""))),
        ]
    )
    if a is not None:
        audio_duration = float(a["duration"]) if a["duration"] else 0.0
        if a["bit_rate"]:
            audio_bitrate = round(float(a["bit_rate"]) / 1024.0, 2)
        else:
            stream_size = int(np.sum(sharedscan.audio(file_path)["size"]))
            audio_bitrate = (
                round((stream_size * 8 / 1024.0) / audio_duration, 2)
                if audio_duration
                else 0.0
            )
        ret.update(
            OrderedDict(
                [
                    ("audio_duration", audio_duration),
                    ("audio_sample_rate", a["sample_rate"]),
                    ("audio_codec", a["codec_name"]),
                    ("audio_bitrate", audio_bitrate),
                ]
            )
        )
    return ret


def _fix_durations(dts: np.ndarray, duration: np.ndarray) -> np.ndarray:
    """Estimate missing packet durations from DTS deltas (the VP9 fix,
    reference :718-741), vectorized."""
    out = duration.copy()
    missing = np.isnan(out)
    if not missing.any():
        return out
    deltas = np.round(np.diff(dts), 6)
    fill = missing[:-1]
    out[:-1][fill] = deltas[fill]
    if np.isnan(out[-1]):
        prev = out[~np.isnan(out)]
        if prev.size:
            out[-1] = prev[-1]
    return out


def get_video_frame_info(file_path: str, segment_name: Optional[str] = None) -> pd.DataFrame:
    """Per-packet frame table in decoding order (reference :636-715):
    columns segment/index/frame_type/dts/size/duration. Routed through
    the shared post-encode scan: when p01 primed the file this costs no
    bitstream pass (io/sharedscan.py)."""
    pk = sharedscan.video(file_path)
    n = len(pk["size"])
    duration = _fix_durations(pk["dts_time"], pk["duration_time"])
    return pd.DataFrame(
        {
            "segment": [segment_name or os.path.basename(file_path)] * n,
            "index": np.arange(n),
            "frame_type": np.where(pk["key"] == 1, "I", "Non-I"),
            "dts": pk["dts_time"],
            "size": pk["size"],
            "duration": duration,
        }
    )


def get_audio_frame_info(file_path: str, segment_name: Optional[str] = None) -> pd.DataFrame:
    """Audio packet table (reference :744-769): segment/index/dts/size/
    duration. Shared-scan routed like get_video_frame_info."""
    pk = sharedscan.audio(file_path)
    n = len(pk["size"])
    return pd.DataFrame(
        {
            "segment": [segment_name or os.path.basename(file_path)] * n,
            "index": np.arange(n),
            "dts": pk["dts_time"],
            "size": pk["size"],
            "duration": _fix_durations(pk["dts_time"], pk["duration_time"]),
        }
    )
