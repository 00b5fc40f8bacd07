"""CPVS model — the per-chunk device half of p04 (port of
processing_chain_tpu/models/cpvs.py: `normalize_rms`, `_limit_frames`,
`cpvs_plan` :106-170, `t_cap_frames`, `cpvs_out_rate`,
`make_cpvs_transform` :189-246 and `make_preview_transform` :381-399).

PC context: AVPVS → 420→422 chroma (packed UYVY422 for 8-bit, planar
yuv422p10le for v210) → centered pad to the display canvas when the
AVPVS is shorter; rawvideo passes the AVPVS layout through. Mobile /
tablet: 10-bit → 8-bit, then bicubic scale to the display dims, or pad
only. Preview: 422 10-bit. The transforms take and return tensors on
one device and never fetch to the host: the writer does.

Not ported yet: the writers, `create_cpvs`, `create_preview` and the
long-test audio helpers.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from ..config.domain import PostProcessing, Pvs
from ..ops import pad as pad_ops
from ..ops import pixfmt as pf
from . import frames as fr


def normalize_rms(samples: np.ndarray, target_dbfs: float = -23.0) -> np.ndarray:
    """RMS loudness normalization — ffmpeg-normalize 1.28.3 `-nt rms`
    semantics, reproduced step for step (reference lib/ffmpeg.py:1233-1245):

    1. measure: ffmpeg volumedetect accumulates an exact power sum over
       every sample of every channel (s16 values / 32768) and PRINTS
       mean_volume at 0.1 dB; ffmpeg-normalize parses that printed value,
       so the measured level is quantized to 0.1 dB before use.
    2. gain: adjustment_db = target - mean_volume; no limiter — the tool
       only warns when the gain would clip.
    3. apply: the volume filter's s16 path is
       av_clip_int16(lrintf(x * gain)) — round to nearest (ties to even),
       clamp to [-32768, 32767].
    """
    if samples.size == 0:
        return samples
    x = samples.astype(np.float64)
    power = np.mean((x / 32768.0) ** 2)
    if power <= 0:
        return samples
    mean_volume_db = round(10.0 * np.log10(power), 1)  # volumedetect print
    gain = 10.0 ** ((target_dbfs - mean_volume_db) / 20.0)
    return np.clip(np.rint(x * gain), -32768, 32767).astype(np.int16)


def _limit_frames(chunks, n_max: int):
    """Cap a plane-chunk stream at n_max frames (the reference's `-t`
    output-duration trim, applied to the video stream)."""
    left = n_max
    if left <= 0:
        return
    for chunk in chunks:
        t = chunk[0].shape[0]
        yield [p[:left] for p in chunk] if t > left else chunk
        left -= min(t, left)
        if left <= 0:
            return


def cpvs_plan(
    pvs: Pvs,
    post_processing: PostProcessing,
    avpvs_height: int,
    rawvideo: bool = False,
    nonraw_crf: int = 17,
    mobile_vprofile: str = "high",
    mobile_preset: str = "fast",
) -> dict:
    """Pure decision record for one CPVS render — codec/pix_fmt, display
    fps, pad-vs-scale geometry, audio handling, loudness step — matching
    the reference's command construction (lib/ffmpeg.py:1149-1249: the
    pc rawvideo/v210 branch with its smaller-height padding rule, the
    mobile x264 CRF branch whose padding case applies NO scale, short
    tests' -an, long tests' -t total duration + ffmpeg-normalize step).
    `create_cpvs.run` executes exactly this plan; the reference-oracle
    suite compares it against the reference's own command strings."""
    tc = pvs.test_config
    pp = post_processing
    # the reference's pc branch matches only ["pc", "tv"] (create_cpvs
    # :1177) and "tv" is not a legal post-processing type (:953), so
    # hd-pc-home / uhd-pc-home take the x264 branch there — consistent
    # with their .mp4 output name (get_cpvs_file_path :124-130)
    is_pc = pp.processing_type == "pc"
    plan: dict = {
        "context": "pc" if is_pc else "mobile",
        # the display-rate resample applies to the pc branch only: the
        # reference's mobile branch carries NO fps filter (its fps line is
        # commented out, lib/ffmpeg.py:1205), so mobile/tablet CPVS keep
        # the AVPVS frame rate
        "fps": float(pp.display_frame_rate) if is_pc else None,
        "normalize": tc.is_long(),
        "t": float(pvs.hrc.get_long_hrc_duration()) if tc.is_long() else None,
    }
    if is_pc:
        vcodec, pix_fmt = pvs.get_vcodec_and_pix_fmt_for_cpvs(rawvideo)
        need_pad = avpvs_height < pp.coding_height
        plan.update(
            vcodec=vcodec,
            pix_fmt=pix_fmt,
            pad=(pp.display_width, pp.display_height) if need_pad else None,
            scale=None,
            audio=(
                dict(codec="pcm_s16le", channels=2) if tc.is_long() else None
            ),
        )
    else:
        need_pad = (
            pp.display_height != pp.coding_height
            or avpvs_height < pp.coding_height
        )
        plan.update(
            vcodec="libx264",
            pix_fmt="yuv420p",
            crf=nonraw_crf,
            preset=mobile_preset,
            profile=mobile_vprofile,
            pad=(pp.display_width, pp.display_height) if need_pad else None,
            scale=None if need_pad else (pp.display_width, pp.display_height),
            audio=(
                dict(codec="aac", bitrate_kbps=512, channels=2)
                if tc.is_long() else None
            ),
        )
    return plan


def t_cap_frames(t: float, rate: Fraction) -> int:
    """Frame count of ffmpeg's `-t <t>` output cap: every frame with
    pts < t, i.e. frames k with k/fps < t — ceil(t*fps) for fractional
    rates (29.97 fps, t=60 -> 1799, not round(1798.2)=1798) and exactly
    t*fps when the product lands on an integer.

    `t` is quantized the way the value reaches ffmpeg in the reference
    (`-t {total_duration}`): Python's shortest-repr decimal, parsed by
    ffmpeg at microsecond precision — NOT the raw binary float
    (Fraction(0.1+0.2) would carry the 4e-17 fuzz across the ceil and emit
    one extra frame when t*fps lands on an integer)."""
    t_us = round(Fraction(str(t)) * 1_000_000)
    return math.ceil(Fraction(t_us, 1_000_000) * rate)


def cpvs_out_rate(plan: dict, avpvs_fps: float) -> Fraction:
    """Output frame rate of one CPVS render: the plan's display rate
    (pc branch) or the AVPVS rate (mobile), rationalized exactly as the
    writer consumes it."""
    return Fraction(
        plan["fps"] if plan["fps"] is not None else avpvs_fps
    ).limit_denominator(1001)


def make_cpvs_transform(plan: dict, post_processing: PostProcessing,
                        pix_fmt: str, rawvideo: bool):
    """The per-chunk device transform one CPVS render applies, built from
    its decision record (`cpvs_plan`'s keys: context, pad, ...). It maps a
    list of [T, H, W] Y, U, V tensors of the AVPVS `pix_fmt` to the
    tensors the CPVS writer takes, on the same device: [T, H, 2W] UYVY
    bytes for the 8-bit PC context, else three planes."""
    pp = post_processing
    ten_bit = "10" in pix_fmt
    dw, dh = pp.display_width, pp.display_height
    need_pad = plan["pad"] is not None

    if plan["context"] == "pc":
        def pc_chunk(chunk):
            y, u, v = chunk[:3]
            if "420" in pix_fmt and not rawvideo:
                # packed/uyvy and v210 outputs are 422-based: lift
                # chroma; rawvideo passes through the AVPVS layout
                u, v = pf.chroma_420_to_422(u, v)
            if need_pad:
                # chroma pads on its own grid: full height for 422
                # layouts, half height for raw 420 passthrough
                c_h = dh // 2 if (rawvideo and "420" in pix_fmt) else dh
                y = pad_ops.pad_center(y, dh, dw, 16.0 if not ten_bit else 64.0)
                u = pad_ops.pad_center(u, c_h, dw // 2, 128.0 if not ten_bit else 512.0)
                v = pad_ops.pad_center(v, c_h, dw // 2, 128.0 if not ten_bit else 512.0)
            if rawvideo:
                # raw passthrough in the AVPVS pix_fmt
                return fr.quantize_device([y, u, v], ten_bit)
            if not ten_bit:
                # packed UYVY422 via the rawvideo encoder
                return [pf.pack_uyvy422(*fr.quantize_device([y, u, v], False))]
            # v210 encoder takes planar yuv422p10le input
            return fr.quantize_device([y, u, v], True)

        return pc_chunk

    def mobile_chunk(chunk):
        # mobile / tablet: output is always 8-bit yuv420p, so 10-bit
        # AVPVS chunks are depth-converted first
        chunk = list(chunk[:3])
        if ten_bit:
            chunk = [pf.depth_10_to_8(p) for p in chunk]
        if need_pad:
            # pad-only at native AVPVS size (letterbox), the
            # reference's padding branch applies no scale
            # (lib/ffmpeg.py:1207-1210)
            y, u, v = pad_ops.pad_yuv(tuple(chunk), dh, dw, "yuv420p")
        else:
            y, u, v = fr.scale_yuv_frames(chunk, dh, dw, "bicubic", (2, 2))
        return fr.quantize_device([y, u, v], False)

    return mobile_chunk


def make_preview_transform(pix_fmt: str):
    """The per-chunk ProRes-preview transform: Y, U, V tensors of the
    AVPVS `pix_fmt` → yuv422p10le planes on the same device."""
    def fr_round(*planes):
        return tuple(
            torch.clamp(torch.floor(p.to(torch.float32) + 0.5), 0, 255).to(torch.uint8)
            for p in planes
        )

    def preview_chunk(chunk):
        y, u, v = chunk[:3]
        if "420" in pix_fmt:
            u, v = pf.chroma_420_to_422(u, v)
        if "10" not in pix_fmt:
            y, u, v = (pf.depth_8_to_10(q) for q in fr_round(y, u, v))
        return [y, u, v]

    return preview_chunk
