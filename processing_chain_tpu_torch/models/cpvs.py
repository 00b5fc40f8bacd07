"""CPVS model — the p04 stage (port of processing_chain_tpu/models/
cpvs.py: `normalize_rms`, `_avpvs_chunks` :60, `_limit_frames`,
`trim_normalize_long_audio` :85, `_audio_for_long` :98, `cpvs_plan`
:106-170, `t_cap_frames`, `make_cpvs_transform` :189-246,
`open_cpvs_writer` :249, `cpvs_out_rate`, `create_cpvs` :298,
`make_preview_transform` :381-399, `open_preview_writer` :404 and
`create_preview` :428).

PC context: AVPVS → 420→422 chroma (packed UYVY422 for 8-bit, planar
yuv422p10le for v210) → centered pad to the display canvas when the
AVPVS is shorter; rawvideo passes the AVPVS layout through. Mobile /
tablet: 10-bit → 8-bit, then bicubic scale to the display dims, or pad
only. Preview: 422 10-bit. The transforms take and return tensors on
one device and never fetch to the host: the writer does.

A render job decodes the AVPVS on a prefetch thread, copies each chunk
to the device ahead of its compute (parallel/pipeline.iter_device_ahead),
applies the transform there, and hands the result to the writer thread,
which fetches it through pinned memory and encodes it. Its plan records
the port's resize identity (`plan_resize_method(device)`,
"torch-auto:<device type>"), where the JAX package records its own.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from ..config.domain import PostProcessing, Pvs
from ..engine import prefetch as pfe
from ..engine.jobs import Job
from ..io import medialib
from ..io.video import VideoReader, VideoWriter
from ..ops import pad as pad_ops
from ..ops import pixfmt as pf
from ..ops import resize as resize_ops
from ..parallel.pipeline import iter_device_ahead
from ..store import keys as store_keys
from ..utils.device import resolve_device
from . import avpvs
from . import frames as fr

#: p04's renders (models/avpvs.RenderTotals)
RENDER_TOTALS = avpvs.RenderTotals()


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


def _avpvs_chunks(reader: VideoReader, dst_rate: Optional[float] = None, device=None):
    """Stream an open AVPVS reader as chunk_frames()-sized plane stacks,
    resampled to dst_rate when it differs (ffmpeg `fps=` semantics,
    streaming). O(chunk) memory for arbitrarily long PVSes — never the
    whole AVPVS."""
    chunk = avpvs.chunk_frames(device)
    if dst_rate is not None and dst_rate != reader.fps:
        return pfe.stream_fps_resample(avpvs._frames_as_tensors(reader), reader.fps,
                                       dst_rate, chunk)
    return pfe.iter_plane_chunks(reader, chunk)


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


def trim_normalize_long_audio(
    samples: np.ndarray, rate: int, pvs: Pvs, normalize: bool
) -> np.ndarray:
    """The long-test audio treatment (reference `-t` trim + the
    ffmpeg-normalize step)."""
    total = pvs.hrc.get_long_hrc_duration()
    samples = samples[: int(round(total * rate))]
    if normalize:
        samples = normalize_rms(samples)
    return samples


def _audio_for_long(pvs: Pvs, normalize: bool):
    try:
        samples, rate = medialib.decode_audio_s16(pvs.get_avpvs_file_path())
    except medialib.MediaError:
        return None, 48000
    return trim_normalize_long_audio(samples, rate, pvs, normalize), rate


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


def open_cpvs_writer(out_path: str, plan: dict,
                     post_processing: PostProcessing, w: int, h: int,
                     out_rate: Fraction, audio, srate: int):
    """(VideoWriter, has_audio) for one CPVS render, plan-directed."""
    pp = post_processing
    dw, dh = pp.display_width, pp.display_height
    need_pad = plan["pad"] is not None
    if plan["context"] == "pc":
        aud = (
            dict(audio_codec=plan["audio"]["codec"], sample_rate=srate,
                 channels=plan["audio"]["channels"])
            if (plan["audio"] and audio is not None and audio.size)
            else {}
        )
        writer = VideoWriter(
            out_path, plan["vcodec"], dw if need_pad else w,
            dh if need_pad else h, plan["pix_fmt"],
            (out_rate.numerator, out_rate.denominator), **aud,
        )
        return writer, bool(aud)
    aud = (
        dict(audio_codec=plan["audio"]["codec"], sample_rate=srate,
             channels=plan["audio"]["channels"],
             audio_bitrate_kbps=plan["audio"]["bitrate_kbps"])
        if (plan["audio"] and audio is not None and audio.size)
        else {}
    )
    opts = (
        f"crf={plan['crf']}:preset={plan['preset']}:"
        f"profile={plan['profile']}:movflags=+faststart"
    )
    writer = VideoWriter(
        out_path, "libx264", dw, dh, "yuv420p",
        (out_rate.numerator, out_rate.denominator), opts=opts, **aud,
    )
    return writer, bool(aud)


def _render(chunks, transform, vw, audio, device) -> None:
    """Decode-ahead chunks → device → `transform` → the writer thread,
    which fetches each result through pinned memory and encodes it; the
    pooled host blocks go back once their chunk is encoded. Adds this
    render's seconds and frames to RENDER_TOTALS."""
    device = resolve_device(device)
    decode_s = [0.0]
    frames = 0
    timer = avpvs.DeviceTimer(device)
    transform = timer.wrap(transform)
    with pfe.AsyncWriter(vw, fetch=fr._to_host) as writer:
        if audio is not None:
            writer.write_audio(audio)
        with pfe.Prefetcher(avpvs._timed(chunks, decode_s), depth=2) as pre:
            for chunk, dev in iter_device_ahead(pre, device):
                out = transform(dev)
                frames += int(out[0].shape[0])
                writer.put(out, recycle=chunk)
    RENDER_TOTALS.add(decode_s=decode_s[0], device_s=timer.seconds(),
                      writeback_s=writer.busy_s, frames=frames)


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


def create_cpvs(
    pvs: Pvs,
    post_processing: PostProcessing,
    rawvideo: bool = False,
    nonraw_crf: int = 17,
    mobile_vprofile: str = "high",
    mobile_preset: str = "fast",
    device=None,
) -> Optional[Job]:
    """The CPVS render of one PVS in one viewing context, on `device`
    (`None` means `cuda:0`)."""
    tc = pvs.test_config
    pp = post_processing
    out_path = pvs.get_cpvs_file_path(context=pp.processing_type, rawvideo=rawvideo)

    def run() -> str:
        with VideoReader(pvs.get_avpvs_file_path()) as reader:
            pix_fmt = reader.pix_fmt
            w, h = reader.width, reader.height
            plan = cpvs_plan(
                pvs, pp, h, rawvideo, nonraw_crf, mobile_vprofile,
                mobile_preset,
            )
            # display frame rate resample, streaming (reference
            # fps=displayFrameRate filter; pc branch only — mobile keeps
            # the AVPVS rate, see cpvs_plan)
            chunks = _avpvs_chunks(reader, plan["fps"], device)
            out_rate = cpvs_out_rate(plan, reader.fps)
            if plan["t"] is not None:
                # the reference's long-test `-t total_duration` cap
                chunks = _limit_frames(chunks, t_cap_frames(plan["t"], out_rate))

            audio = None
            srate = 48000
            if tc.is_long():
                audio, srate = _audio_for_long(pvs, normalize=plan["normalize"])

            transform = make_cpvs_transform(plan, pp, pix_fmt, rawvideo)
            vw, has_audio = open_cpvs_writer(
                out_path, plan, pp, w, h, out_rate, audio, srate
            )
            _render(chunks, transform, vw, audio if has_audio else None, device)
        return out_path

    # plan: the AVPVS digest covers every upstream knob transitively;
    # the rest is this render's own decision surface (cpvs_plan's
    # inputs) plus the resize-method identity — the scale/pad path's
    # pixel values depend on it (plan-purity, store/plan_schema.py)
    plan = {
        "op": "cpvs",
        "input": store_keys.file_ref(pvs.get_avpvs_file_path()),
        "resize": resize_ops.plan_resize_method(device),
        "context": pp.processing_type,
        "display": [pp.display_width, pp.display_height],
        "coding": [pp.coding_width, pp.coding_height],
        "display_fps": float(pp.display_frame_rate)
        if pp.display_frame_rate is not None else None,
        "rawvideo": bool(rawvideo),
        "crf": int(nonraw_crf),
        "profile": mobile_vprofile,
        "preset": mobile_preset,
        "t": float(pvs.hrc.get_long_hrc_duration())
        if tc.is_long() else None,
    }

    return Job(
        label=f"cpvs {pvs.pvs_id} {pp.processing_type}",
        output_path=out_path,
        fn=run,
        plan=plan,
        provenance={
            "pvs": pvs.pvs_id,
            "context": pp.processing_type,
            "display": [pp.display_width, pp.display_height],
            "rawvideo": rawvideo,
        },
    )


def open_preview_writer(out_path: str, w: int, h: int, fps: float,
                        audio, srate: int):
    """(VideoWriter, has_audio) for the ProRes preview. ProRes is
    all-intra: the same frame-parallel pool as the FFV1 writeback
    applies (PC_FFV1_WORKERS names the host intra-writeback pool, not
    one codec)."""
    aud = (
        dict(audio_codec="aac", sample_rate=srate, channels=2)
        if audio is not None and audio.size
        else {}
    )
    frac = Fraction(fps).limit_denominator(1001)
    workers = avpvs.ffv1_workers()
    writer = VideoWriter(
        out_path, "prores_ks", w, h,
        "yuv422p10le", (frac.numerator, frac.denominator),
        opts=f"pc_fp_workers={workers}" if workers > 0 else "",
        **aud,
    )
    return writer, bool(aud)


def create_preview(pvs: Pvs, device=None) -> Optional[Job]:
    """ProRes + AAC preview (reference create_preview :1250-1259), on
    `device` (`None` means `cuda:0`)."""
    out_path = pvs.get_preview_file_path()

    def run() -> str:
        audio = None
        srate = 48000
        try:
            audio, srate = medialib.decode_audio_s16(pvs.get_avpvs_file_path())
        except medialib.MediaError:
            audio = None
        with VideoReader(pvs.get_avpvs_file_path()) as reader:
            transform = make_preview_transform(reader.pix_fmt)
            vw, has_audio = open_preview_writer(
                out_path, reader.width, reader.height, reader.fps,
                audio, srate,
            )
            _render(pfe.iter_plane_chunks(reader, avpvs.chunk_frames(device)), transform, vw,
                    audio if has_audio else None, device)
        return out_path

    return Job(
        label=f"preview {pvs.pvs_id}",
        output_path=out_path,
        fn=run,
        plan={
            "op": "preview",
            "input": store_keys.file_ref(pvs.get_avpvs_file_path()),
            "codec": "prores_ks",
        },
        provenance={"pvs": pvs.pvs_id, "codec": "prores_ks"},
    )
