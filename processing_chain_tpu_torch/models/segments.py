"""Segment encoding model, the p01 compute (port of
processing_chain_tpu/models/segments.py; reference encode path
lib/ffmpeg.py:772-937 + _get_video_encoder_command :61-318).

Where the reference builds an ffmpeg command string per segment, this model
is a typed pipeline: host decode of the SRC window → frame-rate select on
the host (the reference's drop tables) → host-to-device copy → bicubic
scale on the device (`scale=W:-2`, the fused resize kernel on the card) →
host planes at the target container depth → host x264/x265/libvpx/libaom
encode with the same rate-control surface (bitrate/CRF/QP, min/max/bufsize
factors, GOP from iFrameInterval × fps, bframes, scenecut, preset,
speed/quality/cpu-used, enc_options, two-pass). `scaled_chunks` is the
device half on its own: decoded chunks in, host planes out.
"""

from __future__ import annotations

import os
from fractions import Fraction
from typing import Iterable, Iterator, Optional

from ..config.domain import Segment
from ..engine import prefetch as pfe
from ..engine.jobs import Job
from ..io import medialib, sharedscan
from ..io.video import VideoReader, VideoWriter
from ..ops import fps as fps_ops
from ..parallel.pipeline import iter_device_ahead
from ..store import keys as store_keys
from ..utils.device import resolve_device
from ..utils.log import get_logger
from . import frames as fr

#: encoder name → libav encoder
_ENCODERS = {
    "libx264": "libx264",
    "h264_nvenc": "libx264",   # no NVENC on the H100; transparent fallback
    "libx265": "libx265",
    "hevc_nvenc": "libx265",
    "libvpx-vp9": "libvpx-vp9",
    "libaom-av1": "libaom-av1",
}

#: requested encoders already warned about this run (warn once, not per job)
_warned_substitutions: set = set()


def reset_run_state() -> None:
    """Start-of-run reset (stage drivers call this): substitution warnings
    fire once per RUN, not once per process lifetime."""
    _warned_substitutions.clear()


def _encoder_opts(
    segment: Segment, current_pass: int, total_passes: int,
    stats_path: str = "",
) -> str:
    """Private-option string mirroring _get_video_encoder_command semantics
    (reference lib/ffmpeg.py:61-318), minus what VideoWriter takes as
    first-class arguments (bitrate/min/max/bufsize/gop/bframes)."""
    coding = segment.video_coding
    encoder = _ENCODERS[coding.encoder]
    opts: list[str] = []

    if coding.crf is not None:
        opts.append(f"crf={segment.quality_level.video_crf}")
    elif coding.qp is not None:
        opts.append(f"qp={segment.quality_level.video_qp}")

    if coding.preset and encoder in ("libx264", "libx265"):
        opts.append(f"preset={coding.preset}")

    if encoder == "libx264":
        if not coding.scenecut:
            opts.append("x264-params=" + _escape_opt_value("scenecut=-1"))
    elif encoder == "libx265":
        params = ["log-level=error"]
        # reference quirk (do-not-copy list, kept as the JAX package keeps
        # it): the reference appended x265 scenecut=0 whenever scenecut was
        # NOT False (inverted against x264, ffmpeg.py:213-214); here, as in
        # the JAX package, scenecut=False disables it
        if not coding.scenecut:
            params.append("scenecut=0")
        if total_passes == 2:
            # libx265 has no "stats" AVOption (x264's route): pass AND the
            # stats path both travel inside x265-params, else x265 writes
            # ./x265_2pass.log into the process cwd
            params.append(f"pass={current_pass}")
            if stats_path:
                params.append(f"stats={stats_path}")
        opts.append("x265-params=" + _escape_opt_value(":".join(params)))
    elif encoder == "libvpx-vp9":
        speed = coding.speed
        # first pass runs at speed 4 (reference :100-102)
        if total_passes == 2 and current_pass == 1:
            speed = 4
        opts.append(f"quality={coding.quality}")
        opts.append(f"speed={speed}")
        opts.append("row-mt=1")
    elif encoder == "libaom-av1":
        opts.append(f"cpu-used={coding.cpu_used}")
        opts.append("usage=realtime")

    if coding.enc_options:
        opts.append(enc_options_to_opts(coding.enc_options))
    return ":".join(o for o in opts if o)


def _escape_opt_value(value: str) -> str:
    """Escape an option VALUE for the ':'-joined opts string the native
    boundary parses with av_dict_parse_string(.., "=", ":", 0): a bare ':'
    in a value (x265-params=a=1:b=2, x264opts keyint=48:min-keyint=48)
    would otherwise split the value into bogus extra options that fall
    through to the muxer and are silently dropped. av_get_token honors
    backslash escapes."""
    return value.replace("\\", "\\\\").replace(":", "\\:")


def enc_options_to_opts(enc_options: str) -> str:
    """Translate a database's `enc_options` into codec-context options.

    The reference splices enc_options RAW into its ffmpeg command line
    (reference lib/ffmpeg.py:122-124 spliced at :169/:238), so databases
    carry flag syntax like `-tune zerolatency -bf 0`. Here encoder options
    are AVOptions on the codec context, so `-k v` pairs map to `k=v` (a
    valueless flag becomes `k=1`, AVOption bool style); `k=v:k=v` strings
    pass through unchanged. ffmpeg *stream-specifier* flags (`-b:v` etc.)
    belong to the rate-control surface, which is first-class on the
    Coding — a specifier key here raises rather than misconfiguring the
    encoder silently."""
    s = str(enc_options).strip()
    if not s.startswith("-"):
        return s

    def is_flag(tok: str) -> bool:
        return tok.startswith("-") and len(tok) > 1 and not (
            tok[1].isdigit() or tok[1] == "."
        )

    toks = s.split()
    pairs = []
    i = 0
    while i < len(toks):
        tok = toks[i]
        if not is_flag(tok):
            raise ValueError(
                f"enc_options: cannot parse {tok!r} in {s!r} (expected a "
                f"-flag)"
            )
        key = tok.lstrip("-")
        if ":" in key:
            raise ValueError(
                f"enc_options: stream-specifier flag {tok!r} is not a codec "
                "option; use the Coding's first-class rate-control fields"
            )
        if i + 1 < len(toks) and not is_flag(toks[i + 1]):
            pairs.append(f"{key}={_escape_opt_value(toks[i + 1])}")
            i += 2
        else:
            pairs.append(f"{key}=1")
            i += 1
    return ":".join(pairs)


def plan_segment_frames(segment: Segment) -> tuple[int, int, Optional[float], float]:
    """Decode + filter plan of one segment: (target_h, target_w,
    target_fps or None, out_fps). Mirrors the reference's filter chain
    scale=W:-2,select,fps (lib/ffmpeg.py:794-834)."""
    src_info = segment.src.stream_info
    return _plan_frames(src_info["height"], src_info["width"], segment.src.get_fps(),
                        segment.quality_level.width, segment.quality_level.fps)


def _plan_frames(
    src_h: int, src_w: int, src_fps: float, width: int, fps_spec
) -> tuple[int, int, Optional[float], float]:
    """`plan_segment_frames` on loose geometry: the SRC's size and rate,
    the quality level's width and fps spec."""
    target_fps = fps_ops.resolve_fps_spec(fps_spec, src_fps)
    target_h, target_w = fr.scale_to_width_keep_ar(src_h, src_w, width)
    out_fps = target_fps if target_fps is not None else src_fps
    return target_h, target_w, target_fps, out_fps


def scaled_chunks(
    chunks: Iterable,
    src_fps: float,
    target_fps: Optional[float],
    target_h: int,
    target_w: int,
    pix_fmt: str,
    device=None,
    segment: Optional[str] = None,
) -> Iterator[list]:
    """Decoded host chunks (lists of [T, H, W] Y, U, V planes, numpy or
    CPU tensors) → fps select on the host → host-to-device copy → bicubic
    scale to target_h x target_w with chroma on `pix_fmt`'s grid → host
    numpy planes at `pix_fmt`'s container depth (`frames.to_uint8`).

    The drop table of src_fps → target_fps is checked here, before the
    first chunk is pulled; a stream that yields no frame raises
    RuntimeError when it ends, MediaError naming `segment` when given (the
    encode's own decode)."""
    device = resolve_device(device)
    select = target_fps is not None and target_fps != src_fps
    if select:
        fps_ops.select_table(src_fps, target_fps)
    sub = fr.chroma_subsampling(pix_fmt)
    ten_bit = "10" in pix_fmt and pix_fmt != "yuv410p"
    stream = fps_ops.stream_select(chunks, src_fps, target_fps) if select else chunks
    return _scale(stream, target_h, target_w, sub, ten_bit, device, segment)


def _scale(stream, target_h, target_w, sub, ten_bit, device, segment) -> Iterator[list]:
    decoded_any = False
    for _, planes in iter_device_ahead(stream, device):
        decoded_any = True
        scaled = fr.scale_yuv_frames(planes, target_h, target_w, "bicubic", sub)
        yield fr.to_uint8(scaled, ten_bit)
    if not decoded_any:
        if segment is not None:
            raise medialib.MediaError(f"no frames decoded for {segment}")
        raise RuntimeError("no frames decoded for the segment")


def rate_control_kwargs(segment: Segment, out_fps: float | None = None) -> dict:
    """Numeric rate-control/GOP writer arguments (reference lib/ffmpeg.py:
    bitrate :414-445 via target_video_bitrate, vbv/min/max rate factors
    :188-201/:249-259/:287-291, keyframe interval :203-210/:260-266/
    :293-299, bframes :216-218). Pass `out_fps` when plan_segment_frames
    was already run for this segment."""
    coding = segment.video_coding
    if out_fps is None:
        _, _, _, out_fps = plan_segment_frames(segment)
    bitrate = 0.0
    if coding.crf is None and coding.qp is None:
        bitrate = float(segment.target_video_bitrate or 0)
    return dict(
        bitrate_kbps=bitrate,
        maxrate_kbps=(coding.maxrate_factor or 0) * bitrate,
        minrate_kbps=(coding.minrate_factor or 0) * bitrate,
        bufsize_kbps=(coding.bufsize_factor or 0) * bitrate,
        gop=(
            int(out_fps * coding.iframe_interval)
            if coding.iframe_interval else -1
        ),
        bframes=coding.bframes if coding.bframes is not None else -1,
    )


def _segment_audio(segment: Segment, log) -> tuple[dict, object]:
    """(writer audio arguments, int16 samples) of a segment, ({}, None)
    for none. Long tests encode the SRC window's audio with the
    database's audio coding. Short tests carry the SRC's audio in the
    container's default codec, as the reference's ffmpeg call does: it
    emits neither -c:a nor -an for them (ffmpeg.py:839-845), so aac for
    .mp4 and opus for .webm, at 128 kb/s standing in for the codec's
    default; an audio-less SRC gives a video-only segment."""
    tc = segment.test_config
    if tc.is_long() and segment.audio_coding is not None:
        samples, rate = medialib.decode_audio_s16(
            segment.src.file_path, segment.start_time, segment.duration
        )
        return dict(
            audio_codec="aac"
            if segment.audio_coding.encoder in ("libfdk_aac", "aac")
            else segment.audio_coding.encoder,
            sample_rate=rate,
            channels=samples.shape[1] if samples.size else 2,
            audio_bitrate_kbps=float(segment.quality_level.audio_bitrate or 128),
        ), samples
    if not tc.is_short():
        return {}, None
    try:
        samples, rate = medialib.decode_audio_s16(
            segment.src.file_path, segment.start_time, segment.duration
        )
    except medialib.MediaError as exc:
        # audio-less SRCs land here by design; the warning keeps a real
        # decode failure from silently dropping audio
        log.warning("%s: segment will carry no audio (%s)", segment.filename, exc)
        return {}, None
    if not samples.size:
        return {}, None
    is_webm = segment.filename.endswith(".webm")
    if is_webm and rate not in (8000, 12000, 16000, 24000, 48000):
        # opus takes only these rates; default-audio parity is not worth a
        # resampler here
        log.warning("%s: SRC audio rate %d unsupported by opus; segment will carry "
                    "no audio", segment.filename, rate)
        return {}, None
    return dict(
        audio_codec="libopus" if is_webm else "aac",
        sample_rate=rate,
        channels=samples.shape[1],
        audio_bitrate_kbps=128.0,
    ), samples


def encode_segment(segment: Segment, device=None) -> Optional[Job]:
    """Build the encode Job of a segment, its frames scaled on `device`
    (None means cuda:0); skip/--force semantics live in Job.should_run /
    JobRunner (engine/jobs.py)."""
    from ..ops import resize as resize_ops
    from . import avpvs

    device = resolve_device(device)
    out_path = segment.file_path
    tc = segment.test_config
    log = get_logger()

    coding = segment.video_coding
    encoder = _ENCODERS.get(coding.encoder)
    if encoder is None:
        raise ValueError(f"wrong encoder: {coding.encoder}")
    if encoder != coding.encoder and coding.encoder not in _warned_substitutions:
        # once per requested encoder per run; the per-segment record lives
        # in provenance below (the reference asks for nvenc through its
        # -gpu N splice, lib/parse_args.py:88-94, p01:64-68; the H100 has
        # no NVENC unit)
        _warned_substitutions.add(coding.encoder)
        log.warning(
            "encoder %s unavailable on this host; substituting %s "
            "(recorded in segment provenance)",
            coding.encoder, encoder,
        )

    target_h, target_w, target_fps, out_fps = plan_segment_frames(segment)
    passes = 2 if coding.passes == 2 else 1
    rc = rate_control_kwargs(segment, out_fps)
    bitrate = rc["bitrate_kbps"]

    def run() -> str:
        src_fps = segment.src.get_fps()
        # the drop table's ratio is checked before the writer opens
        if target_fps is not None and target_fps != src_fps:
            fps_ops.select_table(src_fps, target_fps)

        def scaled():
            """Decode window → fps select → device scale, in chunk_frames()
            batches (O(chunk) memory for any window length, as the
            reference's ffmpeg process streams). A two-pass encode takes
            this twice: two decodes, as the reference's two ffmpeg runs."""
            with VideoReader(
                segment.src.file_path, segment.start_time, segment.duration
            ) as reader:
                chunks = pfe.iter_plane_chunks(reader, avpvs.chunk_frames(device))
                yield from scaled_chunks(chunks, src_fps, target_fps, target_h, target_w,
                                         segment.target_pix_fmt, device,
                                         segment=f"{segment} from {segment.src.file_path}")

        fps_frac = Fraction(out_fps).limit_denominator(1001)
        audio, samples = _segment_audio(segment, log)
        stats = os.path.join(
            tc.get_logs_path(),
            "passlogfile_" + os.path.splitext(segment.filename)[0],
        )

        def encode_pass(pass_num: int, path: str) -> None:
            with_audio = bool(audio) and (pass_num != 1 or passes == 1)
            kw = dict(
                codec=encoder,
                width=target_w,
                height=target_h,
                pix_fmt=segment.target_pix_fmt,
                fps=(fps_frac.numerator, fps_frac.denominator),
                **rc,
                threads=1,  # determinism (reference -threads 1, :790)
                opts=_encoder_opts(segment, pass_num, passes, stats),
                pass_num=pass_num if passes == 2 else 0,
                stats_path=stats if passes == 2 else "",
            )
            with pfe.AsyncWriter(VideoWriter(path, **kw, **(audio if with_audio else {}))) as w:
                if with_audio:
                    w.write_audio(samples)
                with pfe.Prefetcher(scaled(), depth=2) as pre:
                    for chunk in pre:
                        w.put(chunk)

        null_out = out_path + ".pass1.tmp" + os.path.splitext(out_path)[1]
        try:
            if passes == 2:
                encode_pass(1, null_out)
                os.unlink(null_out)
                encode_pass(2, out_path)
            else:
                encode_pass(1, out_path)
        except BaseException:
            # Job.run cleans out_path; the pass-1 temporary is ours
            if os.path.isfile(null_out):
                os.unlink(null_out)
            raise
        # shared-scan priming: the finished segment is still in the page
        # cache, so pay its one demux pass now; p02's frame tables then read
        # the cached arrays (io/sharedscan.py). An accelerator, never a
        # gate: a scan failure surfaces where a consumer needs the data.
        # plan-exempt: (a cache of the finished segment's packet tables; the bytes are written)
        if os.environ.get("PC_SCAN_PRIME", "1") != "0":
            try:
                sharedscan.prime(out_path)
            except (OSError, medialib.MediaError):
                pass
        return out_path

    # plan payload (store/keys schema): everything that determines the
    # encoded bytes — the SRC's content digest, the decode window, the
    # resolved scale/fps/encode surface, the resize identity
    plan = {
        "op": "encode_segment",
        "src": store_keys.file_ref(segment.src.file_path),
        "window": [segment.start_time, segment.duration],
        "scale": [target_w, target_h, "bicubic"],
        "resize": resize_ops.plan_resize_method(device),
        "fps": out_fps,
        "pix_fmt": segment.target_pix_fmt,
        "encoder": encoder,
        "passes": passes,
        "rate_control": rc,
        "coding": {
            "crf": segment.quality_level.video_crf
            if coding.crf is not None else None,
            "qp": segment.quality_level.video_qp
            if coding.qp is not None else None,
            "preset": coding.preset,
            "scenecut": bool(coding.scenecut),
            "speed": getattr(coding, "speed", None),
            "quality": getattr(coding, "quality", None),
            "cpu_used": getattr(coding, "cpu_used", None),
            "enc_options": coding.enc_options or None,
        },
        "audio": {
            "long": bool(tc.is_long()),
            "encoder": segment.audio_coding.encoder
            if tc.is_long() and segment.audio_coding is not None else None,
            "bitrate_kbps": float(segment.quality_level.audio_bitrate or 0)
            if tc.is_long() else None,
        },
    }

    return Job(
        label=f"encode {segment.filename}",
        output_path=out_path,
        fn=run,
        logfile_path=segment.get_logfile_path(),
        plan=plan,
        provenance={
            "segmentFilename": segment.filename,
            "pipeline": {
                "decode": segment.src.filename,
                "window": [segment.start_time, segment.duration],
                "scale": [target_w, target_h, "bicubic"],
                "fps": out_fps,
                "encoder": encoder,
                # present exactly when a requested encoder was substituted
                # (the nvenc → libx264/x265 fallback)
                **({"encoder_requested": coding.encoder}
                   if encoder != coding.encoder else {}),
                "passes": passes,
                "rate_control": (
                    {"crf": segment.quality_level.video_crf}
                    if coding.crf is not None
                    else {"qp": segment.quality_level.video_qp}
                    if coding.qp is not None
                    else {"bitrate_kbps": bitrate}
                ),
            },
        },
    )
