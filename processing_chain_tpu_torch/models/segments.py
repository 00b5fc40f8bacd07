"""The device half of p01's segment encode (port of the geometry, the
encoder-option translation and the `scaled_chunks` body of
processing_chain_tpu/models/segments.py:105-173 and :230-256).

The reference decodes the SRC window, drops frames by the quality level's
fps table, scales each chunk on the device (`scale=W:-2`, bicubic) and
hands host planes at the target container depth to the encoder. Here the
decoded chunks come in as an iterable, so the path runs without the
native media layer; the encoder, the `Job`, rate control and the stage
are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

from ..config.domain import Segment
from ..ops import fps as fps_ops
from ..parallel.pipeline import iter_device_ahead
from ..utils.device import resolve_device
from . import frames as fr


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
) -> Iterator[list]:
    """Decoded host chunks (lists of [T, H, W] Y, U, V planes, numpy or
    CPU tensors) → fps select on the host → host-to-device copy → bicubic
    scale to target_h x target_w with chroma on `pix_fmt`'s grid → host
    numpy planes at `pix_fmt`'s container depth (`frames.to_uint8`).

    The drop table of src_fps → target_fps is checked here, before the
    first chunk is pulled; a stream that yields no frame raises
    RuntimeError when it ends."""
    device = resolve_device(device)
    select = target_fps is not None and target_fps != src_fps
    if select:
        fps_ops.select_table(src_fps, target_fps)
    sub = fr.chroma_subsampling(pix_fmt)
    ten_bit = "10" in pix_fmt and pix_fmt != "yuv410p"
    stream = fps_ops.stream_select(chunks, src_fps, target_fps) if select else chunks
    return _scale(stream, target_h, target_w, sub, ten_bit, device)


def _scale(stream, target_h, target_w, sub, ten_bit, device) -> Iterator[list]:
    decoded_any = False
    for _, planes in iter_device_ahead(stream, device):
        decoded_any = True
        scaled = fr.scale_yuv_frames(planes, target_h, target_w, "bicubic", sub)
        yield fr.to_uint8(scaled, ten_bit)
    if not decoded_any:
        raise RuntimeError("no frames decoded for the segment")
