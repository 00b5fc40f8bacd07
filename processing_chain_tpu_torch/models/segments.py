"""The device half of p01's segment encode (port of the geometry and the
`scaled_chunks` body of processing_chain_tpu/models/segments.py:161-173
and :230-256).

The reference decodes the SRC window, drops frames by the quality level's
fps table, scales each chunk on the device (`scale=W:-2`, bicubic) and
hands host planes at the target container depth to the encoder. Here the
decoded chunks come in as an iterable, so the path runs without the
native media layer; the encoder, the `Job`, rate control and the stage
are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

from ..ops import fps as fps_ops
from ..parallel.pipeline import iter_device_ahead
from ..utils.device import resolve_device
from . import frames as fr


def plan_segment_frames(
    src_h: int, src_w: int, src_fps: float, width: int, fps_spec
) -> tuple[int, int, Optional[float], float]:
    """Decode + filter plan of one quality level: (target_h, target_w,
    target_fps or None, out_fps). Mirrors the reference's filter chain
    scale=W:-2,select,fps (lib/ffmpeg.py:794-834)."""
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
