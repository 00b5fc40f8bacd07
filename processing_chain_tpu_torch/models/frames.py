"""Shared frame-pipeline helpers for the artifact models (port of
processing_chain_tpu/models/frames.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import resize


def calculate_avpvs_video_dimensions(
    src_width: int, src_height: int, postproc_w: int, postproc_h: int
) -> tuple[int, int]:
    """AVPVS canvas dimensions (reference lib/ffmpeg.py:33-58).

    Same-size SRC → post-processing dims. Mobile-style targets narrower
    than the SRC adapt height to the SRC aspect ratio (rounded up to even);
    otherwise a (3-decimal) aspect-ratio mismatch keeps the SRC height.
    The reference's `&`-for-`and` precedence slip at ffmpeg.py:45 is on the
    do-not-copy list; this implements the intended check.
    """
    if src_width == postproc_w and src_height == postproc_h:
        return postproc_w, postproc_h
    src_ar = src_width / src_height
    post_ar = postproc_w / postproc_h
    w, h = postproc_w, postproc_h
    if postproc_w < src_width:
        if src_ar != post_ar:
            h = int(postproc_w / src_ar)
            if h % 2:
                h += 1
    else:
        if int(1000 * src_ar) != int(1000 * post_ar):
            h = src_height
    return w, h


def scale_to_width_keep_ar(
    src_h: int, src_w: int, target_w: int
) -> tuple[int, int]:
    """ffmpeg `scale=W:-2` semantics (reference encode filter,
    lib/ffmpeg.py:800): fixed width, proportional height rounded to the
    nearest even number."""
    h = int(round(target_w * src_h / src_w / 2.0)) * 2
    return h, target_w


def scale_yuv_frames(
    planes: list,
    dst_h: int,
    dst_w: int,
    kernel: str = "bicubic",
    chroma_sub: tuple[int, int] = (2, 2),
) -> list[torch.Tensor]:
    """Resize stacked planar YUV [T, H, W] tensors to a new luma size with
    chroma on its subsampled grid, one resize call per plane.
    chroma_sub = (sub_h, sub_w)."""
    sub_h, sub_w = chroma_sub
    return [
        resize.resize_frames(planes[0], dst_h, dst_w, kernel),
        resize.resize_frames(planes[1], dst_h // sub_h, dst_w // sub_w, kernel),
        resize.resize_frames(planes[2], dst_h // sub_h, dst_w // sub_w, kernel),
    ]


def chroma_subsampling(pix_fmt: str) -> tuple[int, int]:
    """(sub_h, sub_w) for a planar yuv pix_fmt."""
    if "420" in pix_fmt:
        return (2, 2)
    if "422" in pix_fmt:
        return (1, 2)
    return (1, 1)


def quantize_device(planes: list, ten_bit: bool = False) -> list[torch.Tensor]:
    """Round/clip float planes to the container bit depth on their own
    device, so the host transfer moves uint8/uint16 (¼ the bytes of
    float32). Planes already at the container depth pass through."""
    hi, dt = (1023, torch.uint16) if ten_bit else (255, torch.uint8)
    out = []
    for p in planes:
        if p.dtype == dt:
            out.append(p)
        elif p.dtype in (torch.uint8, torch.uint16):
            # saturate, never wrap, on a narrowing integer cast
            out.append(torch.clamp(p.to(torch.int32), 0, hi).to(dt))
        else:
            out.append(
                torch.clamp(torch.floor(p + 0.5), 0, hi).to(torch.int32).to(dt)
            )
    return out


def to_uint8(planes: list, ten_bit: bool = False) -> list[np.ndarray]:
    """Device float/int planes → host numpy in the container bit depth."""
    out = []
    for p in planes:
        arr = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        if ten_bit:
            if arr.dtype != np.uint16:
                arr = np.clip(np.floor(arr.astype(np.float64) + 0.5), 0, 1023).astype(np.uint16)
            out.append(arr)
        else:
            if arr.dtype != np.uint8:
                arr = np.clip(np.floor(arr.astype(np.float64) + 0.5), 0, 255).astype(np.uint8)
            out.append(arr)
    return out
