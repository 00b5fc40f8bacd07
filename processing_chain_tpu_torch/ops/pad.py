"""Letterbox / pad to a display canvas (port of
processing_chain_tpu/ops/pad.py: the CPVS `pad=` step, reference
lib/ffmpeg.py:1177-1231, centered, black fill), on the plane's device."""

from __future__ import annotations

import torch


def pad_center(
    plane: torch.Tensor,
    dst_h: int,
    dst_w: int,
    fill: float = 16.0,
) -> torch.Tensor:
    """Pad [..., H, W] to [..., dst_h, dst_w] with the content centered
    (ffmpeg pad=W:H:(ow-iw)/2:(oh-ih)/2 semantics: offsets floor). The
    fill takes the plane's dtype."""
    h, w = plane.shape[-2], plane.shape[-1]
    if (h, w) == (dst_h, dst_w):
        return plane
    y0 = (dst_h - h) // 2
    x0 = (dst_w - w) // 2
    out = torch.full(plane.shape[:-2] + (dst_h, dst_w), fill,
                     dtype=plane.dtype, device=plane.device)
    out[..., y0:y0 + h, x0:x0 + w] = plane
    return out


def pad_yuv(
    planes: tuple,
    dst_h: int,
    dst_w: int,
    pix_fmt: str = "yuv420p",
    luma_fill: float = 16.0,
    chroma_fill: float = 128.0,
) -> tuple:
    """Pad planar YUV to a display canvas; chroma planes pad on their
    subsampled grid."""
    sub_w = 2 if ("420" in pix_fmt or "422" in pix_fmt) else 1
    sub_h = 2 if "420" in pix_fmt else 1
    out = [pad_center(planes[0], dst_h, dst_w, luma_fill)]
    for p in planes[1:3]:
        out.append(pad_center(p, dst_h // sub_h, dst_w // sub_w, chroma_fill))
    return tuple(out)
