"""Pixel-format conversions on the planes' device (port of
processing_chain_tpu/ops/pixfmt.py).

Covers the chain's format plumbing (reference lib/test_config.py:447-480
harmonization targets and lib/ffmpeg.py CPVS maps): planar 420/422/444
chroma resampling through `resize.resize_plane` (the resize kernel on a
CUDA tensor), 8↔10-bit depth conversion, and UYVY422 packing for the
PC-context CPVS. Integer shifts run in int32 and are cast back: torch
defines few operations on uint16.
"""

from __future__ import annotations

import torch

from .resize import resize_plane


def chroma_to_444(u: torch.Tensor, v: torch.Tensor, luma_h: int, luma_w: int,
                  kernel: str = "bilinear") -> tuple[torch.Tensor, torch.Tensor]:
    """Upsample subsampled chroma planes to the luma grid."""
    return (
        resize_plane(u, luma_h, luma_w, kernel),
        resize_plane(v, luma_h, luma_w, kernel),
    )


def chroma_420_to_422(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """yuv420p → yuv422p: double the chroma height (vertical bilinear)."""
    h, w = u.shape[-2], u.shape[-1]
    return (
        resize_plane(u, h * 2, w, "bilinear"),
        resize_plane(v, h * 2, w, "bilinear"),
    )


def chroma_422_to_420(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """yuv422p → yuv420p: halve the chroma height."""
    h, w = u.shape[-2], u.shape[-1]
    return (
        resize_plane(u, h // 2, w, "bilinear"),
        resize_plane(v, h // 2, w, "bilinear"),
    )


def depth_8_to_10(plane: torch.Tensor) -> torch.Tensor:
    """uint8 → 10-bit in uint16 (left shift, ffmpeg's scale semantics)."""
    return (plane.to(torch.int32) << 2).to(torch.uint16)


def depth_10_to_8(plane: torch.Tensor) -> torch.Tensor:
    """10-bit uint16 → uint8 with round-half-up."""
    p = plane.to(torch.int32)
    return torch.clamp((p + 2) >> 2, 0, 255).to(torch.uint8)


def pack_uyvy422(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Planar yuv422 (u/v at half width) → packed UYVY bytes [..., H, W*2]
    (the rawvideo CPVS layout for the PC context), on y's device."""
    h, w = y.shape[-2], y.shape[-1]
    out = torch.zeros(y.shape[:-2] + (h, w * 2), dtype=torch.uint8, device=y.device)
    out[..., 0::4] = u
    out[..., 2::4] = v
    out[..., 1::2] = y
    return out


def planes_to_float(planes: tuple, ten_bit: bool = False) -> tuple:
    """Native-depth planes → float32 in [0, 255] (10-bit scaled to 8-bit
    range so kernels are depth-agnostic)."""
    scale = 1.0 / 4.0 if ten_bit else 1.0
    return tuple(p.to(torch.float32) * scale for p in planes)


def float_to_planes(planes: tuple, ten_bit: bool = False) -> tuple:
    """float32 [0,255] range → uint8 or 10-bit uint16 with round-half-up."""
    if ten_bit:
        return tuple(
            torch.clamp(torch.floor(p * 4.0 + 0.5), 0, 1023).to(torch.int32).to(torch.uint16)
            for p in planes
        )
    return tuple(
        torch.clamp(torch.floor(p + 0.5), 0, 255).to(torch.int32).to(torch.uint8)
        for p in planes
    )
