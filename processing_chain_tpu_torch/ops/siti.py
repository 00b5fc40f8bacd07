"""SI / TI spatial-temporal complexity features (ITU-T P.910); port of
processing_chain_tpu/ops/siti.py.

SI = population stddev over pixels of the Sobel gradient magnitude (border
excluded); TI = population stddev over pixels of the inter-frame luma
difference. `si_frames`, `ti_frames`, `siti` and `siti_batch` go through
the CUDA kernels for a CUDA tensor and through their plain torch versions
for a CPU tensor (ops/cuda_kernels.py); `siti` and `siti_batch` take both
features from one fused pass.
"""

from __future__ import annotations

import math

import torch

from . import cuda_kernels


def sobel_magnitude(y: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude of a [H, W] luma plane, valid region [H-2, W-2]
    (f32, as the reference)."""
    gx, gy = cuda_kernels.sobel_gradients(y.to(torch.float32))
    return torch.sqrt(gx * gx + gy * gy)


def si_frame(y: torch.Tensor) -> torch.Tensor:
    """Spatial information of one frame (population stddev, P.910)."""
    return torch.std(sobel_magnitude(y), correction=0)


def si_frames(y: torch.Tensor) -> torch.Tensor:
    """SI per frame (f32 [T]) for [T, H, W] luma at integer container
    depth (CUDA or CPU) or f32 (CPU)."""
    return cuda_kernels.si_frames_fused(y.contiguous())


def ti_frames(y: torch.Tensor, prev=None) -> torch.Tensor:
    """TI per frame (f32 [T]) for [T, H, W] luma: TI[t] = std(y[t] −
    y[t−1]); TI[0] diffs against `prev` ([H, W], same dtype) when given,
    else is 0."""
    return cuda_kernels.ti_frames_fused(y.contiguous(), prev)


def ti_frames_continued(y: torch.Tensor, prev_last):
    """(TI[T], new prev_last) for one chunk of a streamed clip: TI[0]
    diffs against the previous chunk's last luma frame when given, else
    stays 0 (clip start). The carried frame stays at container depth (the
    reference carries it as f32; the samples are integers, so the values
    are the same) and is a copy, so the chunk it came from can be freed."""
    ti = ti_frames(y, prev_last)
    return ti, y[-1].clone()


def siti(y: torch.Tensor):
    """(SI[T], TI[T]) for a [T, H, W] luma tensor in one fused pass,
    TI[0] = 0 — the batched feature extractor of the flagship step."""
    return cuda_kernels.siti_frames_fused(y.contiguous())


def siti_batch(y: torch.Tensor, prev_last: torch.Tensor):
    """(SI[B, T], TI[B, T]) for [B, T, H, W] luma lanes with a per-lane
    predecessor frame prev_last [B, H, W] of the same dtype: TI[b, 0]
    diffs against prev_last[b]. The wave step's feature pass."""
    return cuda_kernels.siti_frames_fused_batch(y.contiguous(), prev_last.contiguous())


#: reference util/complexity_classification.py:34 — "arbitrarily chosen in
#: order to get a maximum difficulty of around 10"
REFERENCE_BITRATE = 2.75


def norm_bitrate_complexity(
    size_bytes: float, framerate: float, duration: float, width: int, height: int,
) -> tuple[float, float]:
    """The reference's complexity proxy (util/complexity_classification.py:50-69):
    norm_bitrate = file_size / framerate / duration / (pixels/1000);
    complexity = 20 * log10(norm_bitrate) / REFERENCE_BITRATE.
    Returns (norm_bitrate, complexity)."""
    norm_bitrate = size_bytes / framerate / duration / (width * height / 1000.0)
    return norm_bitrate, 20.0 * math.log10(norm_bitrate) / REFERENCE_BITRATE
