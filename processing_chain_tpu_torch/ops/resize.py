"""Separable polyphase resampling — the chain's hottest op (port of
processing_chain_tpu/ops/resize.py).

The host-side plan functions (`make_plan`, `make_swscale_plan`,
`_swscale_tap_matrix`, `swscale_exact_applicable` and their helpers) are
copied unchanged from the reference package: they are the state the
device side is fed, and tests/test_torch_resize.py holds them array-equal
to the originals. Filter construction mirrors libswscale's: align-centers
source mapping, BC-spline bicubic (B=0, C=0.6), Lanczos-3, support
widening + renormalization for downscale.

Routing (`resize_plane`, method "auto"): integer frames with quantized
output go to `cuda_kernels.resize_frames_fused`, which launches the CUDA
kernel for a CUDA tensor and runs its plain torch version for a CPU
tensor. Float input (or unquantized output) takes the block-banded matrix
products (`banded`, the reference's accelerator route) on the card and
the f32 tap gather (`gather`, the reference's route elsewhere) on the
CPU. The reference's CPU-only native-libswscale route is not ported.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side filter construction (copied from the reference package)
# ---------------------------------------------------------------------------


def _bicubic_kernel(d: np.ndarray, b: float = 0.0, c: float = 0.6) -> np.ndarray:
    """Mitchell-Netravali BC-spline; swscale's bicubic uses B=0, C=0.6 by
    default (libswscale/utils.c initFilter)."""
    d = np.abs(d)
    d2, d3 = d * d, d * d * d
    p0 = (6.0 - 2.0 * b) / 6.0
    p2 = (-18.0 + 12.0 * b + 6.0 * c) / 6.0
    p3 = (12.0 - 9.0 * b - 6.0 * c) / 6.0
    q0 = (8.0 * b + 24.0 * c) / 6.0
    q1 = (-12.0 * b - 48.0 * c) / 6.0
    q2 = (6.0 * b + 30.0 * c) / 6.0
    q3 = (-b - 6.0 * c) / 6.0
    return np.where(
        d < 1.0,
        p0 + p2 * d2 + p3 * d3,
        np.where(d < 2.0, q0 + q1 * d + q2 * d2 + q3 * d3, 0.0),
    )


def _lanczos_kernel(d: np.ndarray, a: int = 3) -> np.ndarray:
    d = np.abs(d)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.sinc(d) * np.sinc(d / a)
    return np.where(d < a, np.where(d == 0, 1.0, out), 0.0)


_KERNELS = {
    "bicubic": (_bicubic_kernel, 2.0),
    "lanczos": (_lanczos_kernel, 3.0),
    "bilinear": (lambda d: np.maximum(0.0, 1.0 - np.abs(d)), 1.0),
}


@functools.lru_cache(maxsize=256)
def make_plan(
    src_size: int, dst_size: int, kernel: str = "lanczos", quantize: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Tap plan for one axis: (indices [dst, K] int32, weights [dst, K] f32).

    Align-centers mapping: src_pos(i) = (i + 0.5) * src/dst - 0.5. For
    downscales the kernel support widens by the scale ratio and weights are
    renormalized (swscale's filter stretching). With quantize=True weights
    are rounded to swscale's 14-bit fixed-point grid, which is what makes
    8-bit outputs land on the same integers as libswscale.
    """
    if kernel not in _KERNELS:
        raise ValueError(f"unknown resize kernel {kernel!r}")
    if (
        quantize
        and kernel in _SWSCALE_EXACT_KERNELS
        and src_size != dst_size
        and src_size / dst_size <= _SWSCALE_EXACT_MAX_RATIO
    ):
        # share the exact libswscale geometry (positions, edge-tap
        # reduction, border folding, 14-bit error-diffused weights) so the
        # float paths (banded/fused) differ from the golden integer path
        # only by float accumulation rounding — including at borders
        idx, co = _swscale_tap_matrix(src_size, dst_size, kernel, 1 << 14)
        return idx, (co.astype(np.float64) / (1 << 14)).astype(np.float32)
    fn, support = _KERNELS[kernel]
    ratio = src_size / dst_size
    fscale = max(1.0, ratio)
    radius = support * fscale
    ntaps = max(2, int(math.ceil(radius * 2)))
    # even tap counts keep the window symmetric around the center
    if ntaps % 2:
        ntaps += 1

    i = np.arange(dst_size, dtype=np.float64)
    center = (i + 0.5) * ratio - 0.5
    left = np.floor(center).astype(np.int64) - ntaps // 2 + 1
    k = np.arange(ntaps, dtype=np.int64)
    idx = left[:, None] + k[None, :]                   # [dst, K]
    dist = (center[:, None] - idx) / fscale
    w = fn(dist)
    wsum = w.sum(axis=1, keepdims=True)
    w = w / np.where(wsum == 0, 1.0, wsum)
    if quantize:
        # swscale stores coefficients as int16 with 1<<14 == 1.0 and
        # redistributes the rounding remainder so each row sums to 1<<14
        one = 1 << 14
        wq = np.floor(w * one + 0.5).astype(np.int64)
        err = one - wq.sum(axis=1)
        # add the remainder to the largest tap (swscale puts it on the
        # center tap; largest == center for our symmetric windows)
        main = np.argmax(wq, axis=1)
        wq[np.arange(dst_size), main] += err
        w = wq.astype(np.float64) / one
    # clamp taps to the valid range; out-of-range taps replicate the edge
    # (swscale clips filterPos and folds edge weights)
    idx = np.clip(idx, 0, src_size - 1)
    return idx.astype(np.int32), w.astype(np.float32)


# ---------------------------------------------------------------------------
# Exact libswscale integer plans (golden path)
# ---------------------------------------------------------------------------
#
# Reconstruction of libswscale's initFilter (libswscale/utils.c) +
# hScale8To15 + yuv2planeX_8 integer pipeline, validated bit-exact against
# the installed libswscale under SWS_ACCURATE_RND|SWS_BITEXACT (its
# deterministic C reference path) on noise inputs across up/downscales
# including the 1080p->4K north-star ratio (tests/test_ops.py).
#
# Spec note (why ACCURATE_RND is the oracle): without SWS_ACCURATE_RND,
# libswscale dispatches CPU-dependent SIMD kernels (SSE/AVX pmulhw-style
# per-tap truncation in the vertical pass) whose output differs from its
# own C reference by ±1 LSB and is not stable across hosts — measured here:
# default-flags output vs ACCURATE_RND output deviates by exactly <=1 on
# noise. "Bit-exact vs libswscale" is therefore only well-defined against
# the C path; vs default flags the contract is <=1 LSB.

_SWSCALE_EXACT_KERNELS = ("lanczos", "bicubic")
_SWSCALE_EXACT_MAX_RATIO = 16.0  # validated envelope; chain max is ~8x


def _trunc_div(a: int, b: int) -> int:
    q, r = divmod(a, b)
    if r != 0 and (a < 0) != (b < 0):
        q += 1
    return q


@functools.lru_cache(maxsize=256)
def make_swscale_plan(
    src_size: int, dst_size: int, kernel: str, one: int
) -> tuple[np.ndarray, np.ndarray]:
    """libswscale initFilter reconstruction for one axis.

    Returns (pos [dst] int32, coeffs [dst, K] int32) where output i is
    sum_k src[clip(pos[i]+k)] * coeffs[i, k] at `one` fixed-point scale
    (1<<14 horizontal, 1<<12 vertical — swscale's hLumFilter/vLumFilter
    scales). Mirrors utils.c: 16.16 xInc source mapping, double-precision
    kernel eval scaled to fone=2^(54-min(log2(ratio),8)), cumulative-cutoff
    edge-tap reduction (SWS_MAX_REDUCE_CUTOFF=0.002), border folding onto
    edge taps, and sum-preserving error-diffusion quantization
    (ROUNDED_DIV with carried remainder).
    """
    x_inc = ((src_size << 16) + (dst_size >> 1)) // dst_size
    if abs(x_inc - 0x10000) < 10:  # identity
        pos = np.arange(dst_size, dtype=np.int32)
        return pos, np.full((dst_size, 1), one, dtype=np.int32)

    srcW, dstW = src_size, dst_size
    ratio_log2 = (srcW // dstW).bit_length() - 1 if srcW // dstW > 0 else 0
    fone = 1 << (54 - min(ratio_log2, 8))
    size_factor = {"lanczos": 6, "bicubic": 4}[kernel]
    if x_inc <= 1 << 16:
        filter_size = 1 + size_factor
    else:
        filter_size = 1 + (size_factor * srcW + dstW - 1) // dstW
    filter_size = max(min(filter_size, srcW - 2), 1)

    filt = np.zeros((dstW, filter_size), dtype=np.int64)
    fpos = np.zeros(dstW, dtype=np.int64)
    # center_i = (i+0.5)*ratio - 0.5 tracked in 1/2^17 px (utils.c xDstInSrc)
    xDstInSrc = x_inc - 65536
    for i in range(dstW):
        xx = _trunc_div(xDstInSrc - (filter_size - 2) * 65536, 131072)
        fpos[i] = xx
        for j in range(filter_size):
            d = abs((xx + j) * 131072 - xDstInSrc) << 13  # 1/2^30 px
            if x_inc > 1 << 16:
                d = d * dstW // srcW  # downscale kernel stretch
            floatd = d * (1.0 / (1 << 30))
            if kernel == "bicubic":
                B, C = 0, int(0.6 * (1 << 24))
                if d >= 1 << 31:
                    coeff = 0
                else:
                    dd = (d * d) >> 30
                    ddd = (dd * d) >> 30
                    if d < 1 << 30:
                        coeff = (
                            (12 * (1 << 24) - 9 * B - 6 * C) * ddd
                            + (-18 * (1 << 24) + 12 * B + 6 * C) * dd
                            + (6 * (1 << 24) - 2 * B) * (1 << 30)
                        )
                    else:
                        coeff = (
                            (-B - 6 * C) * ddd
                            + (6 * B + 30 * C) * dd
                            + (-12 * B - 48 * C) * d
                            + (8 * B + 24 * C) * (1 << 30)
                        )
                    coeff = coeff // ((1 << 54) // fone)
            else:  # lanczos, p=3
                if floatd == 0.0:
                    coeff = int(fone)
                elif floatd > 3.0:
                    coeff = 0
                else:
                    v = (
                        math.sin(floatd * math.pi)
                        * math.sin(floatd * math.pi / 3.0)
                        / (floatd * floatd * math.pi * math.pi / 3.0)
                    )
                    coeff = int(v * fone)  # C double->int64 truncates
            filt[i, j] = coeff
        xDstInSrc += 2 * x_inc

    # reduce: trim near-zero edge taps (cumulative |coeff| cutoff 0.002)
    cutoff = int(0.002 * fone)
    min_filter_size = 0
    for i in range(dstW - 1, -1, -1):
        mn = filter_size
        cut = 0
        # bounded like initFilter's C loop: an all-zero coefficient row on
        # the last output index would otherwise never hit either break
        for _ in range(filter_size):
            cut += abs(int(filt[i, 0]))
            if cut > cutoff:
                break
            if i < dstW - 1 and fpos[i] >= fpos[i + 1]:
                break
            filt[i, :-1] = filt[i, 1:]
            filt[i, -1] = 0
            fpos[i] += 1
        cut = 0
        for j in range(filter_size - 1, 0, -1):
            cut += abs(int(filt[i, j]))
            if cut > cutoff:
                break
            mn -= 1
        min_filter_size = max(min_filter_size, mn)
    filt = filt[:, :min_filter_size]
    filter_size = min_filter_size

    # fix borders: fold out-of-range taps onto the edge samples
    for i in range(dstW):
        if fpos[i] < 0:
            g = np.zeros(filter_size, dtype=np.int64)
            for j in range(filter_size):
                g[max(j + int(fpos[i]), 0)] += filt[i, j]
            filt[i] = g
            fpos[i] = 0
        if fpos[i] + filter_size > srcW:
            shift = int(fpos[i] + min(filter_size - srcW, 0))
            g = filt[i].copy()
            acc = 0
            for j in range(filter_size - 1, -1, -1):
                if fpos[i] + j >= srcW:
                    acc += g[j]
                    g[j] = 0
            g2 = np.zeros(filter_size, dtype=np.int64)
            g2[shift:] = g[: filter_size - shift] if shift > 0 else g
            fpos[i] -= shift
            g2[srcW - 1 - int(fpos[i])] += acc
            filt[i] = g2

    # normalize + quantize with error diffusion (sum preserved per row)
    out = np.zeros((dstW, filter_size), dtype=np.int32)
    for i in range(dstW):
        s = (int(filt[i].sum()) + one // 2) // one
        if s == 0:
            s = 1
        err = 0
        for j in range(filter_size):
            v = int(filt[i, j]) + err
            iv = _trunc_div(v + (s >> 1) if v >= 0 else v - (s >> 1), s)
            out[i, j] = iv
            err = v - iv * s
    return fpos.astype(np.int32), out


def _swscale_tap_matrix(
    src_size: int, dst_size: int, kernel: str, one: int
) -> tuple[np.ndarray, np.ndarray]:
    """Expand a make_swscale_plan into a clipped [dst, K] index matrix +
    int32 coeffs, the _apply_axis input shape. Out-of-range taps (always
    zero-coefficient after border folding) clip to the edge sample."""
    pos, co = make_swscale_plan(src_size, dst_size, kernel, one)
    k = co.shape[1]
    idx = np.clip(
        pos[:, None].astype(np.int64) + np.arange(k)[None, :], 0, src_size - 1
    )
    return idx.astype(np.int32), co


def swscale_exact_applicable(
    src_h: int, src_w: int, dst_h: int, dst_w: int, kernel: str
) -> bool:
    return (
        kernel in _SWSCALE_EXACT_KERNELS
        and src_h / dst_h <= _SWSCALE_EXACT_MAX_RATIO
        and src_w / dst_w <= _SWSCALE_EXACT_MAX_RATIO
    )


# ---------------------------------------------------------------------------
# Block-banded matmul plan (copied from the reference package)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def make_banded_plan(
    src_size: int, dst_size: int, kernel: str = "lanczos", block: int = 128
) -> tuple[np.ndarray, np.ndarray, int]:
    """Re-express the tap plan as block-banded dense matrices.

    Tap windows are contiguous and their left edge is monotone in the output
    index, so a block of `block` consecutive output rows only reads a
    contiguous band of input rows. Returns (starts [nblocks] int32,
    weights [nblocks, block, band] f32, band): output block b is
    `weights[b] @ x[starts[b] : starts[b]+band]` — a batched dense matrix
    product instead of K per-tap gathers. Weights of taps clipped to the
    same edge row accumulate, so edge replication is preserved exactly.
    """
    idx, w = make_plan(src_size, dst_size, kernel)
    ntaps = idx.shape[1]
    ratio = src_size / dst_size
    nblocks = (dst_size + block - 1) // block
    band = min(int(math.ceil(block * ratio)) + ntaps + 1, src_size)
    starts = np.empty(nblocks, np.int64)
    weights = np.zeros((nblocks, block, band), np.float32)
    for b in range(nblocks):
        i0 = b * block
        i1 = min(i0 + block, dst_size)
        start = max(0, min(int(idx[i0:i1].min()), src_size - band))
        starts[b] = start
        rows = np.repeat(np.arange(i1 - i0), ntaps)
        cols = (idx[i0:i1] - start).reshape(-1)
        np.add.at(weights[b], (rows, cols), w[i0:i1].reshape(-1))
    return starts.astype(np.int32), weights, band


# ---------------------------------------------------------------------------
# Plain torch resampling
# ---------------------------------------------------------------------------


def _apply_axis(
    x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, axis: int
) -> torch.Tensor:
    """Weighted gather along one axis: out[..., i, ...] = Σ_k w[i,k] ·
    x[..., idx[i,k], ...], summed in tap order k = 0..K-1 with one rounding
    per multiply and per add (the CUDA kernel's f32 path repeats exactly
    this order, so the two agree bit for bit)."""
    ntaps = idx.shape[1]
    shape = [1] * x.ndim
    shape[axis] = idx.shape[0]
    out = None
    for k in range(ntaps):
        term = torch.index_select(x, axis, idx[:, k]) * w[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def _swscale_exact(
    x: torch.Tensor, dst_h: int, dst_w: int, kernel: str
) -> torch.Tensor:
    """uint8 [..., H, W] -> uint8 [..., dst_h, dst_w], bit-exact vs the
    libswscale C reference path (SWS_ACCURATE_RND|SWS_BITEXACT).

    Integer pipeline, horizontal first like swscale: hScale8To15
    (int32 MAC of 14-bit coeffs, >>7 arithmetic, clip top to 32767), then
    yuv2planeX_8 (int32 MAC of 12-bit coeffs + dither 64<<12, >>19, clip
    to u8). The identity-axis case degenerates to the same formulas."""
    src_h, src_w = x.shape[-2], x.shape[-1]
    idx_h, hco = _swscale_tap_matrix(src_w, dst_w, kernel, 1 << 14)
    idx_v, vco = _swscale_tap_matrix(src_h, dst_h, kernel, 1 << 12)
    dev = x.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    xi = x.to(torch.int32)
    inter = _apply_axis(xi, t(idx_h), t(hco), x.ndim - 1)
    inter = torch.clamp(inter >> 7, max=32767)
    val = _apply_axis(inter, t(idx_v), t(vco), x.ndim - 2)
    out = (val + (64 << 12)) >> 19
    return torch.clamp(out, 0, 255).to(torch.uint8)


@contextlib.contextmanager
def _full_f32_products():
    """Run the enclosed f32 matrix products in full f32 on the card: the
    TF32 flag is cleared for the block and restored after it, whatever
    the caller's global setting (TF32 keeps 10 mantissa bits and would
    move the result by ~1e-3 of its scale)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@functools.lru_cache(maxsize=64)
def _device_banded_plan(src: int, dst: int, kernel: str, device: torch.device):
    """`make_banded_plan` of one axis on `device`: ([nblocks, band] source
    indices of each block's band, [nblocks, block, band] weights), copied
    to the card once per geometry rather than once per call."""
    starts, weights, band = make_banded_plan(src, dst, kernel)
    idx = starts.astype(np.int64)[:, None] + np.arange(band)[None, :]
    return torch.from_numpy(idx).to(device), torch.from_numpy(weights).to(device)


def _banded_axis_last(x: torch.Tensor, src: int, dst: int, kernel: str) -> torch.Tensor:
    """[..., src] -> [..., dst] via per-block band gather + batched matmul."""
    band_idx, weights = _device_banded_plan(src, dst, kernel, x.device)
    nblocks, block, _ = weights.shape
    xb = x[..., band_idx]                                  # [..., n, band]
    with _full_f32_products():
        out = torch.einsum("...nk,nbk->...nb", xb, weights)
    out = out.reshape(x.shape[:-1] + (nblocks * block,))
    return out[..., :dst]


def _banded_axis_rows(x: torch.Tensor, src: int, dst: int, kernel: str) -> torch.Tensor:
    """[..., src, W] -> [..., dst, W]: band gather of whole rows + matmul."""
    band_idx, weights = _device_banded_plan(src, dst, kernel, x.device)
    nblocks, block, band = weights.shape
    xb = torch.index_select(x, x.ndim - 2, band_idx.reshape(-1))
    xb = xb.reshape(x.shape[:-2] + (nblocks, band, x.shape[-1]))
    with _full_f32_products():
        out = torch.einsum("nbk,...nkw->...nbw", weights, xb)
    out = out.reshape(x.shape[:-2] + (nblocks * block, x.shape[-1]))
    return out[..., :dst, :]


def resize_plane(
    x: torch.Tensor,
    dst_h: int,
    dst_w: int,
    kernel: str = "lanczos",
    quantize_output: bool = True,
    method: str = "auto",
) -> torch.Tensor:
    """Resize [..., H, W] planes to [..., dst_h, dst_w], where they lie.

    Input uint8/uint16 or float; output of the input's integer type,
    rounded half up and clipped, when quantize_output and the input was
    integer, else float32.

    method:
      "gather" — for u8 lanczos/bicubic within the swscale envelope: the
                 exact libswscale integer pipeline (`_swscale_exact`, the
                 golden path). Otherwise K per-tap f32 gathers, vertical
                 then horizontal.
      "banded" — block-banded dense matrix products (`make_banded_plan`),
                 horizontal then vertical, with the golden path's
                 intermediate clamp for u8; f32 arithmetic with 14-bit
                 weights on both axes, so a u8 result sits within one code
                 value of the golden path.
      "auto"   — integer input with quantized output: the fused two-pass
                 resize (`cuda_kernels.resize_frames_fused`: the CUDA kernel
                 for a CUDA tensor, its plain version for a CPU tensor).
                 Otherwise "banded" on a CUDA tensor and "gather" on the
                 CPU, as the reference routes an accelerator and the CPU.
    The identity geometry returns integer input as it is and float input
    as f32."""
    src_h, src_w = x.shape[-2], x.shape[-1]
    integer_in = x.dtype in (torch.uint8, torch.uint16)
    if method not in ("auto", "gather", "banded"):
        raise ValueError(f"unknown resize method {method!r}")
    if integer_in and quantize_output and (src_h, src_w) == (dst_h, dst_w):
        return x
    if method == "auto":
        if integer_in and quantize_output:
            from . import cuda_kernels  # deferred: cuda_kernels imports us

            frames = x.reshape((-1, src_h, src_w)).contiguous()
            out = cuda_kernels.resize_frames_fused(frames, dst_h, dst_w, kernel)
            return out.reshape(x.shape[:-2] + (dst_h, dst_w))
        method = "banded" if x.is_cuda else "gather"
    if (
        method == "gather"
        and x.dtype == torch.uint8
        and quantize_output
        and swscale_exact_applicable(src_h, src_w, dst_h, dst_w, kernel)
    ):
        return _swscale_exact(x, dst_h, dst_w, kernel)
    xf = x.to(torch.float32)
    if (src_h, src_w) != (dst_h, dst_w):
        if method == "banded":
            xf = _banded_axis_last(xf, src_w, dst_w, kernel)
            if x.dtype == torch.uint8:
                xf = torch.clamp(xf, max=32767.0 / 128.0)
            xf = _banded_axis_rows(xf, src_h, dst_h, kernel)
        else:
            dev = x.device
            idx_v, w_v = make_plan(src_h, dst_h, kernel)
            idx_h, w_h = make_plan(src_w, dst_w, kernel)
            xf = _apply_axis(xf, torch.from_numpy(idx_v).to(dev),
                             torch.from_numpy(w_v).to(dev), x.ndim - 2)
            xf = _apply_axis(xf, torch.from_numpy(idx_h).to(dev),
                             torch.from_numpy(w_h).to(dev), x.ndim - 1)
    if integer_in and quantize_output:
        maxval = 255 if x.dtype == torch.uint8 else 1023
        return torch.clamp(torch.floor(xf + 0.5), 0, maxval).to(torch.int32).to(x.dtype)
    return xf


def resize_frames(
    frames: torch.Tensor, dst_h: int, dst_w: int, kernel: str = "lanczos"
) -> torch.Tensor:
    """Batched resize of [T, H, W] (or [H, W]) planes — the entry the
    AVPVS pipeline uses per plane."""
    return resize_plane(frames, dst_h, dst_w, kernel)


def resize_yuv(
    planes,
    dst_h: int,
    dst_w: int,
    pix_fmt: str = "yuv420p",
    kernel: str = "lanczos",
) -> tuple:
    """Resize a planar YUV frame set: luma to (dst_h, dst_w), chroma planes
    to the subsampled grid of `pix_fmt`."""
    sub_w = 2 if ("420" in pix_fmt or "422" in pix_fmt) else 1
    sub_h = 2 if "420" in pix_fmt else 1
    out = [resize_plane(planes[0], dst_h, dst_w, kernel)]
    for p in planes[1:3]:
        out.append(resize_plane(p, dst_h // sub_h, dst_w // sub_w, kernel))
    return tuple(out)
