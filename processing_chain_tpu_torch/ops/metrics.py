"""Full-reference per-frame quality metrics: PSNR, SSIM, MS-SSIM and VIF
(port of processing_chain_tpu/ops/metrics.py, and of the VIF body of
processing_chain_tpu/tools/quality_metrics.py:166-263, which the
reference's docstring asks to move here beside MS-SSIM).

Plain torch ops on the planes' device; the reference has no TPU kernel for
them. Every function takes [..., H, W] planes and reduces the last two
axes, so one call scores a whole [T, H, W] chunk. The Gaussian windows are
applied as the reference's shifted multiply-adds (`_filter2_sep`), VIF's
valid convolutions included: no convolution library is called, so the
card computes in full f32 with no TF32 rounding, and the card and the CPU
sum the taps in the same order.
"""

from __future__ import annotations

import functools

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def psnr_frames(ref: torch.Tensor, deg: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """PSNR of [..., H, W] plane pairs, dB per plane (inf-free: clamped to
    100 dB for identical planes, as ffmpeg's psnr filter caps)."""
    diff = _f32(ref) - _f32(deg)
    mse = torch.mean(diff * diff, dim=(-2, -1))
    psnr = 10.0 * torch.log10((peak * peak) / torch.clamp(mse, min=1e-10))
    return torch.clamp(psnr, max=100.0)


def psnr_frame(ref: torch.Tensor, deg: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """PSNR of one [H, W] plane pair (a 0-d tensor)."""
    return psnr_frames(ref, deg, peak)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Normalized 1-D Gaussian window (f32, on the host: the filters read
    its taps as numbers, so a window never waits on the card)."""
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def _filter2_sep(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode filter of [..., H, W] by the 1-D window `k`:
    vertical, then horizontal, each a sum of shifted planes times their
    tap in tap order."""
    size = k.shape[0]
    h, w = img.shape[-2], img.shape[-1]
    taps = [float(v) for v in k]
    out = img[..., 0:h - size + 1, :] * taps[0]
    for i in range(1, size):
        out.add_(img[..., i:h - size + 1 + i, :], alpha=taps[i])
    out2 = out[..., 0:w - size + 1] * taps[0]
    for i in range(1, size):
        out2.add_(out[..., i:w - size + 1 + i], alpha=taps[i])
    return out2


def _ssim_cs_means(r, d, peak, k1, k2):
    """(mean contrast·structure, mean full SSIM) per plane of f32 [..., H, W]
    pairs — the per-scale components of MS-SSIM (Wang/Simoncelli/Bovik
    2003)."""
    kern = _gaussian_kernel()
    c1 = (k1 * peak) ** 2
    c2 = (k2 * peak) ** 2
    mu_r = _filter2_sep(r, kern)
    mu_d = _filter2_sep(d, kern)
    mu_rr = mu_r * mu_r
    mu_dd = mu_d * mu_d
    mu_rd = mu_r * mu_d
    del mu_r, mu_d
    var_r = _filter2_sep(r * r, kern).sub_(mu_rr)
    var_d = _filter2_sep(d * d, kern).sub_(mu_dd)
    cov = _filter2_sep(r * d, kern).sub_(mu_rd)
    cs = (2.0 * cov + c2) / (var_r + var_d + c2)
    del var_r, var_d, cov
    lum = (2.0 * mu_rd + c1) / (mu_rr + mu_dd + c1)
    return torch.mean(cs, dim=(-2, -1)), torch.mean(lum * cs, dim=(-2, -1))


def ssim_frames(
    ref: torch.Tensor,
    deg: torch.Tensor,
    peak: float = 255.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM per plane of [..., H, W] pairs (Wang et al. 2004: 11x11
    Gaussian window, sigma 1.5, valid borders)."""
    return _ssim_cs_means(_f32(ref), _f32(deg), peak, k1, k2)[1]


def ssim_frame(ref: torch.Tensor, deg: torch.Tensor, peak: float = 255.0,
               k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM of one [H, W] plane pair (a 0-d tensor)."""
    return ssim_frames(ref, deg, peak, k1, k2)


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average downsample (MS-SSIM's dyadic pyramid step); odd tails
    are dropped, matching the original implementation's lpf+decimate."""
    h, w = x.shape[-2], x.shape[-1]
    x = x[..., : h - h % 2, : w - w % 2]
    return (x[..., 0::2, 0::2] + x[..., 1::2, 0::2] + x[..., 0::2, 1::2]
            + x[..., 1::2, 1::2]) / 4.0


#: Wang/Simoncelli/Bovik 2003 scale exponents
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


MSSSIM_MIN_SIDE = 11 * 2 ** (len(_MSSSIM_WEIGHTS) - 1)  # 176


def _msssim_pair(ref, deg, peak, k1, k2):
    """(MS-SSIM, scale-1 full SSIM) per plane of [..., H, W] pairs. The
    scale-1 full value is plain SSIM, returned so that callers wanting both
    filter the full-resolution planes once."""
    h, w = ref.shape[-2], ref.shape[-1]
    if min(h, w) < MSSSIM_MIN_SIDE:
        raise ValueError(
            f"MS-SSIM needs frames >= {MSSSIM_MIN_SIDE} px per side for "
            f"the {len(_MSSSIM_WEIGHTS)}-scale pyramid; got {h}x{w}"
        )
    r = _f32(ref)
    d = _f32(deg)
    out = torch.ones(ref.shape[:-2], dtype=torch.float32, device=ref.device)
    ssim1 = None
    n = len(_MSSSIM_WEIGHTS)
    for i, wgt in enumerate(_MSSSIM_WEIGHTS):
        cs, full = _ssim_cs_means(r, d, peak, k1, k2)
        if i == 0:
            ssim1 = full
        val = full if i == n - 1 else cs
        # negative cs (anticorrelated structure) would NaN the fractional
        # power; clamp like the common public implementations
        out = out * torch.clamp(val, min=1e-6) ** wgt
        if i != n - 1:
            r = _avgpool2(r)
            d = _avgpool2(d)
    return out, ssim1


def msssim_frames(ref: torch.Tensor, deg: torch.Tensor, peak: float = 255.0,
                  k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Multi-scale SSIM per plane of [..., H, W] pairs (Wang/Simoncelli/
    Bovik 2003): contrast·structure at 5 dyadic scales, luminance only at
    the coarsest, combined as Π cs_j^w_j · (l·cs)_5^w_5. Raises ValueError
    under MSSSIM_MIN_SIDE (176) px per side."""
    return _msssim_pair(ref, deg, peak, k1, k2)[0]


def msssim_frame(ref: torch.Tensor, deg: torch.Tensor, peak: float = 255.0,
                 k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Multi-scale SSIM of one [H, W] plane pair (a 0-d tensor)."""
    return msssim_frames(ref, deg, peak, k1, k2)


def msssim_ssim_frames(ref: torch.Tensor, deg: torch.Tensor):
    """(MS-SSIM, SSIM) per plane of [..., H, W] pairs in one pass."""
    return _msssim_pair(ref, deg, 255.0, 0.01, 0.03)


#: pixel-domain VIF window sizes per scale (sd = N/5, Sheikh & Bovik 2006)
_VIF_WINDOWS = (17, 9, 5, 3)


@functools.lru_cache(maxsize=1)
def _vif_windows() -> tuple:
    """Normalized 1-D Gaussian windows per VIF scale (N = 17/9/5/3,
    sd = N/5 — the pixel-domain VIF constants, VMAF's vif feature)."""
    return tuple(_gaussian_kernel(n, n / 5.0) for n in _VIF_WINDOWS)


def vif_frames(ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Pixel-domain VIF (vifp, 4 scales) per plane of [..., H, W] luma
    pairs on the 8-bit scale. Planes must be >= 41 px per side (valid
    filters and a decimation by 2 at each scale). The variances are
    clamped at 0 and the reference implementation's edge fixes (vifp_mscale)
    applied before the log terms."""
    sigma_nsq = 2.0
    eps = 1e-10
    r = _f32(ref)
    d = _f32(deg)
    num = torch.zeros(ref.shape[:-2], dtype=torch.float32, device=ref.device)
    den = torch.zeros_like(num)
    for scale, w in enumerate(_vif_windows(), start=1):
        if scale > 1:
            r = _filter2_sep(r, w)[..., ::2, ::2]
            d = _filter2_sep(d, w)[..., ::2, ::2]
        mu1 = _filter2_sep(r, w)
        mu2 = _filter2_sep(d, w)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        del mu1, mu2
        sigma1_sq = torch.clamp(_filter2_sep(r * r, w) - mu1_sq, min=0.0)
        sigma2_sq = torch.clamp(_filter2_sep(d * d, w) - mu2_sq, min=0.0)
        sigma12 = _filter2_sep(r * d, w) - mu1_mu2
        del mu1_sq, mu2_sq, mu1_mu2

        g = sigma12 / (sigma1_sq + eps)
        sv_sq = sigma2_sq - g * sigma12
        del sigma12
        # the reference implementation's edge fixes (vifp_mscale)
        low1 = sigma1_sq < eps
        g = torch.where(low1, 0.0, g)
        sv_sq = torch.where(low1, sigma2_sq, sv_sq)
        sigma1_sq = torch.where(low1, 0.0, sigma1_sq)
        low2 = sigma2_sq < eps
        g = torch.where(low2, 0.0, g)
        sv_sq = torch.where(low2, 0.0, sv_sq)
        sv_sq = torch.where(g < 0.0, sigma2_sq, sv_sq)
        del low1, low2, sigma2_sq
        g = torch.clamp(g, min=0.0)
        sv_sq = torch.clamp(sv_sq, min=eps)

        num = num + torch.sum(
            torch.log10(1.0 + g * g * sigma1_sq / (sv_sq + sigma_nsq)), dim=(-2, -1))
        den = den + torch.sum(torch.log10(1.0 + sigma1_sq / sigma_nsq), dim=(-2, -1))
        del g, sv_sq, sigma1_sq
    return num / torch.clamp(den, min=eps)
