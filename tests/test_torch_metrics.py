"""Port parity: processing_chain_tpu_torch/ops/metrics.py (PSNR, SSIM,
MS-SSIM, VIF) and parallel/pipeline.make_batch_metrics_step against the
JAX package (ops/metrics.py, tools/quality_metrics._vif_frames,
parallel/pipeline.make_batch_metrics_step) on the CPU, with independent
float64 numpy implementations as a second witness.

Tolerances: both packages compute in f32 and may sum in another order, so
PSNR agrees within 1e-4 dB and SSIM, MS-SSIM and VIF within 2e-5
absolute; against the f64 numpy references MS-SSIM within 2e-4 and VIF
within 2e-4 relative (the JAX tests' own bounds). PSNR of identical planes
is exactly 100.0 in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import convolve1d

from processing_chain_tpu.ops import metrics as jm
from processing_chain_tpu.parallel import make_batch_metrics_step as j_batch_step
from processing_chain_tpu.parallel import make_mesh as j_make_mesh
from processing_chain_tpu.tools import quality_metrics as jqm
from processing_chain_tpu_torch.ops import metrics as tm
from processing_chain_tpu_torch.parallel import mesh as tmesh
from processing_chain_tpu_torch.parallel import pipeline as tpipe

PSNR_ATOL = 1e-4
STAT_ATOL = 2e-5


def _pair(t, h, w, sigma, seed):
    """A smooth seeded reference and a noisy copy, f32 on the 8-bit scale."""
    rng = np.random.default_rng(seed)
    base = rng.integers(16, 235, size=(t, h, w)).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3.0
    deg = base + rng.normal(0, sigma, base.shape).astype(np.float32)
    return base.astype(np.float32), deg.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_gaussian_window_filter_and_pool_equal_jax():
    for size, sigma in ((11, 1.5), (17, 3.4), (9, 1.8), (5, 1.0), (3, 0.6)):
        np.testing.assert_allclose(tm._gaussian_kernel(size, sigma).numpy(),
                                   np.asarray(jm._gaussian_kernel(size, sigma)), rtol=1e-6)
    ref, _ = _pair(1, 40, 52, 1.0, 2)
    k = tm._gaussian_kernel()
    got = tm._filter2_sep(_t(ref[0]), k).numpy()
    want = np.asarray(jm._filter2_sep(jnp.asarray(ref[0]), jm._gaussian_kernel()))
    assert got.shape == want.shape == (30, 42)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm._avgpool2(_t(ref[0, :39, :51])).numpy(),
                               np.asarray(jm._avgpool2(jnp.asarray(ref[0, :39, :51]))),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("sigma", [0.0, 2.0, 12.0])
def test_psnr_and_ssim_against_jax(sigma):
    ref, deg = _pair(4, 72, 128, sigma, 11)
    p = tm.psnr_frames(_t(ref), _t(deg)).numpy()
    s = tm.ssim_frames(_t(ref), _t(deg)).numpy()
    np.testing.assert_allclose(p, np.asarray(jm.psnr_frames(ref, deg)), rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(s, np.asarray(jm.ssim_frames(ref, deg)), rtol=0, atol=STAT_ATOL)
    if sigma == 0.0:
        assert (p == 100.0).all()
    single = [float(tm.psnr_frame(_t(r), _t(d))) for r, d in zip(ref, deg)]
    np.testing.assert_allclose(single, p, rtol=0, atol=PSNR_ATOL)
    assert float(tm.ssim_frame(_t(ref[0]), _t(deg[0]))) == pytest.approx(float(s[0]), abs=1e-6)


def test_metrics_batched_integer_planes():
    """tests/test_ops.py test_metrics_batched, on the port: integer planes
    are lifted to f32; an identical pair caps at exactly 100 dB."""
    xx, yy = np.meshgrid(np.arange(128), np.arange(72))
    img = ((np.sin(xx / 37) + np.cos(yy / 23)) * 55 + 128).astype(np.uint8)
    ref = np.stack([img] * 3)
    deg = ref.copy()
    deg[1] = np.clip(deg[1].astype(int) + 10, 0, 255).astype(np.uint8)
    p = tm.psnr_frames(_t(ref), _t(deg)).numpy()
    s = tm.ssim_frames(_t(ref), _t(deg)).numpy()
    assert p.shape == (3,) and s.shape == (3,)
    assert p[0] == 100.0 and p[1] < 30.0 and s[1] < s[0]
    np.testing.assert_allclose(p, np.asarray(jm.psnr_frames(ref, deg)), rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(s, np.asarray(jm.ssim_frames(ref, deg)), rtol=0, atol=STAT_ATOL)


def _np_msssim(ref, deg, peak=255.0, k1=0.01, k2=0.03):
    """Wang/Simoncelli/Bovik 2003 in float64 numpy (the witness of
    tests/test_ops.py test_msssim_against_numpy_reference)."""
    g = np.exp(-((np.arange(11) - 5.0) ** 2) / (2 * 1.5 ** 2))
    g /= g.sum()
    c1, c2 = (k1 * peak) ** 2, (k2 * peak) ** 2

    def filt(x):
        y = convolve1d(x, g, axis=0)[5:-5]
        return convolve1d(y, g, axis=1)[:, 5:-5]

    def cs_l(r, d):
        mr, md = filt(r), filt(d)
        vr = filt(r * r) - mr * mr
        vd = filt(d * d) - md * md
        cov = filt(r * d) - mr * md
        cs = (2 * cov + c2) / (vr + vd + c2)
        lum = (2 * mr * md + c1) / (mr * mr + md * md + c1)
        return cs.mean(), (lum * cs).mean()

    def pool(x):
        h, w = x.shape
        x = x[: h - h % 2, : w - w % 2]
        return (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2]) / 4.0

    weights = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
    r, d = ref.astype(np.float64), deg.astype(np.float64)
    out = 1.0
    for i, w in enumerate(weights):
        cs, full = cs_l(r, d)
        out *= max(full if i == 4 else cs, 1e-6) ** w
        if i != 4:
            r, d = pool(r), pool(d)
    return out


def test_msssim_against_jax_and_numpy():
    ref, deg = _pair(2, 180, 200, 8.0, 5)
    ms, s1 = tm.msssim_ssim_frames(_t(ref), _t(deg))
    jms, js1 = jm.msssim_ssim_frames(jnp.asarray(ref), jnp.asarray(deg))
    np.testing.assert_allclose(ms.numpy(), np.asarray(jms), rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(s1.numpy(), tm.ssim_frames(_t(ref), _t(deg)).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.msssim_frames(_t(ref), _t(deg)).numpy(), ms.numpy(),
                               rtol=0, atol=1e-6)
    for k in range(2):
        assert float(ms[k]) == pytest.approx(_np_msssim(ref[k], deg[k]), abs=2e-4)
    assert float(tm.msssim_frame(_t(ref[0]), _t(ref[0]))) == pytest.approx(1.0, abs=1e-5)


def test_msssim_refuses_small_frames_as_jax():
    ref, deg = _pair(1, 175, 200, 1.0, 1)
    with pytest.raises(ValueError, match="176"):
        tm.msssim_frames(_t(ref), _t(deg))
    with pytest.raises(ValueError, match="176"):
        jm.msssim_frame(ref[0], deg[0])
    assert tm.MSSSIM_MIN_SIDE == jm.MSSSIM_MIN_SIDE == 176


def _np_vifp(ref, deg):
    """Pixel-domain multi-scale VIF in float64 numpy (the witness of
    tests/test_tools.py test_vif_against_numpy_reference)."""
    def gauss2d(n, sd):
        x = np.arange(n) - (n - 1) / 2.0
        g = np.exp(-(x * x) / (2.0 * sd * sd))
        k = np.outer(g, g)
        return k / k.sum()

    def filter2_valid(img, k):
        kh, kw = k.shape
        h, w = img.shape
        out = np.zeros((h - kh + 1, w - kw + 1))
        for i in range(kh):
            for j in range(kw):
                out += k[i, j] * img[i: i + h - kh + 1, j: j + w - kw + 1]
        return out

    sigma_nsq, eps = 2.0, 1e-10
    num = den = 0.0
    r, d = ref.astype(np.float64), deg.astype(np.float64)
    for scale in range(1, 5):
        n = 2 ** (4 - scale + 1) + 1
        win = gauss2d(n, n / 5.0)
        if scale > 1:
            r = filter2_valid(r, win)[::2, ::2]
            d = filter2_valid(d, win)[::2, ::2]
        mu1, mu2 = filter2_valid(r, win), filter2_valid(d, win)
        s1 = np.maximum(filter2_valid(r * r, win) - mu1 * mu1, 0)
        s2 = np.maximum(filter2_valid(d * d, win) - mu2 * mu2, 0)
        s12 = filter2_valid(r * d, win) - mu1 * mu2
        g = s12 / (s1 + eps)
        sv = s2 - g * s12
        g[s1 < eps] = 0
        sv[s1 < eps] = s2[s1 < eps]
        s1 = np.where(s1 < eps, 0, s1)
        g[s2 < eps] = 0
        sv[s2 < eps] = 0
        sv[g < 0] = s2[g < 0]
        g = np.maximum(g, 0)
        sv = np.maximum(sv, eps)
        num += np.sum(np.log10(1 + g * g * s1 / (sv + sigma_nsq)))
        den += np.sum(np.log10(1 + s1 / sigma_nsq))
    return num / den


def test_vif_against_jax_and_numpy():
    rng = np.random.default_rng(9)
    base = rng.integers(16, 235, size=(64, 80)).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3.0
    noisy1 = base + rng.normal(0, 4.0, base.shape).astype(np.float32)
    noisy2 = base + rng.normal(0, 12.0, base.shape).astype(np.float32)
    flat = np.full_like(base, 77.0)  # zero variance: the edge fixes decide
    ref = np.stack([base, base, base, base, flat]).astype(np.float32)
    deg = np.stack([base, noisy1, noisy2, flat, flat]).astype(np.float32)
    got = tm.vif_frames(_t(ref), _t(deg)).numpy()
    want = np.asarray(jqm._vif_frames(jnp.asarray(ref), jnp.asarray(deg)))
    np.testing.assert_allclose(got, want, rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(got[:3], [_np_vifp(base, base),
                                         _np_vifp(base, noisy1), _np_vifp(base, noisy2)],
                               rtol=2e-4)
    assert got[0] > 0.999 and got[2] < got[1] < got[0]
    assert np.isfinite(got).all()


def test_batch_metrics_step_against_jax_on_one_device():
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 255, size=(2, 3, 36, 64), dtype=np.uint8)
    deg = np.clip(ref.astype(int) + rng.integers(-9, 10, ref.shape), 0, 255).astype(np.uint8)
    deg[0, 1] = ref[0, 1]
    step = tpipe.make_batch_metrics_step(tmesh.make_mesh(["cpu"]))
    psnr, ssim = step(_t(ref), _t(deg))
    jstep = j_batch_step(j_make_mesh([jax.devices()[0]]))
    jpsnr, jssim = jstep(jnp.asarray(ref), jnp.asarray(deg))
    assert tuple(psnr.shape) == tuple(ssim.shape) == (2, 3)
    np.testing.assert_allclose(psnr.numpy(), np.asarray(jpsnr), rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(ssim.numpy(), np.asarray(jssim), rtol=0, atol=STAT_ATOL)
    assert float(psnr[0, 1]) == 100.0
    # a mesh of lanes that share the one device scores the same
    psnr4, ssim4 = tpipe.make_batch_metrics_step(tmesh.make_mesh(["cpu"] * 4))(_t(ref), _t(deg))
    assert torch.equal(psnr4, psnr) and torch.equal(ssim4, ssim)
