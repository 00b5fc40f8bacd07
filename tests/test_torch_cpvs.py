"""The device half of p04 in the port (ops/pad, ops/pixfmt,
models/cpvs, config/domain.PostProcessing) against the JAX package on the
CPU, on the same seeded planes.

Every output must be identical. The reference route follows the port's
resize route: a transform whose only resize is a u8 bicubic (the mobile
scale, also after a 10-bit depth conversion) takes swscale's integer
pipeline in the port and is compared with the JAX default route, the
golden one; a transform with a resize outside that envelope (u8 bilinear
420→422, any u16 resize) takes the TPU kernel's f32 arithmetic in the
port and is compared with the JAX package run with
PC_RESIZE_METHOD=fused, its Pallas kernel in interpret mode."""

from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from processing_chain_tpu.config.domain import PostProcessing as JPostProcessing
from processing_chain_tpu.config.domain import Pvs as JPvs
from processing_chain_tpu.models import cpvs as jcp
from processing_chain_tpu.ops import pad as jpad
from processing_chain_tpu.ops import pixfmt as jpf
from processing_chain_tpu_torch.config.domain import ConfigError, PostProcessing
from processing_chain_tpu_torch.models import cpvs as tcp
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.ops import pad as tpad
from processing_chain_tpu_torch.ops import pixfmt as tpf

AV_H, AV_W = 72, 128  # the AVPVS canvas of these tests


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(ours, ref):
    ref = np.asarray(ref)
    ours = ours.numpy()
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert np.array_equal(ours, ref)


def _planes(rng, t, pix_fmt, h=AV_H, w=AV_W):
    hi, dtype = (1023, np.uint16) if "10" in pix_fmt else (255, np.uint8)
    sub_h = 2 if "420" in pix_fmt else 1
    return [rng.integers(0, hi + 1, s).astype(dtype)
            for s in ((t, h, w), (t, h // sub_h, w // 2), (t, h // sub_h, w // 2))]


# ----------------------------------------------------------------------- pad


@pytest.mark.parametrize("dtype,fill", [(np.uint8, 16.0), (np.uint16, 64.0), (np.float32, 16.0)])
@pytest.mark.parametrize("dst", [(16, 32), (13, 27), (10, 20)])
def test_pad_center_identical(dtype, fill, dst):
    p = np.random.default_rng(1).integers(0, 200, (2, 10, 20)).astype(dtype)
    _same(tpad.pad_center(_t(p), *dst, fill=fill), jpad.pad_center(p, *dst, fill=fill))


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv422p", "yuv444p"])
def test_pad_yuv_identical(pix_fmt):
    rng = np.random.default_rng(2)
    sub_h = 2 if "420" in pix_fmt else 1
    sub_w = 1 if "444" in pix_fmt else 2
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((3, 10, 20), (3, 10 // sub_h, 20 // sub_w), (3, 10 // sub_h, 20 // sub_w))]
    ours = tpad.pad_yuv(tuple(_t(p) for p in planes), 16, 32, pix_fmt)
    ref = jpad.pad_yuv(tuple(planes), 16, 32, pix_fmt)
    for a, b in zip(ours, ref):
        _same(a, b)


# -------------------------------------------------------------------- pixfmt


def test_depth_conversions_identical():
    x8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _same(tpf.depth_8_to_10(_t(x8)), jpf.depth_8_to_10(x8))
    x10 = np.arange(1024, dtype=np.uint16).reshape(32, 32)
    _same(tpf.depth_10_to_8(_t(x10)), jpf.depth_10_to_8(x10))
    _same(tpf.depth_10_to_8(tpf.depth_8_to_10(_t(x8))), x8)


def test_pack_uyvy422_identical():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, (3, 6, 8)).astype(np.uint8)
    u = rng.integers(0, 256, (3, 6, 4)).astype(np.uint8)
    v = rng.integers(0, 256, (3, 6, 4)).astype(np.uint8)
    ours = tpf.pack_uyvy422(_t(y), _t(u), _t(v))
    _same(ours, jpf.pack_uyvy422(y, u, v))
    assert list(ours[0, 0, :4].numpy()) == [u[0, 0, 0], y[0, 0, 0], v[0, 0, 0], y[0, 0, 1]]


@pytest.mark.parametrize("ten_bit", [False, True])
def test_float_plane_conversions_identical(ten_bit):
    rng = np.random.default_rng(4)
    planes = tuple(rng.integers(0, 1024 if ten_bit else 256, (2, 6, 8)).astype(
        np.uint16 if ten_bit else np.uint8) for _ in range(3))
    fl = tpf.planes_to_float(tuple(_t(p) for p in planes), ten_bit)
    for a, b in zip(fl, jpf.planes_to_float(planes, ten_bit)):
        _same(a, b)
    noisy = tuple(f + 0.37 for f in fl)
    for a, b in zip(tpf.float_to_planes(noisy, ten_bit),
                    jpf.float_to_planes(tuple(f.numpy() for f in noisy), ten_bit)):
        _same(a, b)


@pytest.fixture
def jax_fused_resize(monkeypatch):
    """The JAX resize on its Pallas kernel (interpret mode on the CPU)."""
    monkeypatch.setenv("PC_RESIZE_METHOD", "fused")


@pytest.mark.parametrize("dtype,hi", [(np.uint8, 255), (np.uint16, 1023)])
def test_chroma_resamples_identical(jax_fused_resize, dtype, hi):
    rng = np.random.default_rng(5)
    u = rng.integers(0, hi + 1, (3, 18, 32)).astype(dtype)
    v = rng.integers(0, hi + 1, (3, 18, 32)).astype(dtype)
    tk.reset_launches()
    for ours, ref in (
        (tpf.chroma_420_to_422(_t(u), _t(v)), jpf.chroma_420_to_422(u, v)),
        (tpf.chroma_422_to_420(_t(u), _t(v)), jpf.chroma_422_to_420(u, v)),
        (tpf.chroma_to_444(_t(u), _t(v), 36, 64), jpf.chroma_to_444(u, v, 36, 64)),
    ):
        for a, b in zip(ours, ref):
            _same(a, b)
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}


# ------------------------------------------------------------- config domain


def test_post_processing_matches_jax_and_validates():
    good = {"type": "pc", "displayWidth": 3840, "displayHeight": 2160,
            "codingWidth": 3840, "codingHeight": 2160, "displayFrameRate": 30}
    ours, ref = PostProcessing(good), JPostProcessing(None, good)
    for f in ("processing_type", "display_width", "display_height", "coding_width",
              "coding_height", "display_frame_rate"):
        assert getattr(ours, f) == getattr(ref, f)
    assert repr(ours) == repr(ref) == "<PostProcessing PC>"
    assert PostProcessing({**good, "type": "mobile", "displayFrameRate": None}
                          ).display_frame_rate is None
    assert PostProcessing({k: v for k, v in good.items() if k != "displayFrameRate"}
                          ).display_frame_rate == 60
    for bad, match in (({**good, "type": "tv"}, "Wrong post processing type"),
                       ({**good, "codingWidth": 1920}, "same coding and display width"),
                       ({**good, "codingHeight": 1080}, "PC post processing"),
                       ({**good, "displayHeight": "tall"}, "Missing or wrong data")):
        with pytest.raises(ConfigError, match=match):
            PostProcessing(bad)
        with pytest.raises(Exception, match=match):
            JPostProcessing(None, bad)
    assert issubclass(ConfigError, ValueError)


# ------------------------------------------------------------------ host math


def test_t_cap_frames_matches_jax():
    ntsc = Fraction(30000, 1001)
    for t, rate in ((60.0, ntsc), (60.0, Fraction(60)), (10.0, Fraction(24)),
                    (1.0, ntsc), (0.1 + 0.2, Fraction(10)), (sum([1.1] * 2), Fraction(25))):
        assert tcp.t_cap_frames(t, rate) == jcp.t_cap_frames(t, rate)
    assert tcp.t_cap_frames(60.0, ntsc) == 1799
    assert tcp.t_cap_frames(0.1 + 0.2, Fraction(10)) == 3


def test_cpvs_out_rate_and_limit_frames_match_jax():
    for plan, fps in (({"fps": 30.0}, 60.0), ({"fps": None}, 59.94), ({"fps": 29.97}, 60.0)):
        assert tcp.cpvs_out_rate(plan, fps) == jcp.cpvs_out_rate(plan, fps)
    chunks = [[_t(np.full((4, 2, 2), k, np.uint8))] * 3 for k in range(5)]
    for cap in (0, 3, 10, 99):
        ours = list(tcp._limit_frames(iter(chunks), cap))
        ref = list(jcp._limit_frames(iter([[c.numpy() for c in ch] for ch in chunks]), cap))
        assert [c[0].shape[0] for c in ours] == [c[0].shape[0] for c in ref]


def test_normalize_rms_matches_jax():
    x = np.random.default_rng(6).integers(-9000, 9000, (48000, 2)).astype(np.int16)
    for target in (-23.0, -14.0):
        assert np.array_equal(tcp.normalize_rms(x, target), jcp.normalize_rms(x, target))
    empty = np.zeros((0, 2), np.int16)
    assert tcp.normalize_rms(empty).size == 0
    assert np.array_equal(tcp.normalize_rms(np.zeros((8, 2), np.int16)), np.zeros((8, 2)))


# ------------------------------------------------------------------ transforms


def jax_plan(pp_data, pix_fmt, rawvideo, avpvs_h=AV_H):
    """The JAX `cpvs_plan` for a short test, on a stand-in PVS that
    answers the three questions the planner asks."""
    pvs = SimpleNamespace(
        test_config=SimpleNamespace(is_long=lambda: False),
        get_pix_fmt_for_avpvs=lambda: pix_fmt,
        _CPVS_FORMAT_MAP=JPvs._CPVS_FORMAT_MAP,
    )
    pvs.get_vcodec_and_pix_fmt_for_cpvs = (
        lambda raw=False: JPvs.get_vcodec_and_pix_fmt_for_cpvs(pvs, raw))
    pp = JPostProcessing(None, pp_data)
    return jcp.cpvs_plan(pvs, pp, avpvs_h, rawvideo=rawvideo), pp


PC = {"type": "pc", "displayWidth": AV_W, "displayHeight": AV_H,
      "codingWidth": AV_W, "codingHeight": AV_H, "displayFrameRate": 30}
PC_PAD = {**PC, "displayWidth": 160, "displayHeight": 96, "codingWidth": 160,
          "codingHeight": 96}
MOBILE_SCALE = {"type": "mobile", "displayWidth": 64, "displayHeight": 36,
                "codingWidth": 64, "codingHeight": 36}
MOBILE_PAD = {"type": "tablet", "displayWidth": AV_W, "displayHeight": 96,
              "codingWidth": AV_W, "codingHeight": 80}

# (name, post-processing, rawvideo, pix_fmts the JAX function allows)
CONTEXTS = [
    ("pc_rawvideo", PC, True, ("yuv420p", "yuv420p10le")),
    ("pc_rawvideo_pad", PC_PAD, True, ("yuv420p", "yuv420p10le")),
    ("pc_uyvy", PC, False, ("yuv420p", "yuv422p")),
    ("pc_uyvy_pad", PC_PAD, False, ("yuv420p",)),
    ("pc_v210", PC, False, ("yuv420p10le", "yuv422p10le")),
    ("pc_v210_pad", PC_PAD, False, ("yuv420p10le",)),
    ("mobile_scale", MOBILE_SCALE, False, ("yuv420p", "yuv420p10le")),
    ("mobile_pad", MOBILE_PAD, False, ("yuv420p", "yuv420p10le")),
]
CASES = [(name, pp, raw, fmt) for name, pp, raw, fmts in CONTEXTS for fmt in fmts]


@pytest.mark.parametrize("name,pp_data,rawvideo,pix_fmt", CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_cpvs_transform_identical(monkeypatch, name, pp_data, rawvideo, pix_fmt):
    plan, jpp = jax_plan(pp_data, pix_fmt, rawvideo)
    if name.startswith("pc") and not rawvideo and "420" in pix_fmt:
        monkeypatch.setenv("PC_RESIZE_METHOD", "fused")  # the u8/u16 bilinear 420->422
    rng = np.random.default_rng(len(name) * 31 + len(pix_fmt))
    planes = _planes(rng, 5, pix_fmt)
    ref = jcp.make_cpvs_transform(plan, jpp, pix_fmt, rawvideo)(planes)
    tk.reset_launches()
    ours = tcp.make_cpvs_transform(plan, PostProcessing(pp_data), pix_fmt, rawvideo)(
        [_t(p) for p in planes])
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}
    assert len(ours) == len(ref) == (1 if name.startswith("pc_uyvy") else 3)
    for a, b in zip(ours, ref):
        _same(a, b)
    if name == "pc_uyvy":
        assert tuple(ours[0].shape) == (5, AV_H, 2 * AV_W)
    if name == "mobile_scale":
        assert tuple(ours[0].shape) == (5, 36, 64) and ours[0].dtype == torch.uint8


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le", "yuv422p", "yuv422p10le"])
def test_preview_transform_identical(jax_fused_resize, pix_fmt):
    planes = _planes(np.random.default_rng(len(pix_fmt)), 4, pix_fmt)
    ref = jcp.make_preview_transform(pix_fmt)(planes)
    ours = tcp.make_preview_transform(pix_fmt)([_t(p) for p in planes])
    for a, b in zip(ours, ref):
        assert a.dtype == torch.uint16
        _same(a, b)
    assert tuple(ours[1].shape) == (4, AV_H, AV_W // 2)
