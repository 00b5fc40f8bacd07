"""Port parity: the device half of p01 (processing_chain_tpu_torch/models/
segments.py) against the JAX package's `encode_segment.run` body
(ops/fps.stream_select → models/frames.scale_yuv_frames(bicubic) →
to_uint8), on the CPU, on the same seeded chunks.

u8 bicubic is the golden swscale path in both packages: identical. A u16
source takes the TPU kernel's f32 arithmetic in the port; it is compared
with the JAX package run with PC_RESIZE_METHOD=fused (its Pallas kernel
in interpret mode): identical too."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from processing_chain_tpu.models import frames as jfr
from processing_chain_tpu.models import segments as jseg
from processing_chain_tpu.ops import fps as jfps
from processing_chain_tpu_torch.config.domain import ConfigError
from processing_chain_tpu_torch.models import segments as tseg
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.ops import fps as tfps


def _clip(n, h, w, hi, seed, chunk=16):
    """Host chunks of a seeded noisy gradient (yuv420p planes)."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if hi == 255 else np.uint16
    planes = []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        grad = (np.arange(pw)[None, None, :] * 3 + np.arange(ph)[None, :, None] * 2
                + np.arange(n)[:, None, None] * 5) % (hi - 40)
        planes.append((grad + rng.integers(0, 41, (n, ph, pw))).astype(dtype))
    return [[p[i:i + chunk] for p in planes] for i in range(0, n, chunk)]


def _jax_segment(chunks, src_fps, target_fps, th, tw, pix_fmt):
    stream = iter(chunks)
    if target_fps is not None and target_fps != src_fps:
        stream = jfps.stream_select(stream, src_fps, target_fps)
    sub = jfr.chroma_subsampling(pix_fmt)
    ten_bit = "10" in pix_fmt
    return [jfr.to_uint8(jfr.scale_yuv_frames(c, th, tw, "bicubic", sub), ten_bit)
            for c in stream]


def _fake_segment(h, w, src_fps, width, fps_spec):
    src = SimpleNamespace(get_fps=lambda: src_fps, stream_info={"height": h, "width": w})
    return SimpleNamespace(src=src, quality_level=SimpleNamespace(width=width, fps=fps_spec))


@pytest.mark.parametrize("h,w,src_fps,width,spec", [
    (2160, 3840, 60.0, 1920, "1/2"), (2160, 3840, 60.0, 640, 24), (2160, 3840, 60.0, 320, 15),
    (1080, 1920, 60.0, 1280, 30), (1080, 1920, 25.0, 960, "original"), (720, 1280, 50.0, 426, 15),
    (1080, 1440, 24.0, 1280, "24/25/30"),
])
def test_plan_segment_frames_equals_reference(h, w, src_fps, width, spec):
    assert tseg.plan_segment_frames(h, w, src_fps, width, spec) == \
        jseg.plan_segment_frames(_fake_segment(h, w, src_fps, width, spec))


# (source h, w, fps), (width, target fps): 2x, 4x and 1.5x downscales
# (resize_stream and resize_ring geometries on the card), two drop tables
LEVELS = [
    ((120, 160, 60.0), (80, 30.0)),
    ((120, 160, 60.0), (40, 24.0)),
    ((120, 160, 60.0), (40, 15.0)),
    ((120, 160, 60.0), (106, 60.0)),
    ((96, 128, 30.0), (64, 24.0)),
]


@pytest.mark.parametrize("src,level", LEVELS)
def test_u8_ladder_identical_to_golden_path(src, level):
    (h, w, src_fps), (width, fps) = src, level
    chunks = _clip(40, h, w, 255, h + width)
    th, tw, target_fps, _ = tseg.plan_segment_frames(h, w, src_fps, width, fps)
    want = _jax_segment(chunks, src_fps, target_fps, th, tw, "yuv420p")
    tk.reset_launches()
    got = list(tseg.scaled_chunks(iter(chunks), src_fps, target_fps, th, tw, "yuv420p",
                                  device="cpu"))
    assert len(got) == len(want) > 0
    for g, wnt in zip(got, want):
        for a, b in zip(g, wnt):
            assert isinstance(a, np.ndarray) and a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    kept = sum(c[0].shape[0] for c in got)
    assert kept == len(tfps.select_indices(40, src_fps, target_fps or src_fps))
    assert got[0][0].shape[1:] == (th, tw) and got[0][1].shape[1:] == (th // 2, tw // 2)
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}  # the CPU runs the plain version


@pytest.fixture
def jax_fused_resize(monkeypatch):
    """The JAX resize on its Pallas kernel (interpret mode on the CPU)."""
    monkeypatch.setenv("PC_RESIZE_METHOD", "fused")


@pytest.mark.parametrize("pix_fmt", ["yuv420p10le", "yuv420p"])
def test_ten_bit_source_identical_to_fused_reference(jax_fused_resize, pix_fmt):
    """A 10-bit source at a 10-bit target, and at an 8-bit one, where the
    reference clips each sample at 255 without rescaling (to_uint8); the
    port keeps that behaviour."""
    chunks = _clip(24, 64, 96, 1023, 5, chunk=8)
    th, tw, target_fps, _ = tseg.plan_segment_frames(64, 96, 60.0, 48, 30)
    want = _jax_segment(chunks, 60.0, target_fps, th, tw, pix_fmt)
    got = list(tseg.scaled_chunks(iter(chunks), 60.0, target_fps, th, tw, pix_fmt,
                                  device="cpu"))
    assert len(got) == len(want) == 3
    dtype = np.uint16 if "10" in pix_fmt else np.uint8
    for g, wnt in zip(got, want):
        for a, b in zip(g, wnt):
            assert a.dtype == dtype
            np.testing.assert_array_equal(a, b)
    if dtype == np.uint8:
        assert got[0][0].max() == 255  # clipped, as the reference does


def test_tensor_chunks_take_the_same_path():
    chunks = _clip(20, 60, 80, 255, 9, chunk=8)
    as_tensors = [[torch.from_numpy(p) for p in c] for c in chunks]
    a = list(tseg.scaled_chunks(iter(chunks), 60.0, 30.0, 30, 40, "yuv420p", device="cpu"))
    b = list(tseg.scaled_chunks(iter(as_tensors), 60.0, 30.0, 30, 40, "yuv420p", device="cpu"))
    for x, y in zip(a, b):
        for p, q in zip(x, y):
            np.testing.assert_array_equal(p, q)


def test_drop_table_checked_before_the_first_chunk():
    def never():
        raise AssertionError("a chunk was pulled before the table check")
        yield

    with pytest.raises(ConfigError, match="not supported"):
        tseg.scaled_chunks(never(), 60.0, 45.0, 30, 40, "yuv420p", device="cpu")


def test_no_frames_raises():
    with pytest.raises(RuntimeError, match="no frames"):
        list(tseg.scaled_chunks(iter([]), 60.0, 30.0, 30, 40, "yuv420p", device="cpu"))
    one = _clip(1, 60, 80, 255, 3)  # frame 0 kept by 60 -> 15, so one frame out
    assert sum(c[0].shape[0] for c in
               tseg.scaled_chunks(iter(one), 60.0, 15.0, 30, 40, "yuv420p", device="cpu")) == 1
