"""Port parity: processing_chain_tpu_torch/models/frames.py against the
JAX package's models/frames.py, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from processing_chain_tpu.models import frames as jf
from processing_chain_tpu_torch.models import frames as tf


def test_quantize_device_saturates_not_wraps():
    ten = torch.from_numpy(np.array([[300, 80]], np.uint16))
    out8 = tf.quantize_device([ten], ten_bit=False)[0]
    assert out8.dtype == torch.uint8
    assert out8[0].tolist() == [255, 80]  # saturate, not 300 % 256
    eight = torch.from_numpy(np.array([[200, 7]], np.uint8))
    out16 = tf.quantize_device([eight], ten_bit=True)[0]
    assert out16.dtype == torch.uint16
    assert out16[0].tolist() == [200, 7]
    flt = torch.from_numpy(np.array([[1500.0, -3.0, 99.5]], np.float32))
    out10 = tf.quantize_device([flt], ten_bit=True)[0]
    assert out10[0].tolist() == [1023, 0, 100]
    assert tf.quantize_device([eight])[0] is eight  # container depth passes through


def test_quantize_device_matches_jax():
    rng = np.random.default_rng(4)
    flt = (rng.random((3, 17)) * 1400 - 200).astype(np.float32)
    for ten_bit in (False, True):
        for arr in (flt, flt.clip(0, 1023).astype(np.uint16)):
            ours = tf.quantize_device([torch.from_numpy(arr)], ten_bit)[0].numpy()
            ref = np.asarray(jf.quantize_device([jnp.asarray(arr)], ten_bit)[0])
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv422p", "yuv444p", "yuv420p10le"])
def test_scale_yuv_frames_matches_jax(pix_fmt):
    """One resize call per plane; chroma on the pix_fmt's grid. u8 is
    identical to the JAX package (both golden swscale integers); 10-bit
    is within one code value (f32 arithmetic, other summation order)."""
    sub = tf.chroma_subsampling(pix_fmt)
    assert sub == jf.chroma_subsampling(pix_fmt)
    ten_bit = "10" in pix_fmt
    dtype, hi = (np.uint16, 1023) if ten_bit else (np.uint8, 255)
    rng = np.random.default_rng(8)
    h, w = 48, 80
    planes = [rng.integers(0, hi, (3, h, w)).astype(dtype)]
    planes += [rng.integers(0, hi, (3, h // sub[0], w // sub[1])).astype(dtype)
               for _ in range(2)]
    ours = tf.scale_yuv_frames([torch.from_numpy(p) for p in planes], 96, 160, "bicubic", sub)
    ref = jf.scale_yuv_frames([jnp.asarray(p) for p in planes], 96, 160, "bicubic", sub)
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if ten_bit:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src,post", [
    ((1920, 1080), (1920, 1080)), ((1920, 1080), (3840, 2160)),
    ((1920, 1080), (1280, 720)), ((1920, 1080), (640, 480)),
    ((1280, 720), (1920, 1200)), ((3840, 2160), (720, 1280)),
])
def test_canvas_helpers_match_jax(src, post):
    assert tf.calculate_avpvs_video_dimensions(*src, *post) == \
        jf.calculate_avpvs_video_dimensions(*src, *post)
    assert tf.scale_to_width_keep_ar(src[1], src[0], post[0]) == \
        jf.scale_to_width_keep_ar(src[1], src[0], post[0])


def test_to_uint8_matches_jax():
    arr = np.array([[-1.0, 0.5, 254.6, 300.0, 1022.5]], np.float32)
    for ten_bit in (False, True):
        ours = tf.to_uint8([torch.from_numpy(arr)], ten_bit)[0]
        ref = jf.to_uint8([jnp.asarray(arr)], ten_bit)[0]
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
