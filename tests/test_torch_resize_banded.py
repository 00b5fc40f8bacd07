"""Port parity: the `banded` resize route of processing_chain_tpu_torch/
ops/resize.py (the f32 route on the card) against the JAX package's
`method="banded"`, on the CPU, on the same seeded inputs.

Tolerances: the plan is array-equal (a host-side copy). Each axis and the
whole f32 route agree with JAX within 1e-3 absolute on the 0..255 scale
(f32 products of 14-bit weights; the two libraries may sum a band in
another order). A quantized u8 result is within one code value of JAX's
banded result and of the golden integer path, as
tests/test_ops.py test_resize_banded_matches_gather holds JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from processing_chain_tpu.ops import resize as jr
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.ops import resize as tr

F32_ATOL = 1e-3
AXES = ((270, 1080), (1080, 270), (1080, 1081), (7, 900), (1920, 3840), (2160, 1080),
        (3840, 320), (960, 1920), (45, 90))


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos", "bilinear"])
@pytest.mark.parametrize("src,dst", AXES)
def test_banded_plan_array_equal_and_band_covers_taps(kernel, src, dst):
    got = tr.make_banded_plan(src, dst, kernel)
    want = jr.make_banded_plan(src, dst, kernel)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[2] == want[2]
    idx, _ = tr.make_plan(src, dst, kernel)
    starts, weights, band = got
    block = weights.shape[1]
    for b in range(weights.shape[0]):
        i0, i1 = b * block, min((b + 1) * block, dst)
        assert idx[i0:i1].min() >= starts[b]
        assert idx[i0:i1].max() < starts[b] + band


def _noise(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape).astype(dtype)


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos"])
@pytest.mark.parametrize("src,dst", [(160, 320), (320, 107), (200, 200), (130, 257)])
def test_each_banded_axis_against_jax(kernel, src, dst):
    """The two axes separately, each on a batch with leading axes, so a
    wrong gather layout cannot hide behind the other axis."""
    x = _noise((2, 3, 5, src), src + dst)
    got = tr._banded_axis_last(torch.from_numpy(x), src, dst, kernel)
    want = np.asarray(jr._banded_axis_last(jnp.asarray(x), src, dst, kernel))
    assert tuple(got.shape) == want.shape == (2, 3, 5, dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
    x = _noise((2, 3, src, 7), src * dst)
    got = tr._banded_axis_rows(torch.from_numpy(x), src, dst, kernel)
    want = np.asarray(jr._banded_axis_rows(jnp.asarray(x), src, dst, kernel))
    assert tuple(got.shape) == want.shape == (2, 3, dst, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("kernel", ["bicubic", "lanczos"])
@pytest.mark.parametrize("dst", [(1080, 1920), (540, 960), (96, 128), (270, 480), (90, 160)])
def test_resize_plane_banded_against_jax(kernel, dst):
    dh, dw = dst
    x = _noise((3, 270, 480), 7)
    got = tr.resize_plane(torch.from_numpy(x), dh, dw, kernel, method="banded")
    want = np.asarray(jr.resize_plane(jnp.asarray(x), dh, dw, kernel, method="banded"))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
    x8 = x.astype(np.uint8)
    got8 = tr.resize_plane(torch.from_numpy(x8), dh, dw, kernel, method="banded")
    want8 = np.asarray(jr.resize_plane(jnp.asarray(x8), dh, dw, kernel, method="banded"))
    assert got8.dtype == torch.uint8
    assert np.abs(got8.numpy().astype(int) - want8.astype(int)).max() <= 1
    # within one code value of the golden integer path, as JAX's banded route
    golden = tr.resize_plane(torch.from_numpy(x8), dh, dw, kernel, method="gather")
    diff = np.abs(got8.numpy().astype(int) - golden.numpy().astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.03


def test_ten_bit_banded_and_unquantized_output():
    x = _noise((2, 60, 80), 3) * 4
    x16 = torch.from_numpy(x.astype(np.uint16))
    got = tr.resize_plane(x16, 120, 160, "bicubic", method="banded")
    want = np.asarray(jr.resize_plane(jnp.asarray(x.astype(np.uint16)), 120, 160, "bicubic",
                                      method="banded"))
    assert got.dtype == torch.uint16 and got.numpy().max() <= 1023
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    got = tr.resize_plane(x16, 30, 40, "bicubic", quantize_output=False, method="banded")
    want = np.asarray(jr.resize_plane(jnp.asarray(x.astype(np.uint16)), 30, 40, "bicubic",
                                      quantize_output=False, method="banded"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * F32_ATOL)


def test_auto_route_on_the_cpu():
    """"auto" on a CPU tensor: float input takes the gather (JAX's CPU
    route), integer input with quantized output the kernel's plain
    version; the identity geometry passes integer input through."""
    x = _noise((2, 45, 80), 11)
    got = tr.resize_plane(torch.from_numpy(x), 90, 160, "bicubic")
    want = np.asarray(jr.resize_plane(jnp.asarray(x), 90, 160, "bicubic"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
    assert torch.equal(got, tr.resize_plane(torch.from_numpy(x), 90, 160, "bicubic",
                                            method="gather"))
    x8 = torch.from_numpy(x.astype(np.uint8))
    assert torch.equal(tr.resize_plane(x8, 90, 160, "bicubic"),
                       tk.resize_frames_plain(x8, 90, 160, "bicubic"))
    assert tr.resize_plane(x8, 45, 80, "bicubic", method="banded") is x8
    ident = tr.resize_plane(torch.from_numpy(x), 45, 80, "bicubic", method="banded")
    assert torch.equal(ident, torch.from_numpy(x))


def test_unknown_method_raises():
    x = torch.zeros((1, 8, 8))
    for method in ("fused", "nearest", ""):
        with pytest.raises(ValueError, match="unknown resize method"):
            tr.resize_plane(x, 16, 16, "bicubic", method=method)


def test_banded_products_restore_the_tf32_flag():
    """The products run with TF32 off and leave the caller's flag as it
    was (on the CPU the flag is read and restored all the same)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            tr.resize_plane(torch.from_numpy(_noise((1, 20, 30), 1)), 40, 60, "bicubic",
                            method="banded")
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
