"""Port parity: processing_chain_tpu_torch/ops/resize.py and the resize
wrapper of ops/cuda_kernels.py against the JAX package, on the CPU.

Same seeded numpy inputs through both packages. The JAX Pallas kernel
runs in interpret mode, as tests/test_ops.py runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from processing_chain_tpu.ops import pallas_kernels as jpk
from processing_chain_tpu.ops import resize as jr
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.ops import resize as tr

KERNELS = ("bicubic", "lanczos")
# up, down, one-axis identity, the north-star luma and chroma upscales
AXES = ((45, 90), (270, 135), (80, 80), (1080, 2160), (960, 1920), (13, 7))


def smooth_image(h, w):
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    return ((np.sin(xx / 37) + np.cos(yy / 23)) * 55 + 128).astype(np.uint8)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("src,dst", AXES)
def test_plan_functions_array_equal(kernel, src, dst):
    for quantize in (True, False):
        for a, b in zip(tr.make_plan(src, dst, kernel, quantize),
                        jr.make_plan(src, dst, kernel, quantize)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for one in (1 << 14, 1 << 12):
        for a, b in zip(tr.make_swscale_plan(src, dst, kernel, one),
                        jr.make_swscale_plan(src, dst, kernel, one)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tr._swscale_tap_matrix(src, dst, kernel, one),
                        jr._swscale_tap_matrix(src, dst, kernel, one)):
            np.testing.assert_array_equal(a, b)
    assert tr.swscale_exact_applicable(src, src, dst, dst, kernel) == \
        jr.swscale_exact_applicable(src, src, dst, dst, kernel)


def test_plan_functions_bilinear_and_envelope():
    for a, b in zip(tr.make_plan(100, 37, "bilinear"), jr.make_plan(100, 37, "bilinear")):
        np.testing.assert_array_equal(a, b)
    for args in ((340, 20, 20, 20, "bicubic"), (20, 20, 20, 20, "bilinear"),
                 (1080, 1920, 2160, 3840, "lanczos")):
        assert tr.swscale_exact_applicable(*args) == jr.swscale_exact_applicable(*args)
    with pytest.raises(ValueError):
        tr.make_plan(10, 20, "nearest")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dst", [(270, 480), (68, 120), (135, 300), (90, 240)])
def test_plain_u8_bitexact_vs_jax_swscale_exact(kernel, dst):
    """u8 noise (the adversarial rounding case): the port's plain path is
    bit-exact with the JAX golden integer path, including the one-axis
    identity geometry (135, 300)."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 256, size=(2, 135, 240), dtype=np.uint8)
    dh, dw = dst
    ref = np.asarray(jr._swscale_exact(jnp.asarray(src), dh, dw, kernel))
    ours = tr.resize_plane(torch.from_numpy(src), dh, dw, kernel)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == (2, dh, dw)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(
        tr._swscale_exact(torch.from_numpy(src), dh, dw, kernel).numpy(), ref
    )


def test_plain_u8_within_one_of_jax_fused_random_geometries():
    """Seeded random geometries (mirroring test_resize_golden_random_
    geometries): the plain u8 path sits <= 1 code value, mean < 0.3, from
    the JAX fused Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(20260730)
    src = np.stack([smooth_image(101, 179), smooth_image(101, 179)[::-1]])
    for _ in range(4):
        dh = int(rng.integers(32, 260)) & ~1
        dw = int(rng.integers(32, 400)) & ~1
        kernel = KERNELS[int(rng.integers(2))]
        ref = np.asarray(jpk.resize_frames_fused(
            jnp.asarray(src), dh, dw, kernel, interpret=True))
        ours = tr.resize_frames(torch.from_numpy(src), dh, dw, kernel).numpy()
        diff = np.abs(ref.astype(int) - ours.astype(int))
        assert diff.max() <= 1, (kernel, dh, dw, diff.max())
        assert diff.mean() < 0.3, (kernel, dh, dw, diff.mean())


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_u16_within_one_of_jax_fused(kernel):
    """10-bit container planes: the plain f32 route is the fused kernel's
    own arithmetic, so it differs from the JAX kernel only on rounding
    ties: <= 1 code value on < 1% of samples."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1023, (2, 90, 160), np.uint16)
    ref = np.asarray(jpk.resize_frames_fused(
        jnp.asarray(x), 180, 320, kernel, interpret=True))
    ours = tr.resize_frames(torch.from_numpy(x), 180, 320, kernel)
    assert ours.dtype == torch.uint16
    diff = np.abs(ref.astype(int) - ours.numpy().astype(int))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


def test_plain_u8_outside_envelope_within_one_of_jax_fused():
    """u8 bilinear is outside the swscale-exact envelope: the f32 route
    with the u8 intermediate clamp, <= 1 from the JAX kernel."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (2, 40, 72), np.uint8)
    ref = np.asarray(jpk.resize_frames_fused(
        jnp.asarray(x), 80, 144, "bilinear", interpret=True))
    ours = tk.resize_frames_plain(torch.from_numpy(x), 80, 144, "bilinear").numpy()
    diff = np.abs(ref.astype(int) - ours.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


def test_float_route_matches_jax_gather():
    """Float input takes the f32 tap gather (vertical, then horizontal),
    the JAX package's gather method."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 30, 52)).astype(np.float32) * 255
    ref = np.asarray(jr.resize_plane(jnp.asarray(x), 60, 104, "lanczos", method="gather"))
    ours = tr.resize_plane(torch.from_numpy(x), 60, 104, "lanczos")
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_identity_passthrough(dtype):
    src = torch.from_numpy(smooth_image(108, 192).astype(dtype))
    assert tr.resize_plane(src, 108, 192) is src
    stack = src[None].repeat(2, 1, 1)
    assert tk.resize_frames_fused(stack, 108, 192, "bicubic") is stack
    flt = tr.resize_plane(src.to(torch.float32), 108, 192)
    np.testing.assert_array_equal(flt.numpy(), src.numpy().astype(np.float32))


def test_resize_yuv_chroma_grids():
    y = torch.from_numpy(smooth_image(108, 192))
    u = torch.from_numpy(smooth_image(54, 96))
    v = torch.from_numpy(smooth_image(54, 96))
    oy, ou, ov = tr.resize_yuv((y, u, v), 216, 384, "yuv420p")
    assert oy.shape == (216, 384)
    assert ou.shape == (108, 192) and ov.shape == (108, 192)
    jy, ju, jv = jr.resize_yuv(
        tuple(jnp.asarray(p.numpy()) for p in (y, u, v)), 216, 384, "yuv420p",
        method="gather")
    for a, b in ((oy, jy), (ou, ju), (ov, jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_tensor_never_counts_a_launch():
    tk.reset_launches()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 256, (2, 20, 30), np.uint8))
    tr.resize_frames(x, 40, 60, "bicubic")
    tk.resize_frames_fused(x, 40, 60, "lanczos")
    tk.resize_frames_fused(x.to(torch.int32).to(torch.uint16), 40, 60, "bicubic")
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 20, 30), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tk.resize_frames_fused(x.to(torch.float32), 40, 60)
    with pytest.raises(ValueError):
        tk.resize_frames_fused(x[0], 40, 60)
    with pytest.raises(ValueError):
        tk.resize_frames_fused(x.transpose(1, 2), 40, 60)
    with pytest.raises(TypeError):
        tk.resize_frames_fused(x.numpy(), 40, 60)
