"""The stalling pass of the port (ops/overlay and
models/avpvs.make_stall_compositor) against the JAX package on the CPU.

The host plans and the spinner bank must be array-equal; the composite
(f32, before quantization) identical at atol 0; the compositor's
quantized planes identical. The JAX compositor shards a chunk over every
visible device when there are several (8 CPU devices in this suite), and
that route lets XLA fuse the blend's multiply and add; the port runs the
single-device route, so these tests pin JAX to one device."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings

import jax
from processing_chain_tpu.models import avpvs as jav
from processing_chain_tpu.ops import overlay as jov
from processing_chain_tpu_torch.models import avpvs as tav
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.ops import overlay as tov
from test_fused import SKIP_CASES, STALL_CASES
from test_overlay_properties import stall_cases

FIELDS = ("src_idx", "stall_mask", "black_mask", "phase")


def assert_plans_equal(ours, ref):
    assert ours.n_out == ref.n_out
    for f in FIELDS:
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.fixture
def one_jax_device(monkeypatch):
    """The JAX compositor's single-device route (see the module doc)."""
    devs = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devs[:1])


# ---------------------------------------------------------------- host plans


@pytest.mark.parametrize("skipping", [False, True])
def test_plan_stalling_matches_jax_over_the_matrix(skipping):
    cases = SKIP_CASES if skipping else STALL_CASES
    for n, fps, events in cases:
        assert_plans_equal(tov.plan_stalling(n, fps, events, skipping=skipping),
                           jov.plan_stalling(n, fps, events, skipping=skipping))


@given(stall_cases())
@settings(max_examples=60, deadline=None)
def test_plan_stalling_matches_jax_property_cases(case):
    n, fps, events = case
    for skipping in (False, True):
        assert_plans_equal(tov.plan_stalling(n, fps, events, skipping=skipping),
                           jov.plan_stalling(n, fps, events, skipping=skipping))


def test_plan_stalling_knobs_match_jax():
    for kw in (dict(black_frame=False), dict(spinner_rps=1.7, n_rotations=16),
               dict(spinner_rps=0.25, n_rotations=64)):
        assert_plans_equal(tov.plan_stalling(90, 29.97, [[1.0, 0.4], [0.2, 0.3]], **kw),
                           jov.plan_stalling(90, 29.97, [[1.0, 0.4], [0.2, 0.3]], **kw))


def test_clip_crop_origin_matches_jax_table():
    for sub in (1, 2):
        for frame in range(2, 200, 2):
            for spinner in range(frame - 10, frame + 80, 2):
                for gs in (1, sub):
                    args = (frame // gs, spinner // gs, sub, gs)
                    assert tov._clip_crop_origin(*args) == jov._clip_crop_origin(*args), args


@pytest.mark.parametrize("n_rotations", [4, 64])
def test_prepare_spinner_real_png_matches_jax(n_rotations):
    rgba = tav.load_spinner(tav.DEFAULT_SPINNER)
    assert rgba.shape == (128, 128, 4) and rgba.dtype == np.uint8
    assert np.array_equal(rgba, jav.load_spinner(tav.DEFAULT_SPINNER))
    ours, ref = tov.prepare_spinner(rgba, n_rotations), jov.prepare_spinner(rgba, n_rotations)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    a = ours[1]
    assert np.array_equal(tov.downsample_alpha(a), jov.downsample_alpha(a))


def test_prepare_spinner_trims_odd_dims_like_jax():
    rgba = np.random.default_rng(3).integers(0, 256, (17, 23, 4)).astype(np.uint8)
    for a, b in zip(tov.prepare_spinner(rgba, 8), jov.prepare_spinner(rgba, 8)):
        assert a.shape[-2:] == (16, 22) and np.array_equal(a, b)


def test_insert_stall_silence_matches_jax():
    audio = np.random.default_rng(4).integers(-3000, 3000, (48000 * 3, 2)).astype(np.int16)
    events = [[2.0, 0.5], [0.25, 0.1]]
    ours = tav.insert_stall_silence(audio, 48000, events)
    assert np.array_equal(ours, jav.insert_stall_silence(audio, 48000, events))
    assert ours.shape[0] == audio.shape[0] + 48000 * 6 // 10


def test_spinner_kinematics_record_matches_jax():
    assert tav.SPINNER_KINEMATICS == jav.SPINNER_KINEMATICS


# ----------------------------------------------------------------- composite


def _square_spinner(size, n_rot, opaque_all=False):
    rgba = np.zeros((size, size, 4), np.uint8)
    rgba[..., 0:3] = 255
    if opaque_all:
        rgba[..., 3] = 255
    else:
        rgba[size // 4: 3 * size // 4, size // 4: 3 * size // 4, 3] = 255
    return jov.prepare_spinner(rgba, n_rotations=n_rot)


def _render_both(frames, plan, spinner, alpha, **kw):
    ref = np.asarray(jov.render_stalled_plane(frames, plan, spinner, alpha, **kw))
    ours = tov.render_stalled_plane(torch.from_numpy(frames), plan, spinner, alpha, **kw)
    assert ours.dtype == torch.float32
    return ours.numpy(), ref


@pytest.mark.parametrize("case", ["black", "spinner", "noise_spinner", "larger_than_frame"])
def test_render_stalled_plane_identical(case):
    rng = np.random.default_rng(11)
    if case == "larger_than_frame":
        # a 32-px spinner over a 12x20 frame is center-cropped to fit
        frames = np.full((6, 12, 20), 200, np.float32)
        plan = jov.plan_stalling(6, 10.0, [[0.2, 0.2]], black_frame=True, n_rotations=4)
        yuv, alpha = _square_spinner(32, 4, opaque_all=True)
    else:
        frames = (np.full((10, 64, 64), 200, np.float32) if case != "noise_spinner"
                  else rng.integers(0, 256, (10, 64, 72)).astype(np.float32))
        plan = jov.plan_stalling(10, 10.0, [[0.5, 0.3]], black_frame=True, n_rotations=4)
        yuv, alpha = _square_spinner(16, 4)
        if case == "noise_spinner":
            rgba = rng.integers(0, 256, (24, 24, 4)).astype(np.uint8)
            yuv, alpha = jov.prepare_spinner(rgba, 8)
    spinner = None if case == "black" else yuv[:, 0]
    alpha = None if case == "black" else alpha
    ours, ref = _render_both(frames, plan, spinner, alpha)
    assert ours.shape == ref.shape == (plan.n_out,) + frames.shape[1:]
    assert np.array_equal(ours, ref)


def _row_index_bank(sh, sw):
    """A one-phase bank whose every pixel holds its row index."""
    return np.broadcast_to(np.arange(sh, dtype=np.float32)[:, None], (1, sh, sw)).copy()


def _core_both(frames, bank, alpha, bv, **kw):
    one = np.ones((1,), np.float32)
    phase = np.zeros((1,), np.int32)
    ref = np.asarray(jov.render_core(frames, one, one, phase, bank, alpha, bv, **kw))
    ours = tov.render_core(torch.from_numpy(frames), one, one, phase, bank, alpha, bv, **kw)
    return ours.numpy(), ref


@pytest.mark.parametrize("geom", [
    (90, 160, 128, 128),   # oversized spinner, both axes: crop origin 20 on the luma grid
    (90, 160, 128, 64),    # oversized on one axis only
    (70, 160, 32, 32),     # fits; odd natural offset masked to the chroma grid
])
@pytest.mark.parametrize("sub", [(2, 2), (1, 2)])
def test_render_core_chroma_lock_identical(geom, sub):
    """The ffmpeg-placement cases of test_ops.py, for 420 and 422 chroma:
    luma and the chroma plane (grid_scale = sub) each identical."""
    h, w, sh, sw = geom
    bank_l, bank_c = _row_index_bank(sh, sw), _row_index_bank(sh // sub[0], sw // sub[1])
    ours, ref = _core_both(np.zeros((1, h, w), np.float32), bank_l,
                           np.ones_like(bank_l), 16.0, crop_align=sub)
    assert np.array_equal(ours, ref)
    ours, ref = _core_both(np.zeros((1, h // sub[0], w // sub[1]), np.float32), bank_c,
                           np.ones_like(bank_c), 128.0, crop_align=sub, grid_scale=sub)
    assert np.array_equal(ours, ref)
    if geom == (90, 160, 128, 128) and sub == (2, 2):
        assert ref[0, 0, 10] == 10.0  # the chroma crop origin 20 / 2


def test_render_core_rejects_off_grid_luma():
    with pytest.raises(ValueError, match="crop_align"):
        tov.render_core(torch.zeros((1, 9, 16)), np.ones(1), np.ones(1), np.zeros(1, np.int32),
                        np.ones((1, 4, 4), np.float32), np.ones((1, 4, 4), np.float32),
                        16.0, crop_align=(2, 2))


def test_blend_plane_refuses_a_region_outside_the_frame():
    bg = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="leaves"):
        tov._blend_plane(bg, torch.ones((1, 4, 4)), torch.ones((1, 4, 4)), 6, 0)


# ---------------------------------------------------------------- compositor


def _planes(rng, t, h, w, pix_fmt):
    hi, dtype = (1023, np.uint16) if "10" in pix_fmt else (255, np.uint8)
    sub_h, sub_w = (2, 2) if "420" in pix_fmt else (1, 2)
    return [rng.integers(0, hi + 1, s).astype(dtype)
            for s in ((t, h, w), (t, h // sub_h, w // sub_w), (t, h // sub_h, w // sub_w))]


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le", "yuv422p"])
@pytest.mark.parametrize("skipping", [False, True])
@pytest.mark.parametrize("h,w", [(90, 160), (144, 192)])
def test_stall_compositor_identical(one_jax_device, pix_fmt, skipping, h, w):
    """The real 128-px spinner over 90-px frames (cropped) and 144-px
    frames (fits), for each pix_fmt, in spinner and skipping mode."""
    rng = np.random.default_rng(h + 7 * skipping)
    planes = _planes(rng, 9, h, w, pix_fmt)
    events = [[0.1, 0.2]] if skipping else [[0.2, 0.4]]
    plan = jov.plan_stalling(9, 10.0, events, skipping=skipping)
    gathered = [p[plan.src_idx] for p in planes]
    masks = (plan.stall_mask, plan.black_mask, plan.phase)
    ref = jav.make_stall_compositor(pix_fmt, tav.DEFAULT_SPINNER, skipping, 64)(gathered, *masks)
    tk.reset_launches()
    comp = tav.make_stall_compositor(pix_fmt, tav.DEFAULT_SPINNER, skipping, 64, device="cpu")
    ours = comp([torch.from_numpy(g) for g in gathered], *masks)
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    if not skipping:  # the spinner shows on the stall frames only
        stall = np.flatnonzero(plan.stall_mask)
        assert (ours[0][stall].numpy() != 16 * (4 if "10" in pix_fmt else 1)).any()


def test_stall_compositor_takes_an_rgba_array_and_numpy_planes(one_jax_device):
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (40, 40, 4)).astype(np.uint8)
    planes = _planes(rng, 6, 48, 64, "yuv420p")
    plan = jov.plan_stalling(6, 10.0, [[0.3, 0.3]], n_rotations=16)
    gathered = [p[plan.src_idx] for p in planes]
    masks = (plan.stall_mask, plan.black_mask, plan.phase)
    ours = tav.make_stall_compositor("yuv420p", rgba, False, 16, device="cpu")(gathered, *masks)
    ref_np = tov.render_stalled_plane(
        torch.from_numpy(planes[0]).to(torch.float32), plan,
        jov.prepare_spinner(rgba, 16)[0][:, 0], jov.prepare_spinner(rgba, 16)[1],
        crop_align=(2, 2))
    assert np.array_equal(ours[0].numpy(),
                          torch.clamp(torch.floor(ref_np + 0.5), 0, 255).to(torch.uint8).numpy())


def test_stall_compositor_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device resolves")
    from processing_chain_tpu_torch.utils.device import DeviceError

    with pytest.raises(DeviceError):
        tav.make_stall_compositor("yuv420p", None, True, 64)
