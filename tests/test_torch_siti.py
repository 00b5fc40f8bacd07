"""Port parity: processing_chain_tpu_torch/ops/siti.py and the SI/TI
wrappers of ops/cuda_kernels.py against the JAX package, on the CPU.

Tolerances are the reference's own (test_pallas_siti_matches_xla,
test_pallas_siti_10bit_container_depth): atol 1e-3 (1e-2 for u16),
rtol 1e-4. The JAX Pallas kernels run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from processing_chain_tpu.ops import pallas_kernels as jpk
from processing_chain_tpu.ops import siti as js
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.ops import siti as ts

CASES = {
    "u8": (np.uint8, 255, 1e-3),
    "u16": (np.uint16, 1023, 1e-2),
    "f32": (np.float32, 255, 1e-3),
}


def _frames(kind, shape, seed):
    dtype, hi, _ = CASES[kind]
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, shape).astype(dtype)


@pytest.mark.parametrize("kind", list(CASES))
def test_si_ti_match_jax_xla_and_pallas(kind):
    """Width 200 is not a multiple of 128 (the Pallas stripe width)."""
    atol = CASES[kind][2]
    y = _frames(kind, (4, 72, 200), 11)
    jy = jnp.asarray(y)
    si = ts.si_frames(torch.from_numpy(y)).numpy()
    ti = ts.ti_frames(torch.from_numpy(y)).numpy()
    assert si.dtype == np.float32 and si.shape == (4,)
    for ref_si, ref_ti in (
        (js.si_frames(jy.astype(jnp.float32)), js.ti_frames(jy.astype(jnp.float32))),
        (jpk.si_frames_fused(jy, interpret=True), jpk.ti_frames_fused(jy, interpret=True)),
    ):
        np.testing.assert_allclose(si, np.asarray(ref_si), rtol=1e-4, atol=atol)
        np.testing.assert_allclose(ti, np.asarray(ref_ti), rtol=1e-4, atol=atol)
    assert ti[0] == 0.0


@pytest.mark.parametrize("kind", ["u8", "u16"])
def test_ti_frames_continued_split_equals_whole(kind):
    """TI carried across chunk edges (container-depth predecessor) equals
    TI of the whole clip, and equals the JAX package's continued TI."""
    atol = CASES[kind][2]
    y = torch.from_numpy(_frames(kind, (7, 40, 160), 14))
    whole = ts.ti_frames(y)
    prev, parts = None, []
    jprev, jparts = None, []
    for lo, hi in ((0, 3), (3, 4), (4, 7)):
        ti, prev = ts.ti_frames_continued(y[lo:hi], prev)
        assert prev.dtype == y.dtype
        parts.append(ti)
        jti, jprev = js.ti_frames_continued(jnp.asarray(y[lo:hi].numpy()), jprev)
        jparts.append(np.asarray(jti))
    split = torch.cat(parts)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(split.numpy(), np.concatenate(jparts), rtol=1e-4, atol=atol)


def test_ti_with_predecessor_matches_numpy():
    y = _frames("u16", (3, 40, 160), 15)
    prev = _frames("u16", (40, 160), 16)
    ti = ts.ti_frames(torch.from_numpy(y), torch.from_numpy(prev)).numpy()
    seq = np.concatenate([prev[None], y]).astype(np.float64)
    ref = [np.std(seq[t + 1] - seq[t]) for t in range(3)]
    np.testing.assert_allclose(ti, ref, rtol=1e-4, atol=1e-2)


def test_flat_frame_zero():
    y = torch.full((3, 64, 64), 77, dtype=torch.uint8)
    assert torch.all(ts.si_frames(y) == 0) and torch.all(ts.ti_frames(y) == 0)


def test_sobel_and_si_frame_match_jax():
    y = _frames("u8", (72, 200), 17)
    np.testing.assert_allclose(
        ts.sobel_magnitude(torch.from_numpy(y)).numpy(),
        np.asarray(js.sobel_magnitude(jnp.asarray(y))), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        float(ts.si_frame(torch.from_numpy(y))), float(js.si_frame(jnp.asarray(y))),
        rtol=1e-4, atol=1e-3)


def test_complexity_proxy_matches_jax():
    args = (1_000_000, 25.0, 8.0, 1920, 1080)
    assert ts.norm_bitrate_complexity(*args) == js.norm_bitrate_complexity(*args)
    assert ts.REFERENCE_BITRATE == js.REFERENCE_BITRATE


def test_cpu_siti_never_counts_a_launch():
    tk.reset_launches()
    y = torch.from_numpy(_frames("u8", (3, 20, 30), 1))
    ts.si_frames(y)
    ts.ti_frames_continued(y, y[0].clone())
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}


def test_wrappers_reject_what_the_kernels_do_not_take():
    y = torch.zeros((2, 20, 30), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tk.ti_frames_fused(y, torch.zeros((20, 31), dtype=torch.uint8))
    with pytest.raises(ValueError):
        tk.ti_frames_fused(y, torch.zeros((20, 30), dtype=torch.uint16))
    with pytest.raises(ValueError):
        tk.si_frames_fused(torch.zeros((2, 2, 30), dtype=torch.uint8))
    with pytest.raises(TypeError):
        tk.si_frames_fused(y.to(torch.int16))
    with pytest.raises(ValueError):
        tk.si_frames_fused(y[:, :, ::2])


# ---------------------------------------------------------------------------
# Fused SI+TI (pallas_kernels.py rows 4-5): siti_frames_fused and
# siti_frames_fused_batch, and ops/siti.siti / siti_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(CASES))
def test_fused_siti_plain_matches_jax_pallas(kind):
    """Mirrors test_pallas_siti_combined_matches_separate: width 200 and
    height 48, a 1-frame clip (TI = [0])."""
    atol = CASES[kind][2]
    y = _frames(kind, (5, 48, 200), 21)
    si, ti = tk.siti_frames_plain(torch.from_numpy(y))
    jsi, jti = jpk.siti_frames_fused(jnp.asarray(y), interpret=True)
    np.testing.assert_allclose(si.numpy(), np.asarray(jsi), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(jti), rtol=1e-4, atol=atol)
    assert ti[0] == 0.0
    si1, ti1 = tk.siti_frames_fused(torch.from_numpy(y[:1]))
    jsi1, jti1 = jpk.siti_frames_fused(jnp.asarray(y[:1]), interpret=True)
    np.testing.assert_allclose(si1.numpy(), np.asarray(jsi1), rtol=1e-4, atol=atol)
    assert ti1.tolist() == [0.0] and np.asarray(jti1).tolist() == [0.0]


@pytest.mark.parametrize("kind", list(CASES))
def test_fused_siti_batch_plain_matches_jax_pallas(kind):
    """Mirrors test_pallas_siti_batch_with_halo_matches_xla: TI[b, 0]
    against prev_last[b], and the self-halo (prev_last = y[:, 0]) giving
    TI[:, 0] == 0."""
    atol = CASES[kind][2]
    y = _frames(kind, (3, 4, 48, 200), 22)
    prev = _frames(kind, (3, 48, 200), 23)
    si, ti = tk.siti_frames_batch_plain(torch.from_numpy(y), torch.from_numpy(prev))
    jsi, jti = jpk.siti_frames_fused_batch(jnp.asarray(y), jnp.asarray(prev), interpret=True)
    assert si.shape == ti.shape == (3, 4)
    np.testing.assert_allclose(si.numpy(), np.asarray(jsi), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(jti), rtol=1e-4, atol=atol)
    halo = np.ascontiguousarray(y[:, 0])
    si0, ti0 = tk.siti_frames_fused_batch(torch.from_numpy(y), torch.from_numpy(halo))
    jsi0, jti0 = jpk.siti_frames_fused_batch(jnp.asarray(y), jnp.asarray(halo), interpret=True)
    assert ti0[:, 0].tolist() == [0.0, 0.0, 0.0]
    np.testing.assert_allclose(ti0.numpy(), np.asarray(jti0), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(si0.numpy(), np.asarray(jsi0), rtol=1e-4, atol=atol)


@pytest.mark.parametrize("kind", list(CASES))
def test_siti_and_siti_batch_match_jax(kind):
    atol = CASES[kind][2]
    y = _frames(kind, (4, 40, 160), 24)
    si, ti = ts.siti(torch.from_numpy(y))
    jsi, jti = js.siti(jnp.asarray(y))
    np.testing.assert_allclose(si.numpy(), np.asarray(jsi), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(jti), rtol=1e-4, atol=atol)
    yb = _frames(kind, (2, 3, 40, 160), 25)
    prev = _frames(kind, (2, 40, 160), 26)
    sib, tib = ts.siti_batch(torch.from_numpy(yb), torch.from_numpy(prev))
    jsib, jtib = js.siti_batch(jnp.asarray(yb), jnp.asarray(prev))
    np.testing.assert_allclose(sib.numpy(), np.asarray(jsib), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(tib.numpy(), np.asarray(jtib), rtol=1e-4, atol=atol)
    # non-contiguous lane views go through (siti_batch makes them
    # contiguous): frames 1.. against frame 0 are the tail of the whole
    sv, tv = ts.siti_batch(torch.from_numpy(yb)[:, 1:], torch.from_numpy(yb)[:, 0])
    assert torch.equal(sv, sib[:, 1:]) and torch.equal(tv, tib[:, 1:])


def test_fused_siti_equals_separate_wrappers():
    """The fused plain versions are the separate ones, side by side."""
    y = torch.from_numpy(_frames("u8", (3, 37, 61), 27))
    prev = torch.from_numpy(_frames("u8", (1, 37, 61), 28))
    si, ti = tk.siti_frames_fused(y)
    assert torch.equal(si, tk.si_frames_fused(y)) and torch.equal(ti, tk.ti_frames_fused(y))
    sib, tib = tk.siti_frames_fused_batch(y[None], prev)
    assert torch.equal(sib[0], si) and torch.equal(tib[0], tk.ti_frames_fused(y, prev[0]))
    assert tk.LAUNCHES["siti_frames_fused"] == tk.LAUNCHES["siti_frames_fused_batch"] == 0


def test_fused_wrappers_reject_what_the_kernel_does_not_take():
    y = torch.zeros((2, 3, 20, 30), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tk.siti_frames_fused(y)  # 4-D where [T, H, W] is expected
    with pytest.raises(ValueError):
        tk.siti_frames_fused_batch(y[0], y[:, 0])  # 3-D where [B, T, H, W]
    with pytest.raises(ValueError):
        tk.siti_frames_fused_batch(y, torch.zeros((3, 20, 30), dtype=torch.uint8))
    with pytest.raises(ValueError):
        tk.siti_frames_fused_batch(y, torch.zeros((2, 20, 30), dtype=torch.uint16))
    with pytest.raises(ValueError):
        tk.siti_frames_fused_batch(y, y[:, 0])  # not contiguous
    with pytest.raises(ValueError):
        tk.siti_frames_fused(torch.zeros((2, 2, 30), dtype=torch.uint8))
    with pytest.raises(TypeError):
        tk.siti_frames_fused(y[0].to(torch.int16))
