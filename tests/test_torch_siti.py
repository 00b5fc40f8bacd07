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
