"""The flagship step: the port's `parallel/pipeline.avpvs_siti_step`
against the JAX package's on the same seeded planes, on the CPU.

[4, 36, 64] yuv420p -> 72x128, lanczos. u8 up-planes must be identical
(the swscale integer path on both sides); u16 within one code value (the
port's u16 route is the TPU kernel's horizontal-first f32 arithmetic, the
JAX CPU route gathers vertical first). SI/TI within atol 1e-3 (1e-2 for
u16), rtol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from processing_chain_tpu.parallel import pipeline as jp
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.parallel import pipeline as tp

T, H, W, DH, DW = 4, 36, 64, 72, 128


def _planes(dtype, hi, seed):
    rng = np.random.default_rng(seed)
    shapes = ((T, H, W), (T, H // 2, W // 2), (T, H // 2, W // 2))
    return [rng.integers(0, hi + 1, s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("dtype,hi,atol", [(np.uint8, 255, 1e-3), (np.uint16, 1023, 1e-2)])
@pytest.mark.parametrize("with_prev", [False, True])
def test_avpvs_siti_step_matches_jax(dtype, hi, atol, with_prev):
    planes = _planes(dtype, hi, 31)
    prev = np.random.default_rng(32).integers(0, hi + 1, (DH, DW)).astype(dtype)
    tk.reset_launches()
    ours = tp.avpvs_siti_step(
        *[torch.from_numpy(p) for p in planes], DH, DW,
        prev_last=torch.from_numpy(prev) if with_prev else None)
    ref = jp.avpvs_siti_step(
        *[jnp.asarray(p) for p in planes], DH, DW,
        prev_last=jnp.asarray(prev.astype(np.float32)) if with_prev else None)
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}
    for a, b, shape in zip(ours[:3], ref[:3], ((T, DH, DW), (T, DH // 2, DW // 2), (T, DH // 2, DW // 2))):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == shape and a.dtype == b.dtype == dtype
        if dtype == np.uint8:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    up_y = ours[0].numpy().astype(np.float64)
    si, ti = ours[3].numpy(), ours[4].numpy()
    assert si.shape == ti.shape == (T,)
    if dtype == np.uint8:
        np.testing.assert_allclose(si, np.asarray(ref[3]), rtol=1e-4, atol=atol)
        np.testing.assert_allclose(ti, np.asarray(ref[4]), rtol=1e-4, atol=atol)
    # the features are those of the port's own up-plane (u16 planes may
    # sit one code value from JAX's, so its SI/TI are held to their own)
    first = up_y[0] - prev.astype(np.float64) if with_prev else np.zeros_like(up_y[0])
    want_ti = [np.std(first)] + [np.std(up_y[k] - up_y[k - 1]) for k in range(1, T)]
    np.testing.assert_allclose(ti, want_ti, rtol=1e-4, atol=atol)


def test_avpvs_siti_step_prev_last_continuity():
    """Mirrors test_avpvs_siti_step_prev_last_continuity: TI[0] diffs
    against prev_last (here the step's own last frame, passed as f32 as
    the JAX test does), SI and TI[1:] do not depend on it."""
    y, u, v = (torch.from_numpy(p) for p in _planes(np.uint8, 255, 21)[:3])
    up_y, _, _, si0, ti0 = tp.avpvs_siti_step(y, u, v, DH, DW)
    assert float(ti0[0]) == 0.0
    prev = up_y[-1].to(torch.float32)
    up_y2, _, _, si1, ti1 = tp.avpvs_siti_step(y, u, v, DH, DW, prev_last=prev)
    assert torch.equal(up_y, up_y2)
    np.testing.assert_allclose(si0.numpy(), si1.numpy(), rtol=1e-5)
    want = float(np.std(up_y[0].numpy().astype(np.float64)
                        - up_y[-1].numpy().astype(np.float64)))
    assert float(ti1[0]) == pytest.approx(want, abs=1e-2)
    np.testing.assert_allclose(ti0.numpy()[1:], ti1.numpy()[1:], rtol=1e-5, atol=1e-4)
