"""Port parity: processing_chain_tpu_torch/priors/features.py against the
JAX package's priors/features.py, on the CPU, on seeded MV tables held in
the JAX package's own PriorsData (the port reads any object with its
fields).

Tolerances: the host-side numpy functions (frame_mv_stats, mv_field,
intra_fraction) are array-equal; the torch reductions (mv_magnitudes,
field_divergence, hence frame_divergence) agree within 1e-5 relative to
the f32 values (another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from processing_chain_tpu.priors import features as jfeat
from processing_chain_tpu.priors.model import PriorsData
from processing_chain_tpu_torch.priors import features as tfeat

RTOL = 1e-5


def _synthetic_priors(n, h, w, seed, with_mvs=True):
    """I, P and B frames of a 16x16 block grid: one MV row per covered
    block, a zoom-like motion field plus noise; B frames export each block
    twice (one row per prediction direction); some blocks left intra."""
    rng = np.random.default_rng(seed)
    pict = np.array([1 if k % 12 == 0 else (3 if k % 3 == 2 else 2) for k in range(n)], np.int8)
    gy, gx = np.mgrid[0:(h + 15) // 16, 0:(w + 15) // 16]
    cx, cy = gx.ravel() * 16 + 8, gy.ravel() * 16 + 8
    rows, counts = [], []
    for k in range(n):
        if pict[k] == 1 or not with_mvs:
            counts.append(0)
            continue
        keep = rng.random(cx.size) > 0.1
        dx = ((cx - w / 2) * 0.02 * (k % 5) + rng.normal(0, 1.5, cx.size)).round()
        dy = ((cy - h / 2) * 0.02 * (k % 5) + rng.normal(0, 1.5, cx.size)).round()
        blk = np.stack([cx - dx, cy - dy, cx, cy, np.full_like(cx, 16), np.full_like(cx, 16),
                        np.full_like(cx, -1)], axis=1)[keep].astype(np.int32)
        if pict[k] == 3:
            fwd = blk.copy()
            fwd[:, 6] = 1
            blk = np.concatenate([blk, fwd])
        rows.append(blk)
        counts.append(len(blk))
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return PriorsData(
        width=w, height=h, pts=np.arange(n) / 24.0, pict_type=pict,
        key_frame=(pict == 1).astype(np.int8), pkt_size=np.full(n, 100, np.int64),
        qp_mean=np.full(n, 20.0), qp_var=np.zeros(n), qp_blocks=np.full(n, 24, np.int32),
        mv_offsets=offsets,
        mv_rows=np.concatenate(rows) if rows else np.zeros((0, 7), np.int32),
    )


@pytest.mark.parametrize("h,w,seed", [(64, 96, 0), (180, 320, 1), (72, 130, 2)])
def test_features_equal_jax(h, w, seed):
    data = _synthetic_priors(14, h, w, seed)
    np.testing.assert_allclose(tfeat.mv_magnitudes(data.mv_rows, "cpu").numpy(),
                               np.asarray(jfeat.mv_magnitudes(jnp.asarray(data.mv_rows))),
                               rtol=RTOL)
    for name in ("mean_mag", "p95_mag", "mv_count"):
        np.testing.assert_array_equal(tfeat.frame_mv_stats(data)[name],
                                      jfeat.frame_mv_stats(data)[name])
    for i in range(data.n_frames):
        field = tfeat.mv_field(data, i)
        np.testing.assert_array_equal(field, jfeat.mv_field(data, i))
        assert float(tfeat.field_divergence(field, "cpu")) == pytest.approx(
            float(jfeat.field_divergence(jnp.asarray(field))), rel=RTOL, abs=1e-7)
    np.testing.assert_array_equal(tfeat.intra_fraction(data), jfeat.intra_fraction(data))
    got = tfeat.temporal_features(data, device="cpu")
    want = jfeat.temporal_features(data)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7, err_msg=k)
        assert got[k].dtype == want[k].dtype
    assert (got["divergence"][data.pict_type != 1] > 0).all()


def test_features_without_mvs_equal_jax():
    data = _synthetic_priors(6, 64, 96, 4, with_mvs=False)
    got, want = tfeat.temporal_features(data, device="cpu"), jfeat.temporal_features(data)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["intra_fraction"][data.pict_type != 1] == 0.0).all()


def test_torch_inputs_are_accepted():
    data = _synthetic_priors(4, 48, 64, 5)
    rows = torch.from_numpy(data.mv_rows)
    assert torch.equal(tfeat.mv_magnitudes(rows, "cpu"), tfeat.mv_magnitudes(data.mv_rows, "cpu"))
    field = tfeat.mv_field(data, 1)
    assert torch.equal(tfeat.field_divergence(torch.from_numpy(field), "cpu"),
                       tfeat.field_divergence(field, "cpu"))
