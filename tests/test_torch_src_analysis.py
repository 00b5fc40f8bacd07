"""Port parity: the device half of the SRC analysis
(processing_chain_tpu_torch/tools/src_analysis.py) against the JAX
package's `src_siti_summary`, on the CPU.

The JAX tool decodes the file itself; the port takes the chunks the JAX
package's VideoReader decodes from the same file. Tolerances: per-frame
SI/TI within 1e-3 on the 8-bit scale (the port sums at container depth in
f64, JAX in f32); the summary's values, rounded to 4 places by both,
within 1e-3. The summary of given arrays is exact."""

import numpy as np
import pytest
import torch

from processing_chain_tpu.engine import prefetch as jpf
from processing_chain_tpu.io.video import VideoReader, VideoWriter
from processing_chain_tpu.ops import siti as jsiti
from processing_chain_tpu.tools import src_analysis as jsa
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.tools import src_analysis as tsa


def _write_src(path, n, h, w, ten_bit, seed):
    rng = np.random.default_rng(seed)
    hi, dtype = (1023, np.uint16) if ten_bit else (255, np.uint8)
    with VideoWriter(str(path), "ffv1", w, h, "yuv420p10le" if ten_bit else "yuv420p",
                     (25, 1)) as wr:
        for k in range(n):
            grad = (np.arange(w)[None, :] * 3 + np.arange(h)[:, None] + 7 * k) % (hi - 60)
            y = (grad + rng.integers(0, 60, (h, w))).astype(dtype)
            c = np.full((h // 2, w // 2), (hi + 1) // 2, dtype)
            wr.write(y, c, c)


def _decode(path, chunk):
    with VideoReader(str(path)) as reader:
        return [[np.array(p, copy=True) for p in c] for c in jpf.iter_plane_chunks(reader, chunk)]


@pytest.mark.parametrize("ten_bit", [False, True])
@pytest.mark.parametrize("chunk", [64, 5])
def test_summary_equals_jax(tmp_path, ten_bit, chunk):
    path = tmp_path / "SRC0.avi"
    _write_src(path, 13, 36, 64, ten_bit, 3 + ten_bit)
    want = jsa.src_siti_summary(str(path), chunk=chunk)
    chunks = _decode(path, chunk)
    got = tsa.src_siti_summary(iter(chunks), device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-3), k
    # the per-frame features on the 8-bit scale, against JAX's siti ops on
    # the scaled f32 luma of the whole clip (no chunk edge)
    si, ti = tsa.src_siti_frames(iter(chunks), device="cpu")
    assert si.dtype == ti.dtype == np.float32 and ti[0] == 0.0
    y = np.concatenate([c[0] for c in chunks]).astype(np.float32) * (0.25 if ten_bit else 1.0)
    np.testing.assert_allclose(si, np.asarray(jsiti.si_frames(y)), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ti, np.asarray(jsiti.ti_frames(y)), rtol=0, atol=1e-3)
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}


def test_summarize_siti_is_the_reference_record():
    rng = np.random.default_rng(1)
    si = rng.uniform(0, 90, 37).astype(np.float32)
    ti = rng.uniform(0, 40, 37).astype(np.float32)
    assert tsa.summarize_siti(si, ti) == {
        "si_mean": round(float(si.mean()), 4), "si_max": round(float(si.max()), 4),
        "si_p95": round(float(np.percentile(si, 95)), 4),
        "ti_mean": round(float(ti.mean()), 4), "ti_max": round(float(ti.max()), 4),
        "ti_p95": round(float(np.percentile(ti, 95)), 4),
    }


def test_tensor_chunks_and_luma_only():
    rng = np.random.default_rng(2)
    y = rng.integers(0, 256, (9, 20, 30)).astype(np.uint8)
    chunks = [[y[:4]], [y[4:]]]  # only the luma is read
    a = tsa.src_siti_frames(iter(chunks), device="cpu")
    b = tsa.src_siti_frames(iter([[torch.from_numpy(c[0])] for c in chunks]), device="cpu")
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)
