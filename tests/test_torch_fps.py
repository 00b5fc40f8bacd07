"""Port parity: processing_chain_tpu_torch/ops/fps.py against the JAX
package's ops/fps.py, on the same inputs. Every result is array-equal:
the module is a host-side copy."""

import numpy as np
import pytest
import torch

from processing_chain_tpu.config import ConfigError as JConfigError
from processing_chain_tpu.ops import fps as jfps
from processing_chain_tpu_torch.config.domain import ConfigError
from processing_chain_tpu_torch.ops import fps as tfps

SPECS = ("original", "auto", "24/25/30", "50/60", "1/2", "2/5", 15, "30", 29.97, "23.976")
SRC_FPS = (24.0, 25.0, 30.0, 48.0, 50.0, 60.0, 100.0, 120.0)
RATIOS = ((60, 30), (60, 24), (60, 20), (60, 15), (30, 24), (50, 15), (25, 15), (24, 15),
          (24, 8), (24, 6))


@pytest.mark.parametrize("src", SRC_FPS)
def test_resolve_fps_spec_equals_reference(src):
    for spec in SPECS:
        try:
            want = jfps.resolve_fps_spec(spec, src)
        except JConfigError:
            with pytest.raises(ConfigError):
                tfps.resolve_fps_spec(spec, src)
        else:
            assert tfps.resolve_fps_spec(spec, src) == want, (spec, src)


@pytest.mark.parametrize("src,dst", RATIOS)
def test_select_tables_and_indices_array_equal(src, dst):
    assert tfps.select_table(src, dst) == jfps.select_table(src, dst)
    for n in (0, 1, 7, 240, 241):
        got = tfps.select_indices(n, src, dst)
        np.testing.assert_array_equal(got, jfps.select_indices(n, src, dst))
    np.testing.assert_array_equal(tfps.select_indices(9, src, src), np.arange(9))


def test_select_tables_match_the_reference_expressions():
    """The reference's hand-built select expressions (lib/ffmpeg.py:806-832),
    evaluated symbolically, against the port's tables (as
    tests/test_ops.py test_select_tables_match_reference does for JAX)."""
    cases = {
        (60, 30): lambda n: (n + 1) % 2 != 0,
        (60, 24): lambda n: (n % 5 == 0) or ((n - 3) % 5 == 0),
        (60, 20): lambda n: n % 3 == 0,
        (60, 15): lambda n: n % 4 == 0,
        (30, 24): lambda n: (n + 1) % 5 != 0,
        (50, 15): lambda n: (n % 10 == 0) or ((n - 3) % 10 == 0) or ((n - 7) % 10 == 0),
        (25, 15): lambda n: (n % 5 == 0) or ((n - 3) % 5 == 0) or ((n - 2) % 5 == 0),
        (24, 15): lambda n: any((n - o) % 8 == 0 for o in (0, 3, 2, 5, 6)),
    }
    for (src, dst), expr in cases.items():
        got = set(tfps.select_indices(240, src, dst).tolist())
        assert got == {n for n in range(240) if expr(n)}, f"{src}->{dst}"


def test_unsupported_ratio_raises_in_both():
    for src, dst in ((60, 45), (30, 29), (24, 23)):
        with pytest.raises(JConfigError):
            jfps.select_table(src, dst)
        with pytest.raises(ConfigError, match="not supported"):
            tfps.select_table(src, dst)


def _ragged_chunks(n, seed, as_tensor):
    rng = np.random.default_rng(seed)
    y = np.arange(n, dtype=np.uint8).reshape(n, 1, 1) * np.ones((1, 2, 3), np.uint8)
    u = (255 - np.arange(n, dtype=np.uint8)).reshape(n, 1, 1) * np.ones((1, 1, 2), np.uint8)
    chunks, i = [], 0
    while i < n:  # ragged chunks cross the tables' cycle boundaries
        step = int(rng.integers(1, 17))
        chunks.append([y[i:i + step], u[i:i + step]])
        i += step
    if as_tensor:
        return chunks, [[torch.from_numpy(p) for p in c] for c in chunks]
    return chunks, chunks


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("src,dst", RATIOS + ((60, 60),))
def test_stream_select_equals_reference(src, dst, as_tensor):
    """The streaming select keeps exactly the reference's frames, chunk by
    chunk (empty chunks dropped), for numpy chunks and for tensors."""
    ref_chunks, chunks = _ragged_chunks(97, src + dst, as_tensor)
    want = list(jfps.stream_select(iter(ref_chunks), src, dst))
    got = list(tfps.stream_select(iter(chunks), src, dst))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), b)
    kept = np.concatenate([np.asarray(c[0])[:, 0, 0] for c in got])
    np.testing.assert_array_equal(kept, tfps.select_indices(97, src, dst))


@pytest.mark.parametrize("n,src,dst", [(24, 24.0, 60.0), (60, 60.0, 24.0), (100, 30.0, 29.97),
                                       (1, 25.0, 50.0), (0, 30.0, 60.0)])
def test_fps_resample_indices_array_equal(n, src, dst):
    np.testing.assert_array_equal(tfps.fps_resample_indices(n, src, dst),
                                  jfps.fps_resample_indices(n, src, dst))
