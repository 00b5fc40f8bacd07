"""The slice as a whole: the port's wave render (`parallel/p03_batch.
run_bucket` on a 4-slot CPU mesh) against the JAX package's `run_bucket`
on the 8-device CPU mesh with time_parallel=2. Both have t_step = 4 at
chunk=4, so their block boundaries are the same. Plus the host units of
the slice: `_rechunk`, `plan_waves`, `Prefetcher`, `BufferPool`,
`make_mesh` and the wave journal.

u8 planes must be identical, u16 planes within one code value; SI/TI from
`emit_features` within atol 1e-3 (1e-2 for u16), rtol 1e-4; the meshobs
slot totals and the wave schedule equal."""

import threading

import numpy as np
import pytest
import torch

from processing_chain_tpu.io import bufpool as jbufpool
from processing_chain_tpu.parallel import make_mesh as jmake_mesh
from processing_chain_tpu.parallel import meshobs as jmeshobs
from processing_chain_tpu.parallel import p03_batch as jb
from processing_chain_tpu_torch.engine.prefetch import Prefetcher
from processing_chain_tpu_torch.io import bufpool as tbufpool
from processing_chain_tpu_torch.models import avpvs as ta
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.parallel import mesh as tmesh
from processing_chain_tpu_torch.parallel import meshobs as tmeshobs
from processing_chain_tpu_torch.parallel import p03_batch as tb

SH, SW, DH, DW = 36, 64, 72, 128


@pytest.fixture(autouse=True)
def detached_journals():
    yield
    jmeshobs.detach_journal()
    tmeshobs.detach_journal()


def _sources(lengths, ten_bit, seed):
    rng = np.random.default_rng(seed)
    dtype, hi = (np.uint16, 1023) if ten_bit else (np.uint8, 255)
    return [
        [rng.integers(0, hi + 1, s).astype(dtype)
         for s in ((n, SH, SW), (n, SH // 2, SW // 2), (n, SH // 2, SW // 2))]
        for n in lengths
    ]


def _run(pkg, srcs, mesh, ten_bit, journal, ragged=True):
    """One run_bucket of `pkg` over the sources, delivered in ragged
    sub-chunks; returns per lane (planes, si, ti)."""
    outs = {i: [] for i in range(len(srcs))}
    feats = {i: [] for i in range(len(srcs))}
    lanes = []
    for i, yuv in enumerate(srcs):
        n = yuv[0].shape[0]
        parts = ([[p[:3] for p in yuv], [p[3:] for p in yuv]]
                 if ragged and n > 3 else [yuv])
        lanes.append(pkg.Lane(
            chunks=iter(parts), emit=outs[i].append, n_frames_hint=n,
            emit_features=lambda s, t, i=i: feats[i].append((s, t)),
            name=f"lane{i:02d}",
        ))
    obs = jmeshobs if pkg is jb else tmeshobs
    obs.attach_journal(str(journal), replica="r0")
    bucket = pkg.bucket_label(DH, DW, ten_bit, SH, SW)
    pkg.run_bucket(lanes, mesh, DH, DW, "bicubic", (2, 2), ten_bit,
                   chunk=4, bucket=bucket)
    obs.detach_journal()
    res = []
    for i in range(len(srcs)):
        planes = [np.concatenate([np.asarray(b[p]) for b in outs[i]]) for p in range(3)]
        si = np.concatenate([np.asarray(s) for s, _ in feats[i]])
        ti = np.concatenate([np.asarray(t) for _, t in feats[i]])
        res.append((planes, si, ti))
    return res, obs.aggregate(str(journal)), bucket


@pytest.mark.parametrize("ten_bit", [False, True])
def test_run_bucket_matches_jax(devices8, tmp_path, ten_bit):
    lengths = [11, 4, 2, 7, 5]  # 5 lanes on a 4-pvs mesh: two waves
    srcs = _sources(lengths, ten_bit, 7)
    tk.reset_launches()
    ours, tagg, bucket = _run(tb, srcs, tmesh.make_mesh(["cpu"] * 4), ten_bit,
                              tmp_path / "port")
    ref, jagg, _ = _run(jb, srcs, jmake_mesh(devices8, time_parallel=2), ten_bit,
                        tmp_path / "jax")
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}
    atol = 1e-2 if ten_bit else 1e-3
    for i, (n, (planes, si, ti), (rplanes, rsi, rti)) in enumerate(zip(lengths, ours, ref)):
        for a, b in zip(planes, rplanes):
            assert a.shape == b.shape and a.shape[0] == n and a.dtype == b.dtype
            if ten_bit:
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            else:
                np.testing.assert_array_equal(a, b)
        assert si.shape == ti.shape == (n,) and ti[0] == 0.0
        if not ten_bit:
            np.testing.assert_allclose(si, rsi, rtol=1e-4, atol=atol)
            np.testing.assert_allclose(ti, rti, rtol=1e-4, atol=atol)
        # batch vs single: the lane rendered alone through pump_ready
        feat = ta.SiTiAccumulator()
        chunks = [[p[k:k + 4] for p in srcs[i]] for k in range(0, n, 4)]
        ta.pump_ready(iter(chunks), _Drop(), feat, DH, DW,
                      "yuv420p10le" if ten_bit else "yuv420p", device="cpu")
        np.testing.assert_allclose(si, torch.cat(feat.si).numpy(), rtol=1e-4, atol=atol)
        np.testing.assert_allclose(ti, torch.cat(feat.ti).numpy(), rtol=1e-4, atol=atol)
    assert tagg["invariant_violations"] == jagg["invariant_violations"] == 0
    for key in ("waves", "valid", "pad_tail", "pad_exhausted", "pad_mesh", "dispatched"):
        assert tagg["totals"][key] == jagg["totals"][key], key
    assert tagg["totals"]["valid"] == sum(lengths)
    sched = [e["lanes"] for e in tagg["schedule"][bucket]]
    assert sched == [e["lanes"] for e in jagg["schedule"][bucket]]
    assert sched == [["lane00", "lane03", "lane04", "lane01"], ["lane02"]]


class _Drop:
    def put(self, planes, recycle=None):
        pass


def test_ten_bit_many_wave_lanes_match_jax(devices8, tmp_path):
    """Mirrors test_p03_batch_ten_bit_and_many_wave_lanes: 16 10-bit lanes
    on a 4-wide pvs mesh run as 4 waves, each lane intact."""
    lengths = [3 + (i % 5) for i in range(16)]
    srcs = _sources(lengths, True, 8)
    mesh = tmesh.make_mesh(["cpu"] * 4)
    assert tb.wave_count(16, mesh) == 4
    ours, tagg, _ = _run(tb, srcs, mesh, True, tmp_path / "port", ragged=False)
    ref, jagg, _ = _run(jb, srcs, jmake_mesh(devices8, time_parallel=2), True,
                        tmp_path / "jax", ragged=False)
    for n, (planes, si, ti), (rplanes, _, _) in zip(lengths, ours, ref):
        assert planes[0].dtype == np.uint16 and planes[0].shape == (n, DH, DW)
        for a, b in zip(planes, rplanes):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        si_ref, ti_ref = tk.siti_frames_plain(torch.from_numpy(planes[0]))
        np.testing.assert_allclose(si, si_ref.numpy(), rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(ti, ti_ref.numpy(), rtol=1e-4, atol=1e-2)
        assert ti[0] == 0.0
    for key in ("waves", "valid", "pad_tail", "pad_exhausted", "pad_mesh"):
        assert tagg["totals"][key] == jagg["totals"][key], key


def test_one_geometry_flip_one_new_step(tmp_path):
    """Bucket A -> B -> A: one step-ledger entry per geometry. Geometries
    are unique to this test: the step cache is process-wide."""
    mesh = tmesh.make_mesh(["cpu"] * 4)
    geoms = [(60, 104), (84, 152), (60, 104)]
    tmeshobs.attach_journal(str(tmp_path), replica="t0")
    for dh, dw in geoms:
        srcs = _sources([3, 2], False, 9)
        lanes = [tb.Lane(chunks=iter([yuv]), emit=lambda p: None,
                         n_frames_hint=yuv[0].shape[0]) for yuv in srcs]
        tb.run_bucket(lanes, mesh, dh, dw, "bicubic", (2, 2), False, chunk=4,
                      bucket=tb.bucket_label(dh, dw, False, SH, SW))
    tmeshobs.detach_journal()
    agg = tmeshobs.aggregate(str(tmp_path))
    assert agg["invariant_violations"] == 0
    for dh, dw in set(geoms):
        assert agg["buckets"][tb.bucket_label(dh, dw, False, SH, SW)]["recompiles"] == 1
    assert agg["totals"]["recompiles"] == 2
    compiles = [r for r in tmeshobs.read_journals(str(tmp_path)) if r["kind"] == "compile"]
    assert sorted((r["geometry"]["dst_h"], r["geometry"]["dst_w"]) for r in compiles) \
        == sorted(set(geoms))


def test_emitted_planes_are_never_overwritten_and_on_done_fires():
    """Every block's emit is kept; later blocks must not change earlier
    ones (fresh host memory per block), and on_done fires once per lane."""
    srcs = _sources([9, 2], False, 10)
    kept, done = {0: [], 1: []}, []
    lanes = [tb.Lane(chunks=iter([yuv]), emit=kept[i].append,
                     n_frames_hint=yuv[0].shape[0], on_done=lambda i=i: done.append(i))
             for i, yuv in enumerate(srcs)]
    tb.run_bucket(lanes, tmesh.make_mesh(["cpu"] * 2), DH, DW, chunk=4)
    for i, yuv in enumerate(srcs):
        want = tk.resize_frames_plain(torch.from_numpy(yuv[0]), DH, DW, "bicubic").numpy()
        np.testing.assert_array_equal(np.concatenate([b[0] for b in kept[i]]), want)
    assert sorted(done) == [0, 1]


def test_identity_geometry_emits_copies_not_staging_views():
    """Same size in and out: the resize passes its input through, so the
    emitted planes must still be memory the wave loop never refills."""
    srcs = _sources([12], False, 11)
    kept = []
    tb.run_bucket([tb.Lane(chunks=iter([srcs[0]]), emit=kept.append)],
                  tmesh.make_mesh(["cpu"]), SH, SW, chunk=4)
    for p in range(3):
        np.testing.assert_array_equal(np.concatenate([b[p] for b in kept]), srcs[0][p])


def test_lane_source_error_surfaces():
    def broken():
        yield _sources([4], False, 12)[0]
        raise OSError("decode failed")

    lane = tb.Lane(chunks=broken(), emit=lambda p: None)
    with pytest.raises(OSError, match="decode failed"):
        tb.run_bucket([lane], tmesh.make_mesh(["cpu"]), DH, DW, chunk=4)


# ---------------------------------------------------------------------------
# host units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [[3, 5, 4, 1], [4, 4], [2], [7, 9, 3]])
def test_rechunk_matches_jax(sizes):
    rng = np.random.default_rng(sum(sizes))
    chunks = [[rng.integers(0, 256, (n, 4, 6)).astype(np.uint8) for _ in range(3)]
              for n in sizes]
    ours = list(tb._rechunk(iter(chunks), 4, pool=tbufpool.BufferPool()))
    ref = list(jb._rechunk(iter(chunks), 4, pool=jbufpool.BufferPool()))
    assert [v for _, v in ours] == [v for _, v in ref]
    for (a, _), (b, _) in zip(ours, ref):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


def test_rechunk_pooled_blocks_copy_and_release():
    """A misaligned pooled chunk is copied and released at once; a full
    pooled block landing behind a remainder is released after the merge;
    an aligned pooled block passes through untouched."""
    pool = tbufpool.BufferPool()
    a = [pool.acquire((3, 2, 2)) for _ in range(3)]
    b = [pool.acquire((4, 2, 2)) for _ in range(3)]
    for k, arr in enumerate(a + b):
        arr[...] = k
    out = list(tb._rechunk(iter([a, b]), 4, pool=pool))
    assert [v for _, v in out] == [4, 3]
    assert not any(pool.owns(x) for x in a + b)
    assert not any(np.shares_memory(o, x) for blk, _ in out for o in blk for x in a + b)
    assert out[0][0][0][:3].tolist() == a[0].tolist()
    assert out[0][0][0][3].tolist() == b[0][0].tolist()
    c = [pool.acquire((4, 2, 2)) for _ in range(3)]
    (blk, n), = list(tb._rechunk(iter([c]), 4, pool=pool))
    assert n == 4 and all(x is y for x, y in zip(blk, c)) and pool.owns(c[0])


def test_plan_waves_matches_jax():
    buckets = {
        "A": [("p0", 0), ("p1", None), ("p0", 2), ("p2", None), ("p3", 0)],
        "B": [("p0", 1), ("p3", 1), ("p4", None)],
    }

    def group_of(e):
        return None if e[1] is None else (e[0], e[1])

    for n_pvs in (1, 2, 3, 4):
        assert tb.plan_waves(buckets, n_pvs) == jb.plan_waves(buckets, n_pvs)
        grouped = tb.plan_waves(buckets, n_pvs, group_of)
        assert grouped == jb.plan_waves(buckets, n_pvs, group_of)
        seqs = [e[1] for _, wave in grouped for e in wave if e[0] == "p0"]
        assert seqs == [0, 1, 2]


def test_prefetcher_reraises_source_error_at_next_pull():
    def source():
        yield 1
        yield 2
        raise ValueError("boom")

    got = []
    with Prefetcher(source(), depth=1) as pf, pytest.raises(ValueError, match="boom"):
        for item in pf:
            got.append(item)
    assert got == [1, 2]


def test_prefetcher_close_stops_worker():
    stop = threading.Event()

    def endless():
        k = 0
        while not stop.is_set():
            yield k
            k += 1

    pf = Prefetcher(endless(), depth=2)
    it = iter(pf)
    assert [next(it), next(it)] == [0, 1]
    pf.close()
    assert not pf._thread.is_alive()
    stop.set()


def test_bufpool_recycles_exact_blocks_only():
    pool = tbufpool.BufferPool()
    a = pool.acquire((2, 3), np.uint16)
    assert pool.owns(a) and not pool.owns(a[:1]) and not pool.owns(np.zeros(3))
    pool.release(a[:1], np.zeros(3), "x")
    assert pool.owns(a)
    pool.release(a)
    pool.release(a)  # double release: no-op
    assert pool.acquire((2, 3), np.uint16) is a
    assert pool.acquire((2, 3), np.uint16) is not a
    assert pool.acquire((3, 2), np.uint16) is not a  # keyed by shape


def test_make_mesh_shapes_and_refusals():
    mesh = tmesh.make_mesh(["cpu"] * 4)
    assert mesh.shape == {"pvs": 4, "time": 1} and mesh.device == torch.device("cpu")
    grid = tmesh.make_mesh(["cpu"] * 4, time_parallel=2)
    assert grid.shape == {"pvs": 2, "time": 2}
    assert [[s.device for s in row] for row in grid.grid] == [[torch.device("cpu")] * 2] * 2
    assert {s.rank for row in grid.grid for s in row} == {0}
    distinct = tmesh.make_mesh(["cpu", "meta"])
    assert distinct.shape == {"pvs": 2, "time": 1}
    assert distinct.devices == (torch.device("cpu"), torch.device("meta"))
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_mesh(["cpu"] * 4, time_parallel=3)
    with pytest.raises(ValueError):
        tmesh.make_mesh([])


def test_wave_journal_torn_tail_and_fields(tmp_path):
    """A torn final line costs one record; a new writer seals it; the
    records carry the JAX package's field names."""
    rec = tmeshobs.MeshRecorder()
    rec.attach_journal(str(tmp_path), replica="a/b")
    rec.record_wave("bk", wave=0, block=0, lanes=["x"], n_pvs=2, t_step=4,
                    valid=5, pad_tail=3, pad_exhausted=0, pad_mesh=0, step_s=0.5,
                    first=True)
    rec.close()
    path = tmp_path / "a_b.jsonl"
    with open(path, "a") as f:
        f.write('{"kind": "wave", "bro')
    rec2 = tmeshobs.MeshRecorder()
    rec2.attach_journal(str(tmp_path), replica="a/b")
    rec2.record_compile("bk", step="wave_step", geometry={"dst_h": 8}, seconds=0.25)
    rec2.close()
    records = tmeshobs.read_journal(str(path))
    assert [r["kind"] for r in records] == ["wave", "compile"]
    assert set(records[0]) == {
        "kind", "bucket", "wave", "block", "lanes", "n_pvs", "t_step", "valid",
        "pad_tail", "pad_exhausted", "pad_mesh", "dispatched", "step_s", "first",
        "ts", "replica", "pid", "seq"}
    agg = tmeshobs.aggregate(str(tmp_path))
    assert agg["totals"]["waste_fraction"] == tmeshobs.waste_fraction(
        {"dispatched": 8, "pad_tail": 3}) == 0.375
    assert rec.summary()["buckets"]["bk"]["waves"] == 1
