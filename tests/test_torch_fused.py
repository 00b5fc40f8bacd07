"""The fused fan-out of the port (models/fused: the stall replay, the
context and preview pipelines, `FanoutStream`), the streaming gathers
(engine/prefetch) and the staged stalling loop (models/avpvs.
pump_stalled) against the JAX package on the CPU.

The slice as a whole: seeded chunks through the port's `pump_ready`,
then the fused route (StallStream → compositor → stalled writer and
context pipelines, all on the tensors `pump_ready` quantized) and the
staged route (plan_stalling + the monotonic gather + compositor). The
two must give identical stalled chunks with the frame count of JAX
`plan_stalling`, and both must equal the JAX package's chain on the same
AVPVS chunks: its gather and single-device compositor, then
`stream_fps_resample` + `_limit_frames` + its transform per context."""

import numpy as np
import pytest
import torch

from processing_chain_tpu.engine import prefetch as jpfe
from processing_chain_tpu.models import avpvs as jav
from processing_chain_tpu.models import cpvs as jcp
from processing_chain_tpu.models import fused as jfu
from processing_chain_tpu.ops import overlay as jov
from processing_chain_tpu_torch.config.domain import PostProcessing
from processing_chain_tpu_torch.engine import prefetch as tpfe
from processing_chain_tpu_torch.models import avpvs as tav
from processing_chain_tpu_torch.models import cpvs as tcp
from processing_chain_tpu_torch.models import fused as tfu
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.ops import overlay as tov
from test_fused import SKIP_CASES, STALL_CASES
from test_torch_cpvs import jax_plan
from test_torch_overlay import one_jax_device  # noqa: F401 - a fixture

SH, SW, DH, DW, T, CHUNKS, FPS = 48, 64, 96, 128, 8, 3, 60.0


class ListWriter:
    """Fake writer: fetches each chunk to host numpy."""

    def __init__(self):
        self.chunks = []
        self.closed = 0

    def put(self, planes, recycle=None):
        self.chunks.append([p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
                            for p in planes])

    def close(self):
        self.closed += 1

    def frames(self):
        return sum(c[0].shape[0] for c in self.chunks)


def assert_chunks_equal(ours, ref):
    assert [c[0].shape[0] for c in ours] == [c[0].shape[0] for c in ref]
    for a_chunk, b_chunk in zip(ours, ref):
        for a, b in zip(a_chunk, b_chunk):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ----------------------------------------------------------- the stall replay


@pytest.mark.parametrize("skipping", [False, True])
def test_streamed_stall_plan_matches_jax(skipping):
    for n, fps, events in SKIP_CASES if skipping else STALL_CASES:
        ours = tfu.streamed_stall_plan(n, fps, events, skipping=skipping)
        ref = jfu.streamed_stall_plan(n, fps, events, skipping=skipping)
        want = jov.plan_stalling(n, fps, events, skipping=skipping)
        for f in ("src_idx", "stall_mask", "black_mask", "phase"):
            assert np.array_equal(getattr(ours, f), getattr(ref, f))
            assert np.array_equal(getattr(ours, f), getattr(want, f)), (n, fps, events)


def test_streamed_stall_plan_randomized_matrix():
    rng = np.random.default_rng(7)
    for _ in range(120):
        n = int(rng.integers(0, 80))
        fps = float(rng.choice([23.976, 24.0, 30.0, 60.0]))
        skipping = bool(rng.integers(0, 2))
        events = [[float(rng.uniform(0, n / fps * 1.3 + 0.5)), float(rng.uniform(0, 1.0))]
                  for _ in range(int(rng.integers(0, 4)))]
        ours = tfu.streamed_stall_plan(n, fps, events, skipping=skipping)
        want = tov.plan_stalling(n, fps, events, skipping=skipping)
        for f in ("src_idx", "stall_mask", "black_mask", "phase"):
            assert np.array_equal(getattr(ours, f), getattr(want, f)), (n, fps, events)


@pytest.mark.parametrize("skipping,events", [
    (True, [[0.5, 1.0], [1.0, 0.5]]),
    (False, [[0.5, 0.25], [1.5, 0.5], [9.0, 0.2]]),
])
def test_stall_stream_binds_frames_like_jax_and_clones_anchors(skipping, events):
    fps, n = 24.0, 60
    frames = [[torch.full((2, 2), k, dtype=torch.uint8)] * 3 for k in range(n)]
    ours, ref = [], []
    stream = tfu.StallStream(fps, events, skipping,
                             emit=lambda planes, *rec: ours.append((int(planes[0][0, 0]), rec)))
    jstream = jfu.StallStream(fps, events, skipping,
                              emit=lambda planes, *rec: ref.append((int(planes[0][0, 0]), rec)))
    for f in frames:
        stream.feed(f)
        jstream.feed([p.numpy() for p in f])
    stream.finish()
    jstream.finish()
    assert ours == ref
    plan = jov.plan_stalling(n, fps, events, skipping=skipping)
    assert [v for v, _ in ours] == plan.src_idx.tolist()
    assert len(stream._retained) == len(stream._retain) <= 2
    for k, planes in stream._retained.items():  # clones, not views
        assert all(p.data_ptr() != f.data_ptr() for p, f in zip(planes, frames[k]))


# ---------------------------------------------------------- streaming gathers


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [tpfe.ChunkFrame([torch.from_numpy(rng.integers(0, 256, (4, 6)).astype(np.uint8))
                             for _ in range(3)]) for _ in range(n)]


def _np_frames(frames):
    return [tpfe.ChunkFrame([p.numpy() for p in f.planes]) for f in frames]


@pytest.mark.parametrize("n,chunk", [(0, 4), (1, 4), (13, 4), (30, 8)])
def test_stream_gathers_match_jax(n, chunk):
    frames = _frames(n, seed=n)
    idx = lambda k: k // 3 + (k % 5 == 0)  # noqa: E731 - nondecreasing
    for n_out in (None, 7, 40):
        ours = list(tpfe.stream_monotonic_gather(iter(frames), idx, n_out, chunk))
        ref = list(jpfe.stream_monotonic_gather(iter(_np_frames(frames)), idx, n_out, chunk))
        assert_chunks_equal([[p.numpy() for p in c] for c in ours], ref)
    for src, dst in ((60.0, 30.0), (60.0, 24.0), (24.0, 60.0), (29.97, 25.0)):
        ours = list(tpfe.stream_fps_resample(iter(frames), src, dst, chunk))
        ref = list(jpfe.stream_fps_resample(iter(_np_frames(frames)), src, dst, chunk))
        assert_chunks_equal([[p.numpy() for p in c] for c in ours], ref)


def test_iter_chunk_frames_unstacks_views():
    chunk = [torch.arange(24, dtype=torch.uint8).reshape(2, 3, 4)] * 3
    frames = list(tpfe.iter_chunk_frames([chunk, chunk]))
    assert len(frames) == 4 and frames[1].planes[0].data_ptr() == chunk[0][1].data_ptr()


# ------------------------------------------------------------ the pipelines

PC30 = {"type": "pc", "displayWidth": DW, "displayHeight": DH, "codingWidth": DW,
        "codingHeight": DH, "displayFrameRate": 30}
PC24 = {**PC30, "displayFrameRate": 24}
PC60 = {**PC30, "displayFrameRate": 60}
MOBILE = {"type": "mobile", "displayWidth": SW, "displayHeight": SH,
          "codingWidth": SW, "codingHeight": SH}


def _avpvs_chunks(pix_fmt, n_chunks=CHUNKS, t=T, seed=0):
    rng = np.random.default_rng(seed)
    hi, dtype = (1023, np.uint16) if "10" in pix_fmt else (255, np.uint8)
    return [[rng.integers(0, hi + 1, s).astype(dtype)
             for s in ((t, DH, DW), (t, DH // 2, DW // 2), (t, DH // 2, DW // 2))]
            for _ in range(n_chunks)]


def jax_context(chunks, plan, jpp, pix_fmt, rawvideo, chunk):
    """The JAX decode-driven CPVS render on in-memory chunks: the display
    rate resample, the `-t` cap, the transform."""
    out_rate = jcp.cpvs_out_rate(plan, FPS)
    if plan["fps"] is not None and plan["fps"] != FPS:
        frames = [tpfe.ChunkFrame([p[i] for p in c]) for c in chunks for i in range(len(c[0]))]
        chunks = jpfe.stream_fps_resample(iter(frames), FPS, plan["fps"], chunk)
    if plan["t"] is not None:
        chunks = jcp._limit_frames(chunks, jcp.t_cap_frames(plan["t"], out_rate))
    transform = jcp.make_cpvs_transform(plan, jpp, pix_fmt, rawvideo)
    return [[np.asarray(o) for o in transform(c)] for c in chunks]


@pytest.mark.parametrize("pp_data,rawvideo,t", [
    (PC60, False, None),   # 1:1 chunk path
    (PC30, False, None),   # 60 -> 30 fps resample
    (PC24, False, None),   # 60 -> 24
    (PC30, False, 0.3),    # resample + the -t cap (9 frames)
    (PC60, True, 0.2),     # 1:1 + the cap inside the second chunk
    (MOBILE, False, None),
])
@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le"])
def test_context_pipeline_matches_jax_resample_cap_transform(pp_data, rawvideo, t, pix_fmt):
    plan, jpp = jax_plan(pp_data, pix_fmt, rawvideo, avpvs_h=DH)
    plan["t"] = t
    chunks = _avpvs_chunks(pix_fmt, seed=len(str(pp_data)) + (t is not None))
    writer = ListWriter()
    pipe = tfu._ContextPipeline(writer, plan, PostProcessing(None, pp_data), pix_fmt, FPS,
                                rawvideo, chunk=T)
    for c in chunks:
        pipe.feed([torch.from_numpy(p) for p in c])
    pipe.finish()
    pipe.finish()
    assert writer.closed == 1
    ref = jax_context(chunks, plan, jpp, pix_fmt, rawvideo, T)
    assert_chunks_equal(writer.chunks, ref)
    n_src = CHUNKS * T
    want = round(n_src / FPS * plan["fps"]) if plan["fps"] else n_src
    if t is not None:
        want = min(want, tcp.t_cap_frames(t, tcp.cpvs_out_rate(plan, FPS)))
    assert writer.frames() == want


def test_preview_pipeline_matches_jax():
    chunks = _avpvs_chunks("yuv420p", seed=9)
    writer = ListWriter()
    pipe = tfu._PreviewPipeline(writer, "yuv420p")
    for c in chunks:
        pipe.feed([torch.from_numpy(p) for p in c])
    pipe.finish()
    ref = [[np.asarray(o) for o in jcp.make_preview_transform("yuv420p")(c)] for c in chunks]
    assert_chunks_equal(writer.chunks, ref)
    assert writer.closed == 1


# ------------------------------------------------------------ the slice


def _source_chunks(pix_fmt, seed):
    rng = np.random.default_rng(seed)
    hi, dtype = (1023, np.uint16) if "10" in pix_fmt else (255, np.uint8)
    out = []
    for c in range(CHUNKS):
        planes = []
        for ph, pw in ((SH, SW), (SH // 2, SW // 2), (SH // 2, SW // 2)):
            tt = np.arange(c * T, (c + 1) * T)[:, None, None]
            base = (np.arange(pw)[None, None, :] * 3 + np.arange(ph)[None, :, None] * 2
                    + tt * 5) % (hi + 1)
            noise = rng.integers(-20, 21, (T, ph, pw))
            planes.append(np.clip(base + noise, 0, hi).astype(dtype))
        out.append(planes)
    return out


CONTEXT_SETS = {  # (post-processing, rawvideo) per context
    "yuv420p": [(PC30, False), (MOBILE, False)],
    "yuv420p10le": [(PC60, False), (MOBILE, False)],
}


@pytest.mark.parametrize("pix_fmt,skipping,events", [
    ("yuv420p", False, [[0.1, 0.1], [0.3, 0.05]]),
    ("yuv420p", True, [[0.1, 0.1]]),
    ("yuv420p10le", True, [[0.1, 0.1], [0.15, 0.1]]),
    ("yuv420p10le", False, [[0.2, 0.1]]),
])
def test_fused_and_staged_routes_match_each_other_and_jax(one_jax_device, pix_fmt,
                                                          skipping, events):
    chunk = T
    contexts = []
    for pp_data, raw in CONTEXT_SETS[pix_fmt]:
        plan, jpp = jax_plan(pp_data, pix_fmt, raw, avpvs_h=DH)
        contexts.append((plan, jpp, PostProcessing(None, pp_data), raw))
    comp = tav.make_stall_compositor(pix_fmt, tav.DEFAULT_SPINNER, skipping, 64, device="cpu")

    # fused: pump_ready -> FanoutStream on the quantized tensors
    kept, stall_w = [], ListWriter()
    ctx_w = [ListWriter() for _ in contexts]
    preview_w = ListWriter()
    pipes = [tfu._ContextPipeline(w, plan, pp, pix_fmt, FPS, raw, chunk)
             for w, (plan, _, pp, raw) in zip(ctx_w, contexts)]
    pipes.append(tfu._PreviewPipeline(preview_w, pix_fmt))
    fan = tfu.FanoutStream(pipes, compositor=comp, stall_writer=stall_w, fps=FPS,
                          events=events, skipping=skipping, chunk=chunk)

    class Tee:
        def put(self, planes, recycle=None):
            kept.append(planes)
            fan.feed(planes)

    tk.reset_launches()
    tav.pump_ready(iter(_source_chunks(pix_fmt, seed=3)), Tee(), tav.SiTiAccumulator(),
                   DH, DW, pix_fmt, device="cpu")
    fan.finish_streams()
    fan.finish_streams()
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}
    assert stall_w.closed == preview_w.closed == 1 and all(w.closed == 1 for w in ctx_w)

    # staged: plan_stalling + the gather over the same frames
    n = CHUNKS * T
    plan = tov.plan_stalling(n, FPS, events, skipping=skipping)
    staged_w = ListWriter()
    tav.pump_stalled(tpfe.iter_chunk_frames(kept), plan, comp, staged_w, chunk)
    jplan = jov.plan_stalling(n, FPS, events, skipping=skipping)
    assert staged_w.frames() == stall_w.frames() == jplan.n_out
    assert_chunks_equal(stall_w.chunks, staged_w.chunks)

    # the JAX chain on the same AVPVS chunks
    avpvs = [[p.numpy() for p in c] for c in kept]
    frames = [tpfe.ChunkFrame([p[i] for p in c]) for c in avpvs for i in range(T)]
    jcomp = jav.make_stall_compositor(pix_fmt, tav.DEFAULT_SPINNER, skipping, 64)
    ref_stalled = []
    for k, g in enumerate(jpfe.stream_monotonic_gather(
            iter(frames), lambda i: int(jplan.src_idx[i]), jplan.n_out, chunk)):
        sl = slice(k * chunk, k * chunk + g[0].shape[0])
        ref_stalled.append([np.asarray(o) for o in jcomp(
            g, jplan.stall_mask[sl], jplan.black_mask[sl], jplan.phase[sl])])
    assert_chunks_equal(stall_w.chunks, ref_stalled)
    for w, (plan_c, jpp, _, raw) in zip(ctx_w, contexts):
        assert_chunks_equal(w.chunks, jax_context(ref_stalled, plan_c, jpp, pix_fmt, raw, chunk))
    preview = jcp.make_preview_transform(pix_fmt)
    assert_chunks_equal(preview_w.chunks,
                        [[np.asarray(o) for o in preview(c)] for c in ref_stalled])


def test_fanout_without_buffering_feeds_the_pipelines_directly():
    chunks = _avpvs_chunks("yuv420p", seed=4)
    plan, jpp = jax_plan(MOBILE, "yuv420p", False, avpvs_h=DH)
    writer = ListWriter()
    fan = tfu.FanoutStream([tfu._ContextPipeline(writer, plan, PostProcessing(None, MOBILE),
                                                "yuv420p", FPS, False, T)])
    for c in chunks:
        fan.feed([torch.from_numpy(p) for p in c])
    fan.finish_streams()
    assert_chunks_equal(writer.chunks, jax_context(chunks, plan, jpp, "yuv420p", False, T))


def test_fanout_abort_closes_every_writer_and_swallows_their_errors():
    class Failing(ListWriter):
        def close(self):
            super().close()
            raise OSError("disk full")

    stall_w, ctx_w = Failing(), Failing()
    plan, _ = jax_plan(PC60, "yuv420p", True, avpvs_h=DH)
    comp = tav.make_stall_compositor("yuv420p", None, True, 64, device="cpu")
    fan = tfu.FanoutStream(
        [tfu._ContextPipeline(ctx_w, plan, PostProcessing(None, PC60), "yuv420p", FPS, True, T)],
        compositor=comp, stall_writer=stall_w, fps=FPS, events=[[0.0, 0.1]], skipping=True)
    fan.feed([torch.from_numpy(p) for p in _avpvs_chunks("yuv420p", n_chunks=1)[0]])
    fan.abort()
    assert stall_w.closed == ctx_w.closed == 1
    fan.finish_streams()  # a no-op after abort
    assert stall_w.closed == 1


def test_avpvs_rate_rationalizes_like_the_writer():
    assert tfu.avpvs_rate(60.0) == 60.0
    assert tfu.avpvs_rate(59.94005994005994) == 60000 / 1001
