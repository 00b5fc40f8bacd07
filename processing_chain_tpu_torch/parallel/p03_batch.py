"""Batched wave render of p03's AVPVS rescale (port of
processing_chain_tpu/parallel/p03_batch.py).

The per-PVS rescale (device resize + bit-depth quantize + SI/TI of the
quantized luma) runs batched over a (pvs x time) mesh of one process
(parallel/mesh.py): lanes over "pvs", each block's frames over "time"
with a one-frame TI halo between time slots (parallel/halo.py). Each
device runs its slots' rows as one flattened batch. The padding and
bucketing policy is the JAX package's:

  * Lanes (PVS streams) batch together only when their full geometry
    matches, (src_h, src_w, dst_h, dst_w, pix_fmt): the bucket key.
  * The time axis is consumed in fixed steps of `t_step = t_loc x n_time`
    frames per lane; a lane's tail block is padded by REPEATING ITS LAST
    FRAME up to t_step. Pad outputs are dropped before the emit.
  * A lane that exhausts keeps riding the wave as a zero-filled slot whose
    outputs are discarded, until every lane of the wave finishes.
  * The batch axis pads up to the mesh's "pvs" size with zero lanes.

While telemetry is on, the wave loop counts its host<->device transfer
seconds and bytes (`chain_device_transfer_*{direction}`, the attribution
engine's transfer component) and, under a profile capture, records the
`transfer:device_put`, `device:wave_step` and `transfer:device_get` spans
of every block.
"""

from __future__ import annotations

import functools
import math
import time
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .. import telemetry as tm
from ..engine.prefetch import Prefetcher
from ..io import bufpool
from ..models import frames as fr
from ..ops import siti as siti_ops
from ..telemetry import profiling
from . import halo, meshobs
from .mesh import BlockLayout

_XFER_SECONDS = tm.counter(
    "chain_device_transfer_seconds_total",
    "host<->device transfer time in the wave loop (put = assembly into "
    "the staging buffer + issuing the copies, which overlap the in-flight "
    "step; get = fetch of ready outputs: issuing their copies and waiting "
    "for them after the step)", ("direction",),
)
_XFER_BYTES = tm.counter(
    "chain_device_transfer_bytes_total",
    "host<->device bytes moved by the wave loop (put: the staged input "
    "planes; get: the five outputs)", ("direction",),
)
_XFER_PUT_S = _XFER_SECONDS.labels(direction="put")
_XFER_GET_S = _XFER_SECONDS.labels(direction="get")
_XFER_PUT_B = _XFER_BYTES.labels(direction="put")
_XFER_GET_B = _XFER_BYTES.labels(direction="get")


@dataclass
class Lane:
    """One PVS stream through the batch: decoded chunks in, scaled frames
    out. `chunks` yields [y, u, v] plane stacks ([T, H, W] numpy arrays,
    chroma at its subsampled size); `emit` receives the scaled/quantized
    host planes of each block, already trimmed to the valid frame count,
    in memory the wave loop never writes again; `emit_features` (optional)
    receives the per-frame (si, ti) numpy arrays of the same frames."""

    chunks: Iterable[list]
    emit: Callable[[list], None]
    n_frames_hint: int = 0  # for wave grouping only; 0 = unknown
    emit_features: Optional[Callable[[np.ndarray, np.ndarray], None]] = None
    #: called once, after the lane's LAST real frames have been emitted
    on_done: Optional[Callable[[], None]] = None
    #: identity in the wave journal (parallel/meshobs.py); empty =
    #: positional "lane<i>"
    name: str = ""


def _rechunk(
    chunks: Iterable[list], t_step: int, pool=None,
) -> Iterator[tuple[list, int]]:
    """Re-chunk a variable-size chunk stream into exact t_step blocks.
    Yields (planes, valid): the tail block pads by repeating the last
    frame, valid < t_step.

    Chunks already sized t_step pass through untouched, so a pooled decode
    block reaches the wave assembler without a copy; misaligned streams
    accumulate via concatenate, with consumed source chunks released back
    to the pool (release ignores views and foreign arrays)."""
    pool = pool or bufpool.DEFAULT_POOL
    buf: Optional[list] = None
    for ch in chunks:
        ch = [np.asarray(p) for p in ch]
        if buf is None:
            if ch[0].shape[0] == t_step:
                yield ch, t_step
                continue
            if any(pool.owns(p) for p in ch):
                # misaligned pooled chunk: slicing it into views below
                # would strand the block (release ignores views), so take
                # a private copy and recycle the block now
                buf = [np.array(p) for p in ch]
                pool.release(*ch)
            else:
                buf = ch
        else:
            merged = [np.concatenate([b, c]) for b, c in zip(buf, ch)]
            # buf is never pool-owned here (the first-chunk branch copies
            # and releases pooled arrivals); ch can be
            pool.release(*ch)
            buf = merged
        while buf is not None and buf[0].shape[0] >= t_step:
            if buf[0].shape[0] == t_step:
                yield buf, t_step
                buf = None
            else:
                yield [b[:t_step] for b in buf], t_step
                buf = [b[t_step:] for b in buf]
    if buf is not None and buf[0].shape[0] > 0:
        n = buf[0].shape[0]
        pad = t_step - n
        yield [
            np.concatenate([b, np.repeat(b[-1:], pad, axis=0)]) for b in buf
        ], n


@functools.cache
def _wave_step(dst_h: int, dst_w: int, kernel: str,
               sub_h: int, sub_w: int, ten_bit: bool):
    """The wave step of one geometry (counterpart of the JAX package's
    `_sharded_resize_step`): `step(layout, planes, carry, first)` takes
    the Y, U and V device blocks of a [B, T, H, W] u8/u16 block
    (`planes[k]` is {device: [rows, ts, H, W]}, parallel/mesh.BlockLayout)
    and returns {device: [qy, qu, qv, si, ti]}: the scaled and quantized
    planes of its rows plus SI/TI [rows, ts] of the quantized luma.

    Each device runs its rows as one flattened batch: one resize launch a
    plane, then, once every device has quantized, the halo (parallel/halo)
    gives each row its predecessor frame (the previous time slot's last
    frame; `carry[lane]`, the lane's last frame of the previous block, for
    the first time slot), and one fused SI+TI launch a device. TI of the
    lane's first frame is 0 on its first block (`first`). Cached per
    geometry: the step's identity is the step ledger's key."""

    def step(layout, planes, carry, first: bool):
        out = {}
        for dev in layout.devices:
            y, u, v = (p[dev] for p in planes)
            rows, t = y.shape[0], y.shape[1]
            scaled = fr.scale_yuv_frames(
                [p.reshape((-1,) + tuple(p.shape[2:])) for p in (y, u, v)],
                dst_h, dst_w, kernel, (sub_h, sub_w),
            )
            out[dev] = [q.reshape((rows, t) + tuple(q.shape[1:]))
                        for q in fr.quantize_device(scaled, ten_bit)]
        prev = halo.prev_frames(layout, {d: q[0][:, -1] for d, q in out.items()},
                                lambda lane: carry[lane])
        for dev, q in out.items():
            si, ti = siti_ops.siti_batch(q[0], prev[dev])
            if first:
                for i, (_, k) in enumerate(layout.rows[dev]):
                    if layout.global_time(k) == 0:
                        ti[i, 0] = 0.0  # the lane's first frame has no predecessor
            q += [si, ti]
        return out

    return step


def sort_lanes(lanes: list[Lane]) -> list[Lane]:
    """Longest-first so each wave groups similar lengths (minimizes the
    exhausted-lane waste of the padding policy)."""
    return sorted(lanes, key=lambda ln: -ln.n_frames_hint)


def plan_waves(buckets: dict, n_pvs: int, group_of=None) -> list:
    """Order bucketed lane entries into an executable wave schedule:
    ``[(bucket_key, [entry, ...]), ...]``, each wave ≤ `n_pvs` entries
    from ONE bucket (waves compile per geometry).

    `group_of(entry)` -> None or ``(group_id, seq)`` pins ordered groups
    — the fused long-test fan-outs, whose per-(PVS, segment) lanes must
    reach the fan-out in stream order. The guarantee: a group's entries
    appear in strictly increasing `seq` across the schedule, at most one
    per wave. Waves execute sequentially and a wave's lanes fully drain
    before the next wave starts (run_bucket), so schedule order IS
    delivery order — segment k+1's first frame cannot reach a fan-out
    before segment k's last (zero reorder buffering; models/fused
    SegmentOrderedTap enforces the same invariant at the consumer).

    With no `group_of` (or none pinned) this reduces exactly to the
    historical per-bucket slicing, same waves in the same order. Pinned
    groups may shrink waves below `n_pvs` (a deferred segment leaves its
    slot to batch-axis padding); meshobs pad accounting stays truthful
    automatically — `pad_mesh` records the burned slots.

    A group's segments may span buckets (long tests ladder through
    quality levels, so per-segment source geometry differs): the outer
    round-robin alternates buckets until every entry is scheduled.
    Always terminates — any round with pending entries schedules at
    least one wave (each group's head is pending in some bucket, and
    scanning that bucket either takes the head or fills a wave with
    other work; both are progress)."""
    if group_of is None:
        group_of = lambda e: None  # noqa: E731
    # per-group ascending seq queue: "next" = the group's smallest
    # unscheduled seq (robust to non-contiguous numbering)
    heads: dict = {}
    for entries in buckets.values():
        for e in entries:
            g = group_of(e)
            if g is not None:
                heads.setdefault(g[0], []).append(g[1])
    for q in heads.values():
        q.sort(reverse=True)  # pop() from the tail = ascending order
    pending = {key: list(entries) for key, entries in buckets.items()}
    out: list = []
    while True:
        progressed = False
        for key in list(pending):
            entries = pending[key]
            while entries:
                wave, rest, in_wave = [], [], set()
                for e in entries:
                    g = group_of(e)
                    if len(wave) >= n_pvs:
                        rest.append(e)
                    elif g is None:
                        wave.append(e)
                    elif g[0] not in in_wave and heads[g[0]][-1] == g[1]:
                        wave.append(e)
                        in_wave.add(g[0])
                        heads[g[0]].pop()
                    else:
                        rest.append(e)  # not this group's turn yet
                if not wave:
                    break
                out.append((key, wave))
                progressed = True
                entries = rest
            pending[key] = entries
        if not any(pending.values()):
            return out
        if not progressed:  # argued unreachable above; never spin
            stuck = sum(len(v) for v in pending.values())
            raise RuntimeError(
                f"plan_waves: no schedulable lane among {stuck} pending "
                "entries (inconsistent group_of sequencing?)"
            )


#: wave steps already dispatched at least once: the step ledger's
#: first-dispatch detector. `_wave_step` is cached, so each step lives for
#: the process and its id() is stable: one geometry flip = exactly one new
#: step.
_DISPATCHED_STEPS: set[int] = set()


def bucket_label(dst_h: int, dst_w: int, ten_bit: bool,
                 src_h: int = 0, src_w: int = 0) -> str:
    """Canonical bucket label for the wave journal. Callers that know the
    full bucket key pass the source geometry; the fallback labels by
    destination."""
    src = f"{src_h}x{src_w}" if src_h and src_w else "?"
    return f"{src}->{dst_h}x{dst_w}@{'10' if ten_bit else '8'}bit"


def run_bucket(
    lanes: list[Lane],
    mesh,
    dst_h: int,
    dst_w: int,
    kernel: str = "bicubic",
    chroma_sub: tuple[int, int] = (2, 2),
    ten_bit: bool = False,
    *,
    chunk: int,
    bucket: Optional[str] = None,
) -> None:
    """Drive one geometry bucket of lanes through the wave step in waves
    of the mesh's "pvs" size, on the mesh's devices. `chunk` is the frame
    budget per step across the time axis (t_step = t_loc x n_time, as in
    the JAX package). `bucket` labels the wave journal. The mesh is one
    process's: across processes, each takes its shard of the lanes
    (parallel/distributed.local_shard) onto a mesh of its own."""
    if mesh.group is not None:
        raise ValueError(
            "run_bucket drives one process's mesh; shard the lanes across "
            "ranks (parallel/distributed.local_shard) and give each its own mesh")
    n_pvs = mesh.shape["pvs"]
    n_time = mesh.shape["time"]
    t_loc = max(1, chunk // n_time)
    t_step = t_loc * n_time
    sub_h, sub_w = chroma_sub
    step = _wave_step(dst_h, dst_w, kernel, sub_h, sub_w, ten_bit)
    if bucket is None:
        bucket = bucket_label(dst_h, dst_w, ten_bit)
    # step ledger: a step never dispatched before lands its first block's
    # timing (which includes building the kernels on their first use) as
    # this bucket's ledger entry
    compile_state = {
        "pending": id(step) not in _DISPATCHED_STEPS,
        "geometry": {
            "dst_h": dst_h, "dst_w": dst_w, "kernel": kernel,
            "sub_h": sub_h, "sub_w": sub_w, "ten_bit": ten_bit,
            "t_step": t_step, "mesh": "x".join(
                str(v) for v in mesh.shape.values()),
        },
    }
    _DISPATCHED_STEPS.add(id(step))

    ordered = sort_lanes(lanes)
    for w0 in range(0, len(ordered), n_pvs):
        wave = ordered[w0: w0 + n_pvs]
        with ExitStack() as stack:
            # one decode-ahead thread per lane: the device step runs while
            # the next blocks decode
            iters = [
                iter(stack.enter_context(
                    Prefetcher(_rechunk(ln.chunks, t_step), depth=2)))
                for ln in wave
            ]
            _drive_wave(wave, iters, mesh, step, dst_h,
                        dst_w, ten_bit, bucket=bucket,
                        wave_index=w0 // n_pvs, t_step=t_step,
                        compile_state=compile_state,
                        lane_names=[ln.name or f"lane{w0 + i}"
                                    for i, ln in enumerate(wave)])


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _drive_wave(wave, iters, mesh, step,
                dst_h: int, dst_w: int, ten_bit: bool, *, bucket: str,
                wave_index: int, t_step: int, compile_state: dict,
                lane_names: list) -> None:
    """Overlapped wave loop: while the step for block k runs on the
    devices, the next block is pulled from the lane prefetchers, assembled
    into the OTHER of two [n_pvs, t_step, H, W] staging buffers (pinned
    when the mesh has a card) and each device's rows are copied to it on
    that device's copy stream; each device's compute stream waits on its
    copy's event before the step for block k+1.

    Stream and event discipline (as parallel/pipeline.iter_device_ahead):
    device blocks are allocated on the compute streams and each copy first
    waits for the work already queued there, so the allocator cannot hand
    a copy memory that earlier compute still reads; a staging buffer is
    refilled only after the events recorded after every copy that read it
    have completed; lane blocks go back to the pool once they are copied
    into staging. Outputs are fetched into fresh host memory per block
    (pinned on a card), so an emitted array is never overwritten. The TI
    carry (each lane's last quantized luma frame) stays on the devices at
    container depth."""
    pool = bufpool.DEFAULT_POOL
    n_pvs = mesh.shape["pvs"]
    layout = BlockLayout(mesh, n_pvs, t_step)
    cards = [d for d in layout.devices if d.type == "cuda"]
    compute = {d: torch.cuda.current_stream(d) for d in cards}
    copy = {d: torch.cuda.Stream(d) for d in cards}
    done = [False] * len(wave)
    notified = [False] * len(wave)

    def notify_done() -> None:
        # a lane's done flag flips while fetching the NEXT block, so by
        # the time the current block's emits ran, every real frame of a
        # done lane is out
        for i, ln in enumerate(wave):
            if done[i] and not notified[i]:
                notified[i] = True
                if ln.on_done is not None:
                    ln.on_done()

    dtype = torch.uint16 if ten_bit else torch.uint8
    carry = [torch.zeros((dst_h, dst_w), dtype=dtype, device=layout.index[(lane, 0)][0])
             for lane in range(n_pvs)]
    first = True
    staging: dict = {}  # parity -> (staging planes, events after their copies)
    state = {"parity": 0}

    def gather_put():
        """Pull one block per live lane, assemble it into this parity's
        staging buffer and issue each device's copy. Returns (device
        blocks, valids, ready events) or None once every lane is
        exhausted."""
        blocks: list[Optional[list]] = []
        valids: list[int] = []
        for i, it in enumerate(iters):
            blk = None if done[i] else next(it, None)
            if blk is None:
                done[i] = True
                blocks.append(None)
                valids.append(0)
            else:
                blocks.append(blk[0])
                valids.append(blk[1])
        if all(v == 0 for v in valids):
            return None
        tmpl = next(b for b in blocks if b is not None)
        parity = state["parity"]
        state["parity"] ^= 1
        bufs, released = staging.get(parity, (None, []))
        t_put = time.perf_counter() if tm.enabled() else 0.0
        with profiling.maybe_span("transfer:device_put"):
            if bufs is None:
                bufs = [torch.empty((n_pvs,) + tuple(p.shape),
                                    dtype=_torch_dtype(p.dtype), pin_memory=bool(cards))
                        for p in tmpl]
            for ev in released:
                ev.synchronize()  # the copies that last read bufs are done
            for p in range(3):
                dst = bufs[p]
                for i in range(n_pvs):
                    blk = blocks[i] if i < len(blocks) else None
                    if blk is None:
                        dst[i].zero_()  # exhausted lane / batch-axis padding
                    else:
                        dst[i].copy_(torch.from_numpy(blk[p]))
            # lane blocks are copied out: recycle them for the decoders
            for blk in blocks:
                if blk is not None:
                    pool.release(*blk)
            planes = [{d: torch.empty((len(rows), layout.ts) + tuple(b.shape[2:]),
                                      dtype=b.dtype, device=d)
                       for d, rows in layout.rows.items()} for b in bufs]
            ready = {}
            for d in layout.devices:
                if d.type != "cuda":
                    for b, part in zip(bufs, planes):
                        layout.scatter(b, {d: part[d]})
                    continue
                queued = torch.cuda.Event()
                queued.record(compute[d])
                ready[d] = torch.cuda.Event()
                with torch.cuda.stream(copy[d]):
                    copy[d].wait_event(queued)
                    for b, part in zip(bufs, planes):
                        layout.scatter(b, {d: part[d]})
                    ready[d].record(copy[d])
        if tm.enabled():
            _XFER_PUT_S.inc(time.perf_counter() - t_put)
            _XFER_PUT_B.inc(sum(b.nbytes for b in bufs))
        staging[parity] = (bufs, list(ready.values()))
        return planes, valids, ready

    mesh_label = "x".join(str(v) for v in mesh.shape.values())
    block = 0
    nxt = gather_put()
    while nxt is not None:
        planes, valids, ready = nxt
        valid = sum(valids)
        pad_tail = sum(t_step - v for v in valids if v)
        pad_exhausted = t_step * sum(1 for v in valids if not v)
        pad_mesh = (n_pvs - len(wave)) * t_step
        t0 = time.perf_counter()
        for d, ev in ready.items():
            compute[d].wait_event(ev)
        out = step(layout, planes, carry, first)
        # inter-block TI carry: the tail-repeat padding means the last
        # time slot's last frame is the lane's last REAL frame even on a
        # partial block; a copy, so the block's output can be freed
        for lane in range(n_pvs):
            d, i = layout.index[(lane, layout.n_time - 1)]
            carry[lane] = out[d][0][i, -1].clone()
        stepped = []  # with telemetry on: events after the step, before its fetch
        for d in compute if tm.enabled() else ():
            ev = torch.cuda.Event()
            ev.record(compute[d])
            stepped.append(ev)
        t_get = time.perf_counter()
        host, fetched = _fetch(layout, out, compute)
        get_s = time.perf_counter() - t_get
        # overlap: assemble and upload block k+1 while block k runs
        t_gather0 = time.perf_counter()
        nxt = gather_put()
        t_gather1 = time.perf_counter()
        if tm.enabled():
            with profiling.maybe_span(
                    "device:wave_step", bucket=bucket, wave=wave_index,
                    valid=valid, pad_tail=pad_tail,
                    pad_exhausted=pad_exhausted, pad_mesh=pad_mesh):
                for ev in stepped:
                    ev.synchronize()
            t_get = time.perf_counter()
            with profiling.maybe_span("transfer:device_get"):
                for ev in fetched:
                    ev.synchronize()
                host = [h.numpy() for h in host]
            _XFER_GET_S.inc(get_s + time.perf_counter() - t_get)
            _XFER_GET_B.inc(sum(h.nbytes for h in host))
        else:
            for ev in fetched:
                ev.synchronize()
            host = [h.numpy() for h in host]
        si_h, ti_h = host[3], host[4]
        # dispatch -> outputs-on-host wall seconds, the overlapped host
        # assembly of block k+1 excluded
        step_s = max(0.0, (time.perf_counter() - t0) - (t_gather1 - t_gather0))
        first_dispatch = compile_state["pending"]
        meshobs.RECORDER.record_wave(
            bucket, wave=wave_index, block=block, lanes=lane_names,
            n_pvs=n_pvs, t_step=t_step, valid=valid, pad_tail=pad_tail,
            pad_exhausted=pad_exhausted, pad_mesh=pad_mesh,
            step_s=step_s, first=first_dispatch, mesh=mesh_label)
        if first_dispatch:
            compile_state["pending"] = False
            meshobs.RECORDER.record_compile(
                bucket, step="wave_step",
                geometry=compile_state["geometry"], seconds=step_s)
        block += 1
        for i, ln in enumerate(wave):
            if valids[i]:
                ln.emit([h[i][: valids[i]] for h in host[:3]])
                if ln.emit_features is not None:
                    ln.emit_features(si_h[i][: valids[i]], ti_h[i][: valids[i]])
        # drop the loop's own references to this block's host outputs before
        # the next fetch: what no lane kept goes back to the pinned
        # allocator's cache and is reused, instead of pinning fresh memory
        del host, si_h, ti_h
        first = False
        notify_done()
    # every lane is exhausted once the loop ends (covers lanes that were
    # empty from the first gather)
    for i in range(len(done)):
        done[i] = True
    notify_done()


def _fetch(layout, out, compute):
    """(host tensors [B, T, ...] of the step's five outputs, events after
    their copies). Each card copies its rows into fresh pinned memory on
    its compute stream; CPU rows are joined on the host (a view where one
    CPU device holds the whole block)."""
    if not compute:
        return [layout.join({d: o[k] for d, o in out.items()}, "cpu")
                for k in range(5)], []
    first = next(iter(out.values()))
    host = [torch.empty((layout.b, layout.t) + tuple(o.shape[2:]), dtype=o.dtype,
                        pin_memory=True) for o in first]
    fetched = []
    for d, outs in out.items():
        for h, o in zip(host, outs):
            layout.gather({d: o}, h)
        if d in compute:
            ev = torch.cuda.Event()
            ev.record(compute[d])
            fetched.append(ev)
    return host, fetched


def wave_count(n_lanes: int, mesh) -> int:
    return math.ceil(n_lanes / mesh.shape["pvs"])
