"""Host→device transfer pipeline, the flagship step, its sharded form
and the batch metrics step (port of processing_chain_tpu/parallel/
pipeline.py: `_instrument_step` :49-97, `iter_device_ahead`,
`avpvs_siti_step`, `make_sharded_step` :156-215 and
`make_batch_metrics_step` :218-236).

The sharded steps run over a (pvs, time) mesh (parallel/mesh.py) with
shard-map semantics, launched per device: every device runs its rows of
the block as one flattened batch (3 resize launches, 1 fused SI+TI
launch), and the TI halo between time slots is parallel/halo.py's. A
change to the per-frame math must be applied to `avpvs_siti_step`,
`make_sharded_step` and parallel/p03_batch._wave_step alike.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from .. import telemetry as tm
from ..ops import metrics as metrics_ops
from ..ops import resize as resize_ops
from ..ops import siti as siti_ops
from ..telemetry.heartbeat import HEARTBEATS
from ..utils.device import resolve_device
from . import halo, meshobs
from .mesh import BlockLayout

_STEP_SECONDS = tm.histogram(
    "chain_device_step_seconds",
    "wall time of each device-step call, device compute included (the "
    "call blocks until its outputs are ready when telemetry is on; the "
    "first call of a step also covers building its kernels)",
    ("step",),
)

# pinned staging slots: one being filled by the host, one whose copy is in
# flight, one read by the chunk the consumer is computing
STAGING_SLOTS = 3


def _as_cpu_tensor(plane) -> torch.Tensor:
    if isinstance(plane, torch.Tensor):
        return plane
    return torch.from_numpy(np.ascontiguousarray(plane))


def iter_device_ahead(blocks, device=None):
    """Yield `(host_item, device_item)` pairs, where each item is a list of
    [T, H, W] planes (numpy arrays or CPU tensors) and the device item the
    same planes on `device`, with the NEXT item's host→device copy already
    issued before the current pair is handed to the consumer — so copy
    k+1 rides the copy engine while the consumer's compute on k is in
    flight.

    On CUDA each item is first copied by the host into a pinned staging
    slot, then copied to the device on a dedicated copy stream; the
    consumer's (current) stream waits on an event recorded after that
    copy before the pair is yielded. A staging slot is refilled only after
    an event the generator records on the consumer's stream when the
    consumer asks for the next pair — i.e. after the last compute that
    read the chunk staged there was queued — has completed. The host item
    itself is no longer read once it is staged, so the consumer may
    recycle it as soon as the pair is yielded. Device planes are allocated
    on the consumer's stream, and each copy first waits for the work
    already queued there, so the allocator cannot hand a copy a block
    that earlier compute still reads.

    On the CPU the planes are converted (no copy for CPU tensors) and
    yielded in order."""
    device = resolve_device(device)
    if device.type != "cuda":
        for item in blocks:
            yield item, [_as_cpu_tensor(p).to(device) for p in item]
        return

    compute = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device)
    staging = [None] * STAGING_SLOTS  # per slot: (pinned planes, released event)
    pending = None
    for n, item in enumerate(blocks):
        slot = n % STAGING_SLOTS
        host = [_as_cpu_tensor(p) for p in item]
        pinned = None
        if staging[slot] is not None:
            pinned, released = staging[slot]
            released.synchronize()
            if [(p.shape, p.dtype) for p in pinned] != [(h.shape, h.dtype) for h in host]:
                pinned = None
        if pinned is None:
            pinned = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True) for h in host]
        for dst, src in zip(pinned, host):
            dst.copy_(src)
        dev = [torch.empty(h.shape, dtype=h.dtype, device=device) for h in host]
        queued = torch.cuda.Event()
        queued.record(compute)
        ready = torch.cuda.Event()
        with torch.cuda.stream(copy):
            copy.wait_event(queued)
            for dst, src in zip(dev, pinned):
                dst.copy_(src, non_blocking=True)
            ready.record(copy)
        if pending is not None:
            yield from _hand_over(pending, compute, staging)
        pending = (item, dev, ready, slot, pinned)
    if pending is not None:
        yield from _hand_over(pending, compute, staging)


def _hand_over(pending, compute, staging):
    item, dev, ready, slot, pinned = pending
    compute.wait_event(ready)
    yield item, dev
    released = torch.cuda.Event()
    released.record(compute)
    staging[slot] = (pinned, released)


def avpvs_siti_step(
    y: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    dst_h: int,
    dst_w: int,
    prev_last: Optional[torch.Tensor] = None,
    kernel: str = "lanczos",
):
    """One AVPVS+features step on a [T, H, W] clip on one device: resize
    of luma and 4:2:0 chroma, SI and TI per frame of the resized luma
    (TI[0] against prev_last, the previous step's last frame, when given;
    else 0). Runs where the planes lie.

    Returns (up_y, up_u, up_v, si[T], ti[T])."""
    up_y = resize_ops.resize_plane(y, dst_h, dst_w, kernel)
    up_u = resize_ops.resize_plane(u, dst_h // 2, dst_w // 2, kernel)
    up_v = resize_ops.resize_plane(v, dst_h // 2, dst_w // 2, kernel)
    if prev_last is None:
        si, ti = siti_ops.siti(up_y)
    else:
        # a 1-lane batch with prev_last (at the luma's container depth) as
        # the predecessor frame, the wave step's feature pass
        si_b, ti_b = siti_ops.siti_batch(up_y[None], prev_last[None].to(up_y.dtype))
        si, ti = si_b[0], ti_b[0]
    return up_y, up_u, up_v, si, ti


def _sync_outputs(out) -> None:
    """Wait for the cards that hold the step's outputs."""
    for dev in {o.device for o in out if isinstance(o, torch.Tensor) and o.is_cuda}:
        torch.cuda.synchronize(dev)


def _instrument_step(fn, step: str):
    """Wrap a step so each call lands in the latency histogram and its first
    call in the event log and the step ledger. Transparent when telemetry
    is off (one flag check a call, no sync). When on, the call blocks until
    its outputs are ready: launches are asynchronous, and an unblocked
    timer would record the enqueue and charge the device work to whatever
    waits next; every caller fetches the outputs right after the step."""
    bound = _STEP_SECONDS.labels(step=step)
    state = {"first": True}

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not tm.enabled():
            return fn(*args, **kwargs)
        # in flight for the blocking call: a step stuck in a kernel build
        # or a wedged halo shows in /status with the step's name
        hb = HEARTBEATS.register(step, kind="device_step")
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            _sync_outputs(out)
        except BaseException:
            hb.finish("fail")
            raise
        hb.finish("ok")
        dur = time.perf_counter() - t0
        bound.observe(dur)
        if state["first"]:
            state["first"] = False
            tm.emit("device_step", step=step, first=True, duration_s=round(dur, 4))
            meshobs.RECORDER.record_compile(step, step=step, geometry={}, seconds=dur)
        return out

    return call


def make_sharded_step(mesh, dst_h: int, dst_w: int, kernel: str = "lanczos"):
    """The flagship step over the (pvs, time) mesh: `step(y, u, v)` with
    y `[B, T, H, W]` u8/u16 (u, v at chroma size) → (up_y, up_u, up_v,
    si [B, T], ti [B, T]), outputs joined on the mesh's first local
    device. Within one process the inputs are the whole batch; on a mesh
    spanning ranks, each rank passes and gets back its own block (the
    counterpart of `jax.make_array_from_process_local_data`).

    Each device resizes its rows as one flattened batch, then the halo
    gives every time slot's first frame the previous slot's last upscaled
    frame; the grid's first time slot takes its own first frame, so
    TI[:, 0] = 0. SI and TI run as one fused launch a device."""

    def step(y, u, v):
        lay = BlockLayout(mesh, y.shape[0], y.shape[1])
        parts = [lay.split(p) for p in (y, u, v)]
        dims = ((dst_h, dst_w), (dst_h // 2, dst_w // 2), (dst_h // 2, dst_w // 2))
        up = {}
        for dev in lay.devices:
            up[dev] = []
            for part, (h, w) in zip(parts, dims):
                flat = part[dev].reshape((-1,) + tuple(part[dev].shape[2:]))
                out = resize_ops.resize_plane(flat, h, w, kernel)
                up[dev].append(out.reshape(tuple(part[dev].shape[:2]) + (h, w)))

        def own_first(lane):
            dev, i = lay.index[(lane, 0)]
            return up[dev][0][i, 0]

        prev = halo.prev_frames(lay, {d: q[0][:, -1] for d, q in up.items()}, own_first)
        feats = {d: siti_ops.siti_batch(up[d][0], prev[d]) for d in lay.devices}
        planes = [lay.join({d: up[d][k] for d in lay.devices}) for k in range(3)]
        si = lay.join({d: f[0] for d, f in feats.items()})
        ti = lay.join({d: f[1] for d, f in feats.items()})
        return (*planes, si, ti)

    return _instrument_step(step, "sharded_avpvs_step")


def _pad_rows(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """`x` padded along `axis` to a multiple of `multiple` by repeating its
    last entry (frame-local steps only: pads are dropped afterwards)."""
    pad = -x.shape[axis] % multiple
    if not pad:
        return x
    last = x.narrow(axis, x.shape[axis] - 1, 1)
    return torch.cat([x, last.expand(*(pad if a == axis else -1 for a in range(x.ndim)))], axis)


def make_batch_metrics_step(mesh):
    """Per-frame PSNR and SSIM of a [B, T, H, W] reference batch against a
    degraded one (BASELINE config 4): `step(ref, deg)` → (psnr [B, T],
    ssim [B, T]) on the mesh's first device. Frames are independent (no
    halo): each device scores its rows of the (pvs, time) grid as one
    stack of frames, and a batch that does not divide the grid pads by
    repeating its last lane and frame, the pads dropped."""
    p0, p1, t0, t1 = mesh.local_box()

    def step(ref: torch.Tensor, deg: torch.Tensor):
        b, t = ref.shape[0], ref.shape[1]
        ref, deg = (_pad_rows(_pad_rows(x, 0, p1 - p0), 1, t1 - t0) for x in (ref, deg))
        lay = BlockLayout(mesh, ref.shape[0], ref.shape[1])
        refs, degs = lay.split(ref), lay.split(deg)
        psnr, ssim = {}, {}
        for dev in lay.devices:
            rows = tuple(refs[dev].shape[:2])
            r = refs[dev].reshape((-1,) + tuple(ref.shape[2:]))
            d = degs[dev].reshape((-1,) + tuple(deg.shape[2:]))
            psnr[dev] = metrics_ops.psnr_frames(r, d).reshape(rows)
            ssim[dev] = metrics_ops.ssim_frames(r, d).reshape(rows)
        return lay.join(psnr)[:b, :t], lay.join(ssim)[:b, :t]

    return _instrument_step(step, "batch_metrics_step")
