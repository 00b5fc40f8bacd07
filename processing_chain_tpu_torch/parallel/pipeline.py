"""Host→device transfer pipeline, the single-device flagship step and
the batch metrics step (port of processing_chain_tpu/parallel/
pipeline.py:100-153 and :218-236: `iter_device_ahead`, `avpvs_siti_step`
and `make_batch_metrics_step`). The sharded (pvs, time) steps are not
ported yet."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import metrics as metrics_ops
from ..ops import resize as resize_ops
from ..ops import siti as siti_ops
from ..utils.device import resolve_device

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


def make_batch_metrics_step(mesh):
    """Per-frame PSNR and SSIM of a [B, T, H, W] reference batch against a
    degraded one (BASELINE config 4): `step(ref, deg)` → (psnr [B, T],
    ssim [B, T]) on the mesh's device. Frames are independent, so the
    port's one-device mesh scores the batch as one stack of B·T frames."""

    def step(ref: torch.Tensor, deg: torch.Tensor):
        ref = ref.to(mesh.device)
        deg = deg.to(mesh.device)
        b, t = ref.shape[0], ref.shape[1]
        r = ref.reshape((-1,) + tuple(ref.shape[2:]))
        d = deg.reshape((-1,) + tuple(deg.shape[2:]))
        psnr = metrics_ops.psnr_frames(r, d).reshape(b, t)
        ssim = metrics_ops.ssim_frames(r, d).reshape(b, t)
        return psnr, ssim

    return step
