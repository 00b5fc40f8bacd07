"""The one-frame TI halo of the time split (the port's counterpart of
`lax.ppermute(last, "time", perm)` in processing_chain_tpu/parallel/
pipeline.py:196-201 and p03_batch.py:184-188).

TI of a time slot's first frame needs the previous time slot's last
frame. `prev_frames` gives every row of a step's block (parallel/mesh.
BlockLayout) its predecessor frame, at container depth:

  * a row at the grid's time index 0 takes `edge(lane)` (the lane's
    carried frame, or its own first frame where there is none);
  * a row whose predecessor row is on this rank takes that row's last
    frame: a slice on the same device, or a copy between cards, which
    torch orders after the work queued on both cards' current streams (an
    event each way), with no host sync;
  * a row whose predecessor is on another rank receives it: rank t-1
    sends and rank t receives, one message per peer, through
    `dist.batch_isend_irecv`. The JAX ring's wrap-around message is
    discarded by its `where`, so it is not sent. NCCL carries CUDA
    tensors and gloo CPU ones; a tensor on the other kind of group
    raises, and nothing is staged through the host on its own.
"""

from __future__ import annotations

import torch

from .distributed import record_collective
from .mesh import BlockLayout


def check_transport(x: torch.Tensor, group) -> None:
    """Raise unless `group`'s backend carries tensors of `x`'s device: NCCL
    CUDA tensors, gloo CPU ones."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if x.is_cuda and backend == "gloo":
        raise ValueError(
            "halo: a CUDA tensor on a gloo process group; join the group over "
            "NCCL (parallel/distributed.initialize on a card) to exchange card "
            "tensors")
    if not x.is_cuda and backend == "nccl":
        raise ValueError(
            f"halo: a {x.device} tensor on an NCCL process group; NCCL carries "
            "CUDA tensors only")


def _exchange(layout: BlockLayout, last: dict) -> dict:
    """Send this rank's last frames to the next time slot's rank and
    receive the previous one's: {(lane, 0): frame} of the received rows."""
    mesh = layout.mesh
    if mesh.group is None:
        return {}
    import torch.distributed as dist

    p0, p1, t0, t1 = mesh.local_box()
    n_time = mesh.shape["time"]
    sends: dict = {}
    recvs: dict = {}
    for lane in range(layout.b):
        p = p0 + lane // layout.bs
        if t1 < n_time:
            dev, i = layout.index[(lane, layout.n_time - 1)]
            sends.setdefault(mesh.grid[p][t1].rank, []).append(last[dev][i])
        if t0 > 0:
            recvs.setdefault(mesh.grid[p][t0 - 1].rank, []).append(lane)
    if not sends and not recvs:
        return {}
    like = next(iter(last.values()))
    home = mesh.device
    ops = []
    for peer, frames in sorted(sends.items()):
        msg = torch.stack([f.to(home, non_blocking=True) for f in frames])
        check_transport(msg, mesh.group)
        ops.append(dist.P2POp(dist.isend, msg, peer, mesh.group))
    bufs = {}
    for peer, lanes in sorted(recvs.items()):
        bufs[peer] = torch.empty((len(lanes),) + tuple(like.shape[1:]),
                                 dtype=like.dtype, device=home)
        check_transport(bufs[peer], mesh.group)
        ops.append(dist.P2POp(dist.irecv, bufs[peer], peer, mesh.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    record_collective("halo", sum(op.tensor.numel() * op.tensor.element_size() for op in ops))
    out = {}
    for peer, lanes in recvs.items():
        for j, lane in enumerate(lanes):
            out[(lane, 0)] = bufs[peer][j]
    return out


def prev_frames(layout: BlockLayout, last: dict, edge) -> dict:
    """{device: `[rows, H, W]` predecessor frames} for the rows of
    `layout`. `last` is {device: `[rows, H, W]`}, each row's last frame;
    `edge(lane)` gives the frame before the grid's first time slot."""
    remote = _exchange(layout, last)
    out = {}
    for dev, rows in layout.rows.items():
        frames = []
        for lane, k in rows:
            if layout.global_time(k) == 0:
                f = edge(lane)
            elif k > 0:
                src, i = layout.index[(lane, k - 1)]
                f = last[src][i]
            else:
                f = remote[(lane, k)]
            frames.append(f.to(dev, non_blocking=True))
        out[dev] = torch.stack(frames)
    return out
