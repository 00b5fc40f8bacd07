"""The (pvs, time) device mesh of the chain (port of
processing_chain_tpu/parallel/mesh.py).

The JAX package lays the PVS batch ("pvs", data parallelism) and the frame
time ("time", sequence parallelism with a one-frame TI halo) over a 2-D
`jax.sharding.Mesh`. The port's mesh is a grid of slots, `[n_pvs][n_time]`,
each slot a `(rank, torch.device)`:

  * In one process the slots are local devices. Distinct cards are
    allowed, and a device may repeat (`["cuda:0"] * 4` with
    `time_parallel=2` is a 2x2 grid on one card, the counterpart of the
    JAX tests' forced 8-device CPU host).
  * With a `torch.distributed` process group the grid spans ranks: every
    rank passes its own local devices, and the grid takes them in rank
    order (the order of `jax.devices()` across processes).

Steps run with shard-map semantics but launch per device, not per slot
(`BlockLayout`): a `[B, T, ...]` block is cut into rows, row `(b, t)`
being lane b's t-th time chunk, and all rows whose slots sit on one
device run there as one flattened batch. `BlockLayout.split` and `join`
take the place of the JAX package's `batch_sharding` and
`scalar_sharding`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Slot:
    rank: int
    device: torch.device


@dataclass(frozen=True)
class Mesh:
    """`grid[p][t]` is the Slot of pvs index p and time index t; `rank` is
    this process's rank and `group` the process group the grid spans
    (None within one process)."""

    grid: tuple
    rank: int = 0
    group: object = None

    @property
    def shape(self) -> dict:
        return {"pvs": len(self.grid), "time": len(self.grid[0])}

    @property
    def devices(self) -> tuple:
        """The devices of this rank's slots, in row-major slot order."""
        return tuple(s.device for row in self.grid for s in row if s.rank == self.rank)

    @property
    def device(self) -> torch.device:
        """This rank's first device: where joined step outputs land."""
        return self.devices[0]

    def local_box(self) -> tuple:
        """(p0, p1, t0, t1): the rectangle of the grid this rank holds."""
        cells = [(p, t) for p, row in enumerate(self.grid)
                 for t, s in enumerate(row) if s.rank == self.rank]
        ps = [p for p, _ in cells]
        ts = [t for _, t in cells]
        return min(ps), max(ps) + 1, min(ts), max(ts) + 1


def make_mesh(devices: Optional[Sequence] = None, time_parallel: int = 1,
              group=None) -> Mesh:
    """Mesh over (pvs, time); `time_parallel` must divide the slot count.
    `devices` are this process's slots, `None` meaning every visible card
    (which raises without CUDA, through `resolve_device`). With `group`
    (a torch.distributed process group) every rank of it calls this with
    its own slots, and the grid spans the ranks in rank order; each rank's
    slots must form a rectangle of the grid."""
    if time_parallel < 1:
        raise ValueError(f"time_parallel={time_parallel} must be >= 1")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [resolve_device(f"cuda:{i}") for i in range(n)] or [resolve_device(None)]
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    rank = 0
    if group is None:
        slots = [Slot(0, d) for d in devs]
    else:
        import torch.distributed as dist

        rank = dist.get_rank(group)
        per_rank = [None] * dist.get_world_size(group)
        dist.all_gather_object(per_rank, [str(d) for d in devs], group=group)
        slots = [Slot(r, torch.device(d)) for r, names in enumerate(per_rank) for d in names]
    n = len(slots)
    if n % time_parallel:
        raise ValueError(f"time_parallel={time_parallel} does not divide {n} devices")
    grid = tuple(tuple(slots[p * time_parallel:(p + 1) * time_parallel])
                 for p in range(n // time_parallel))
    mesh = Mesh(grid, rank, group)
    p0, p1, t0, t1 = mesh.local_box()
    if sum(s.rank == rank for row in grid for s in row) != (p1 - p0) * (t1 - t0):
        raise ValueError(
            f"make_mesh: rank {rank}'s {len(devs)} slots are not a rectangle of "
            f"the {len(grid)}x{time_parallel} grid")
    return mesh


class BlockLayout:
    """Where each row of one rank's `[B, T, ...]` block lives on the mesh.
    The rank holds grid rows p0..p1 and columns t0..t1, so one pvs slot
    holds `bs = B / (p1 - p0)` lanes and one time slot `ts = T / (t1 - t0)`
    frames; row `(b, t)` (local lane b, local time chunk t) lies on the
    device of slot `(p0 + b // bs, t0 + t)`.
    `rows[d]` lists device d's rows in (b, t) order: a device block is
    `[len(rows[d]), ts, ...]`."""

    def __init__(self, mesh: Mesh, b: int, t: int) -> None:
        p0, p1, t0, t1 = mesh.local_box()
        n_p, n_t = p1 - p0, t1 - t0
        if b % n_p or t % n_t:
            raise ValueError(
                f"a [{b}, {t}] block does not split over this rank's {n_p}x{n_t} slots")
        self.mesh = mesh
        self.b, self.t = b, t
        self.bs, self.ts = b // n_p, t // n_t
        self.n_time = n_t
        self.t0 = t0
        self.rows: dict = {}
        self.index: dict = {}  # (b, t) -> (device, position in the device block)
        for lane in range(b):
            for k in range(n_t):
                dev = mesh.grid[p0 + lane // self.bs][t0 + k].device
                rows = self.rows.setdefault(dev, [])
                self.index[(lane, k)] = (dev, len(rows))
                rows.append((lane, k))
        # a device that holds whole lanes b0..b1 (every time chunk, in
        # order) takes its block as a view of the rank's block
        self._span = {}
        for dev, rows in self.rows.items():
            b0 = rows[0][0]
            b1 = b0 + len(rows) // n_t
            if rows == [(x, k) for x in range(b0, b1) for k in range(n_t)]:
                self._span[dev] = (b0, b1)

    @property
    def devices(self) -> list:
        return list(self.rows)

    def global_time(self, k: int) -> int:
        """The grid's time index of local time chunk k."""
        return self.t0 + k

    def split(self, x: torch.Tensor) -> dict:
        """`[B, T, ...]` → {device: `[rows, ts, ...]` on that device}: a view
        where the device holds whole lanes, else a copy of its rows."""
        rest = tuple(x.shape[2:])
        out = {}
        for dev, rows in self.rows.items():
            if dev in self._span:
                b0, b1 = self._span[dev]
                out[dev] = x[b0:b1].reshape((len(rows), self.ts) + rest).to(
                    dev, non_blocking=True)
            else:
                out[dev] = torch.empty((len(rows), self.ts) + rest, dtype=x.dtype,
                                       device=dev)
                self.scatter(x, {dev: out[dev]})
        return out

    def scatter(self, x: torch.Tensor, parts: dict) -> None:
        """Copy the rows of `[B, T, ...]` x into the device blocks `parts`."""
        for dev, part in parts.items():
            if dev in self._span:
                b0, b1 = self._span[dev]
                part.view((b1 - b0, self.t) + tuple(x.shape[2:])).copy_(
                    x[b0:b1], non_blocking=True)
            else:
                for i, (lane, k) in enumerate(self.rows[dev]):
                    part[i].copy_(x[lane, k * self.ts:(k + 1) * self.ts], non_blocking=True)

    def gather(self, parts: dict, out: torch.Tensor) -> None:
        """Copy the device blocks `parts` into their rows of `[B, T, ...]` out."""
        for dev, part in parts.items():
            if dev in self._span:
                b0, b1 = self._span[dev]
                out[b0:b1].copy_(part.view((b1 - b0, self.t) + tuple(out.shape[2:])),
                                 non_blocking=True)
            else:
                for i, (lane, k) in enumerate(self.rows[dev]):
                    out[lane, k * self.ts:(k + 1) * self.ts].copy_(part[i], non_blocking=True)

    def join(self, parts: dict, device=None) -> torch.Tensor:
        """{device: `[rows, ts, ...]`} → `[B, T, ...]` on `device` (default
        the mesh's first local device); a view where one device holds the
        whole block."""
        device = torch.device(device) if device is not None else self.mesh.device
        first = next(iter(parts.values()))
        rest = tuple(first.shape[2:])
        if len(parts) == 1 and self._span.get(next(iter(parts))) == (0, self.b):
            return first.reshape((self.b, self.t) + rest).to(device, non_blocking=True)
        out = torch.empty((self.b, self.t) + rest, dtype=first.dtype, device=device)
        self.gather(parts, out)
        return out
