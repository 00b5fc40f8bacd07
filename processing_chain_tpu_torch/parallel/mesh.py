"""The (pvs, time) device mesh of the wave render (port of
processing_chain_tpu/parallel/mesh.py).

The JAX package lays the PVS batch ("pvs", data parallelism) and the frame
time ("time", sequence parallelism with a one-frame TI halo) over a 2-D
`jax.sharding.Mesh`. The port runs one device: its mesh is a list of
device slots, all on that device, whose "pvs" lanes share it as one
[n_pvs, T, H, W] batch. A list may repeat a device (`["cpu"] * 4`, the
counterpart of the JAX tests' forced 8-device CPU host). Several distinct
devices and `time_parallel > 1` are multi-GPU work (ROADMAP Queue A 14)
and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """`devices`: one torch.device per "pvs" slot, all the same device."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"pvs": len(self.devices), "time": 1}

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(devices: Optional[Sequence] = None, time_parallel: int = 1) -> Mesh:
    """Mesh over (pvs, time). `None` means every visible CUDA device (and
    raises without CUDA, through `resolve_device`)."""
    if time_parallel < 1:
        raise ValueError(f"time_parallel={time_parallel} must be >= 1")
    if time_parallel > 1:
        raise NotImplementedError(
            f"time_parallel={time_parallel}: the time split with its TI halo "
            "exchange is multi-GPU work, not ported yet (ROADMAP Queue A 14)"
        )
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [resolve_device(f"cuda:{i}") for i in range(n)] or [resolve_device(None)]
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"make_mesh over {len(set(devs))} distinct devices: multi-GPU "
            "meshes are not ported yet (ROADMAP Queue A 14)"
        )
    return Mesh(tuple(devs))
