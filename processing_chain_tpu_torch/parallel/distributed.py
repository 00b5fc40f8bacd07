"""Multi-process runtime of the port (port of
processing_chain_tpu/parallel/distributed.py on `torch.distributed`).

The JAX package joins a `jax.distributed` cluster; the port joins a
`torch.distributed` process group: NCCL when the process works on a card,
gloo when it works on the CPU. Where JAX reads JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID, the port reads torchrun's
variables: MASTER_ADDR and MASTER_PORT (the rendezvous address),
WORLD_SIZE, RANK and LOCAL_RANK (the card this process drives). PC_RUN_ID
and the filesystem stage barrier are the JAX package's. The host-level
fan-out of the PVS list becomes per-process shards of the work list
(`shard_pvs_list`, `local_shard`); a mesh spanning the ranks
(parallel/mesh.make_mesh with `group`) carries the time split's halo
between them (parallel/halo.py).
"""

from __future__ import annotations

import glob
import os
import re
import time
from typing import Optional

from .. import telemetry as tm
from ..config.errors import ConfigError
from ..telemetry.heartbeat import HEARTBEATS
from ..utils.fsio import atomic_write_text
from ..utils.log import get_logger

_COLLECTIVE_BYTES = tm.counter(
    "chain_dist_collective_bytes_total",
    "payload bytes of explicitly-recorded cross-process collectives "
    "(record_collective: the halo exchange and the callers that run "
    "their own collectives), by op",
    ("op",),
)
_BARRIER_SECONDS = tm.counter(
    "chain_dist_barrier_seconds_total",
    "seconds each host spent waiting in the filesystem stage barrier, "
    "by stage",
    ("stage",),
)


def record_collective(op: str, nbytes: int,
                      seconds: Optional[float] = None) -> None:
    """One cross-process collective, recorded by the caller that knows its
    payload: bytes land in chain_dist_collective_bytes_total and a
    `dist_collective` event."""
    _COLLECTIVE_BYTES.labels(op=op).inc(int(nbytes))
    fields = {"op": op, "bytes": int(nbytes)}
    if seconds is not None:
        fields["seconds"] = round(seconds, 6)
    tm.emit("dist_collective", **fields)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device=None) -> bool:
    """Join the process group from the arguments or torchrun's variables
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). Returns True
    when running distributed, False for one process. `device=None` means
    the card LOCAL_RANK (NCCL; raises without CUDA); `device="cpu"` joins
    over gloo."""
    import torch
    import torch.distributed as dist

    from ..utils.device import resolve_device

    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if not addr:
            return False
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    # plan-exempt: (process topology shards which host renders each lane; per-artifact bytes are topology-invariant)
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    # plan-exempt: (process topology shards which host renders each lane; per-artifact bytes are topology-invariant)
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if device is None:
        # plan-exempt: (picks the card a process joins NCCL on; the kernels produce the same bytes on every card)
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    init_s = time.perf_counter() - t0
    get_logger().info("distributed: process %d/%d over %s on %s",
                      rank, world_size, backend, dev)
    tm.emit("dist_init", process_id=rank, processes=world_size,
            backend=backend, device=str(dev), seconds=round(init_s, 3))
    return True


def shard_pvs_list(pvs_ids: list, process_id: int, num_processes: int) -> list:
    """Deterministic per-host shard of the PVS work list."""
    return [p for i, p in enumerate(sorted(pvs_ids)) if i % num_processes == process_id]


def process_topology() -> tuple[int, int]:
    """(rank, world size) of this process, (0, 1) when not running
    distributed. Reads the variables `initialize` reads, so stage drivers
    can shard without joining the group."""
    # plan-exempt: (process topology shards which host renders each lane; per-artifact bytes are topology-invariant)
    num = int(os.environ.get("WORLD_SIZE", "1") or 1)
    # plan-exempt: (process topology shards which host renders each lane; per-artifact bytes are topology-invariant)
    pid = int(os.environ.get("RANK", "0") or 0)
    if num <= 1:
        return 0, 1
    if not 0 <= pid < num:
        raise ConfigError(f"RANK {pid} out of range for {num} processes")
    return pid, num


def barrier_run_id() -> str:
    """The multi-host run namespace: a fresh `PC_RUN_ID` per run, the same
    on every host, so a barrier can tell this run's markers from an
    earlier run's."""
    # plan-exempt: (multi-host barrier namespace; no artifact byte depends on it)
    run_id = os.environ.get("PC_RUN_ID", "")
    if not run_id:
        raise ConfigError(
            "multi-host runs require PC_RUN_ID (a fresh shared id per run, "
            "e.g. a launch timestamp) so stage barriers can tell this "
            "run's markers from a previous run's"
        )
    if not re.fullmatch(r"[A-Za-z0-9._-]+", run_id):
        raise ConfigError(
            f"PC_RUN_ID {run_id!r} must be filename-safe ([A-Za-z0-9._-])"
        )
    return run_id


def fs_barrier_init(sync_dir: str) -> None:
    """Call once per host before the first stage: removes this host's own
    markers of the current run id."""
    pid, num = process_topology()
    if num == 1:
        return
    run_id = barrier_run_id()
    for old in glob.glob(os.path.join(sync_dir, f".barrier_{run_id}_*.host{pid}")):
        try:
            os.unlink(old)
        except OSError:
            pass


def fs_barrier(stage: str, sync_dir: str, timeout_s: float = 24 * 3600.0,
               poll_s: float = 2.0, report_every_s: float = 60.0) -> None:
    """Filesystem barrier between stages on a shared filesystem: each host
    drops `<sync_dir>/.barrier_<run_id>_<stage>.host<i>` (atomically) and
    waits until all hosts' markers of its run id exist. No-op on one host.

    Never waits silently: every `report_every_s` it logs and emits a
    `barrier_wait` event naming the missing hosts; its heartbeat beats only
    when a peer arrives, so the watchdog sees a barrier stuck on a dead
    host as stalled and its hard timeout cancels it; the TimeoutError names
    the missing peers."""
    pid, num = process_topology()
    if num == 1:
        return
    run_id = barrier_run_id()
    os.makedirs(sync_dir, exist_ok=True)
    own = os.path.join(sync_dir, f".barrier_{run_id}_{stage}.host{pid}")
    # a peer polling for this marker must never see a half-written file
    atomic_write_text(own, str(time.time()))
    want = [os.path.join(sync_dir, f".barrier_{run_id}_{stage}.host{i}")
            for i in range(num)]
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    next_report = t0 + report_every_s
    log = get_logger()
    log.info("barrier %s: host %d/%d waiting", stage, pid, num)
    hb = HEARTBEATS.register(f"barrier:{stage}", kind="barrier", planned=num)

    def names(missing):
        return [os.path.basename(m) for m in missing]

    while True:
        missing = [p for p in want if not os.path.isfile(p)]
        # beat on arrivals only: a barrier waiting on a dead host makes no
        # progress, and its beat age keeps growing for the watchdog
        if num - len(missing) > hb.units_done:
            hb.beat(done=num - len(missing))
        if not missing:
            hb.finish("ok")
            waited = time.monotonic() - t0
            _BARRIER_SECONDS.labels(stage=stage).inc(waited)
            tm.emit("barrier_wait", stage=stage, host=pid,
                    waited_s=round(waited, 3), missing=[], done=True)
            return
        now = time.monotonic()
        if hb.cancelled:
            hb.finish("timeout")
            raise TimeoutError(
                f"barrier {stage}: cancelled by the watchdog hard timeout "
                f"after {now - t0:.0f}s; still missing {names(missing)} in {sync_dir}"
            )
        if now > deadline:
            hb.finish("fail")
            raise TimeoutError(
                f"barrier {stage}: timed out after {now - t0:.0f}s waiting "
                f"for {len(missing)}/{num} hosts — missing {names(missing)} in {sync_dir}"
            )
        if now >= next_report:
            next_report = now + report_every_s
            log.warning("barrier %s: host %d still waiting after %.0fs for %d/%d "
                        "peers: %s", stage, pid, now - t0, len(missing), num,
                        names(missing))
            tm.emit("barrier_wait", stage=stage, host=pid,
                    waited_s=round(now - t0, 1), missing=names(missing))
        time.sleep(poll_s)


def local_shard(keyed_items: dict) -> list:
    """Shard a {key: item} work dict across hosts: each host takes every
    num_processes-th key (sorted, deterministic)."""
    pid, num = process_topology()
    if num == 1:
        return list(keyed_items.items())
    keep = set(shard_pvs_list(list(keyed_items), pid, num))
    get_logger().info("distributed shard: host %d/%d takes %d of %d items",
                      pid, num, len(keep), len(keyed_items))
    return [(k, v) for k, v in keyed_items.items() if k in keep]
