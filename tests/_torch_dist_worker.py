"""Worker process of the port's multi-process gloo test
(tests/test_torch_parallel.py::test_multiprocess_gloo_end_to_end).

Run as: python tests/_torch_dist_worker.py <init_method> <world_size> <rank>
Prints one JSON line with this rank's view of the global computation.
"""

import json
import sys


def main() -> None:
    init_method, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import numpy as np
    import torch
    import torch.distributed as dist

    from processing_chain_tpu_torch import telemetry as tm
    from processing_chain_tpu_torch.parallel import distributed as pdist
    from processing_chain_tpu_torch.parallel.mesh import make_mesh
    from processing_chain_tpu_torch.parallel.pipeline import avpvs_siti_step, make_sharded_step

    # telemetry on before initialize, so dist_init and the collectives count
    tm.enable()
    assert pdist.initialize(init_method, num, pid, device="cpu") is True
    shard = pdist.shard_pvs_list([f"PVS{i:02d}" for i in range(10)], pid, num)

    local = torch.full((1, 4, 8, 8), float(pid + 1))
    total = local.clone()
    dist.all_reduce(total)
    pdist.record_collective("all_reduce", local.numel() * local.element_size())
    lane_mean = local.mean(dim=(1, 2, 3))
    gathered = [torch.empty_like(lane_mean) for _ in range(num)]
    dist.all_gather(gathered, lane_mean)
    pdist.record_collective("all_gather", lane_mean.numel() * lane_mean.element_size())

    # the flagship step with the time axis split across the ranks: every
    # rank builds the same seeded clip and passes its time block; the halo
    # crosses each rank boundary (recorded by the halo itself)
    rng = np.random.default_rng(7)
    t_glob, h, w = 8, 36, 64
    t_loc = t_glob // num
    full = [rng.integers(0, 255, s, np.uint8)
            for s in ((1, t_glob, h, w), (1, t_glob, h // 2, w // 2), (1, t_glob, h // 2, w // 2))]
    mesh = make_mesh(["cpu"], time_parallel=num, group=dist.group.WORLD)
    step = make_sharded_step(mesh, h * 2, w * 2, "lanczos")
    out = step(*(torch.from_numpy(np.ascontiguousarray(p[:, pid * t_loc:(pid + 1) * t_loc]))
                 for p in full))
    ref = avpvs_siti_step(*(torch.from_numpy(p[0]) for p in full), h * 2, w * 2)
    lo, hi = pid * t_loc, (pid + 1) * t_loc
    step_ok = bool(
        torch.equal(out[0][0], ref[0][lo:hi])
        and np.allclose(out[3][0].numpy(), ref[3][lo:hi].numpy(), rtol=1e-4, atol=1e-3)
        and np.allclose(out[4][0].numpy(), ref[4][lo:hi].numpy(), rtol=1e-4, atol=1e-3))
    si_all = [torch.empty_like(out[3][0]) for _ in range(num)]
    dist.all_gather(si_all, out[3][0].contiguous())

    events = tm.EVENTS.records()
    print(json.dumps({
        "pid": pid,
        "world_size": dist.get_world_size(),
        "backend": dist.get_backend(),
        "mesh": mesh.shape,
        "shard": shard,
        "total": float(total.sum()),
        "lanes": [float(g[0]) for g in gathered],
        "sharded_step_ok": step_ok,
        # the rank's first frame: TI against the previous rank's last frame
        "boundary_ti": float(out[4][0, 0]),
        "si_all": [float(x) for s in si_all for x in s],
        "collective_bytes": tm.REGISTRY.sum_series("chain_dist_collective_bytes_total"),
        "dist_init_events": sum(1 for e in events if e.get("event") == "dist_init"),
        "dist_collective_events": sum(1 for e in events if e.get("event") == "dist_collective"),
    }))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
