"""Stage 3: AVPVS generation, the single-device route (port of
processing_chain_tpu/stages/p03_generate_avpvs.py:16-178; reference
p03_generateAvPvs.py:62-267).

Two phases on one device: every eligible PVS's wo_buffer render
(models/avpvs.create_avpvs_wo_buffer), then, once those bytes exist, the
stalling pass of each PVS with buffering (models/avpvs.apply_stalling).
Short and long tests both take it. The stage never takes a route the
JAX package would not take, so it refuses, naming the ROADMAP item that
ports the route, where the JAX package would go elsewhere: PC_FUSE_P04
(the fused p04 fan-out, item 8), and more than one visible card without
a `-g` pin (the batch route over the mesh, item 7).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from .. import telemetry as tm
from ..config import TestConfig
from ..engine.jobs import JobRunner, device_stage_parallelism
from ..io import bufpool
from ..io import video as io_video
from ..models import avpvs as av
from ..ops import cuda_kernels
from ..parallel.distributed import local_shard
from ..utils.device import device_count
from ..utils.log import get_logger
from ..utils.runner import ChainError


def _fused_p04_enabled() -> bool:
    """The JAX package's PC_FUSE_P04 gate (models/fused.fused_p04_enabled)."""
    # plan-exempt: (routing only: the stage refuses the fused route it does not have)
    return os.environ.get("PC_FUSE_P04", "").strip().lower() in ("1", "true", "yes", "on")


def _refuse_unported(cli_args) -> None:
    if _fused_p04_enabled() and not cli_args.dry_run:
        raise ChainError(
            "p03: PC_FUSE_P04 asks for the fused p03+p04 fan-out, ROADMAP Queue A "
            "item 8 of the PyTorch package; unset it to run the staged p03")
    if (not cli_args.dry_run and getattr(cli_args, "set_gpu_loc", -1) < 0
            and device_count() > 1):
        raise ChainError(
            f"p03: {device_count()} cards are visible, where the JAX package "
            "batches the PVS set over the (pvs, time) mesh: that route is ROADMAP "
            "Queue A item 7 of the PyTorch package; pin one card with -g N")


def run(cli_args, test_config: Optional[TestConfig] = None, device=None) -> TestConfig:
    with tm.stage_span("p03"):
        return _run(cli_args, test_config, device)


def _run(cli_args, test_config: Optional[TestConfig], device) -> TestConfig:
    log = get_logger()
    if test_config is None:
        test_config = TestConfig(
            cli_args.test_config, cli_args.filter_src, cli_args.filter_hrc,
            cli_args.filter_pvs,
        )
    _refuse_unported(cli_args)
    pvs_par = device_stage_parallelism(cli_args.parallelism, "p03")
    runner = JobRunner(force=cli_args.force, dry_run=cli_args.dry_run,
                       parallelism=pvs_par, name="p03")
    stall_runner = JobRunner(force=cli_args.force, dry_run=cli_args.dry_run,
                             parallelism=pvs_par, name="p03-stall")
    from ..utils.parse_args import _DEFAULT_SPINNER

    spinner = getattr(cli_args, "spinner_path", None) or _DEFAULT_SPINNER
    avpvs_src_fps = getattr(cli_args, "avpvs_src_fps", False)
    force_60_fps = getattr(cli_args, "force_60_fps", False)
    # writeback knobs: the flag (when given) takes precedence over the
    # env, by becoming it — every model-layer consumer reads the env
    ffv1_workers = getattr(cli_args, "ffv1_workers", None)
    if ffv1_workers is not None:
        # plan-exempt: (the flag becomes the env knob; the worker count does not alter encoded bytes)
        os.environ["PC_FFV1_WORKERS"] = str(max(0, ffv1_workers))
    # the pool-aware defaults for whatever is not pinned
    av.set_default_fp_workers(pvs_par)
    avpvs_codec = getattr(cli_args, "avpvs_codec", None)
    if avpvs_codec:
        os.environ["PC_AVPVS_CODEC"] = avpvs_codec

    shard = local_shard(test_config.pvses)
    eligible = []
    for _pvs_id, pvs in shard:
        if cli_args.skip_online_services and pvs.is_online():
            log.warning("Skipping PVS %s because it is an online service", pvs)
            continue
        eligible.append(pvs)
    tm.stage_items("p03", len(eligible))
    launches0 = dict(cuda_kernels.LAUNCHES)
    pool0 = bufpool.DEFAULT_POOL.stats()
    opens0 = io_video.decoder_opens()
    t0 = time.perf_counter()
    for pvs in eligible:
        runner.add(av.create_avpvs_wo_buffer(
            pvs, avpvs_src_fps=avpvs_src_fps, force_60_fps=force_60_fps, device=device))
    # two phases: stalling reads the wo_buffer outputs of phase one, and is
    # planned only now, so its plan input holds this run's bytes
    rendered = runner.run()
    opens1 = io_video.decoder_opens()
    for pvs in eligible:
        stall_runner.add(av.apply_stalling(pvs, spinner_path=spinner, device=device))
    stalled = stall_runner.run()
    if not cli_args.dry_run:
        pool = bufpool.DEFAULT_POOL.stats()
        log.info("p03 summary: %s", json.dumps({
            "renders": len(rendered), "stalls": len(stalled),
            "seconds": round(time.perf_counter() - t0, 6),
            **av.ffv1_effective_coding(),
            "launches": {k: v - launches0.get(k, 0) for k, v in cuda_kernels.LAUNCHES.items()},
            "decoder_opens": {"render": opens1 - opens0,
                              "stall": io_video.decoder_opens() - opens1},
            "bufpool": {"hits": pool["hits"] - pool0["hits"],
                        "misses": pool["misses"] - pool0["misses"],
                        "outstanding": pool["outstanding"]},
        }))

    if cli_args.remove_intermediate:
        for _, pvs in shard:
            if pvs.has_buffering():
                tmp = pvs.get_avpvs_wo_buffer_file_path()
                if os.path.isfile(tmp):
                    log.debug("removing intermediate %s", tmp)
                    os.unlink(tmp)
                # the intermediate's feature sidecar goes with it
                av.SiTiAccumulator.discard(tmp)
    return test_config
