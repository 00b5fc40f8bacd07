"""Stage 3: AVPVS generation, the single-device route (port of
processing_chain_tpu/stages/p03_generate_avpvs.py:16-178; reference
p03_generateAvPvs.py:62-267).

Two phases on one device: every eligible PVS's wo_buffer render
(models/avpvs.create_avpvs_wo_buffer), then, once those bytes exist, the
stalling pass of each PVS with buffering (models/avpvs.apply_stalling).
Short and long tests both take it. With PC_FUSE_P04 (models/fused) each
PVS whose AVPVS is due also renders its stalling pass, every CPVS context
and, with `-e` in the namespace, the preview from the same decode; the
stall pass is then planned only for PVSes whose stall member degraded.
The stage never takes a route the JAX package would not take, so it
refuses, naming the ROADMAP item that ports the route, where the JAX
package would go elsewhere: more than one visible card without a `-g`
pin (the batch route over the mesh, item 7).
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
from ..models import fused as fused_mod
from ..ops import cuda_kernels
from ..parallel.distributed import local_shard
from ..utils.device import device_count
from ..utils.log import get_logger
from ..utils.runner import ChainError


def _refuse_unported(cli_args) -> None:
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

    # fused p04 fan-out (PC_FUSE_P04, models/fused): PVSes whose AVPVS is
    # due render the stalling pass and every CPVS context from the same
    # decode. Dry runs plan exactly like the staged path, so they never
    # engage it. The p04 knobs ride getattr defaults, as the p04 stage's
    # namespace carries them.
    fuse = fused_mod.fused_p04_enabled() and not cli_args.dry_run
    fanouts: dict = {}

    def _fanout(pvs):
        fo = fused_mod.FusedFanout(
            pvs, spinner_path=spinner,
            rawvideo=bool(getattr(cli_args, "rawvideo", False)),
            nonraw_crf=int(getattr(cli_args, "nonraw_crf", 17)),
            preview=bool(getattr(cli_args, "lightweight_preview", False)),
            device=device,
        )
        fanouts[pvs] = fo
        return fo

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
    totals0 = av.RENDER_TOTALS.snapshot()
    t0 = time.perf_counter()
    for pvs in eligible:
        runner.add(av.create_avpvs_wo_buffer(
            pvs, avpvs_src_fps=avpvs_src_fps, force_60_fps=force_60_fps, device=device,
            fanout=_fanout(pvs) if fuse else None))
    # two phases: stalling reads the wo_buffer outputs of phase one, and is
    # planned only now, so its plan input holds this run's bytes
    rendered = runner.run()
    opens1 = io_video.decoder_opens()
    for pvs in eligible:
        fo = fanouts.get(pvs)
        if fo is not None and fo.engaged and fo.stall_settled():
            # the fused render produced and committed the stalled AVPVS
            # (a degraded stall member falls through to the staged pass)
            continue
        stall_runner.add(av.apply_stalling(pvs, spinner_path=spinner, device=device))
    stalled = stall_runner.run()
    if not cli_args.dry_run:
        pool = bufpool.DEFAULT_POOL.stats()
        totals = av.RENDER_TOTALS.snapshot()
        engaged = [fo for fo in fanouts.values() if fo.engaged]
        log.info("p03 summary: %s", json.dumps({
            "renders": len(rendered), "stalls": len(stalled),
            "seconds": round(time.perf_counter() - t0, 6),
            **{k: round(totals[k] - totals0[k], 6) for k in totals},
            "fused": {"fanouts": len(engaged),
                      "members": sum(len(fo.member_jobs()) - len(fo.degraded)
                                     for fo in engaged),
                      "degraded": sum(len(fo.degraded) for fo in engaged)},
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
