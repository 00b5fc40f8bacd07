"""Stage 4: CPVS generation, the staged single-device route (port of
processing_chain_tpu/stages/p04_generate_cpvs.py; reference
p04_generateCpvs.py:31-81).

Every PVS's AVPVS is decoded once a viewing context and rendered on one
device into its CPVS (models/cpvs.create_cpvs), plus the ProRes preview
with `--lightweight-preview`. As in the JAX package, p04 has no batch
route: with several visible cards and no `-g` pin it renders on the
default device (`select_device(-1)`, cuda:0).
"""

from __future__ import annotations

import json
import time
from typing import Optional

from .. import telemetry as tm
from ..config import TestConfig
from ..engine.jobs import JobRunner, device_stage_parallelism
from ..io import bufpool
from ..io import video as io_video
from ..models import cpvs as cp
from ..models.avpvs import set_default_fp_workers
from ..ops import cuda_kernels
from ..parallel.distributed import local_shard
from ..utils.log import get_logger


def run(cli_args, test_config: Optional[TestConfig] = None, device=None) -> TestConfig:
    with tm.stage_span("p04"):
        return _run(cli_args, test_config, device)


def _run(cli_args, test_config: Optional[TestConfig], device) -> TestConfig:
    log = get_logger()
    if test_config is None:
        test_config = TestConfig(
            cli_args.test_config, cli_args.filter_src, cli_args.filter_hrc,
            cli_args.filter_pvs,
        )
    pvs_par = device_stage_parallelism(cli_args.parallelism, "p04")
    # previews run ProRes through the same intra-writeback pool as the
    # p03 renders: install the pool-aware fp default (no-op when pinned)
    set_default_fp_workers(pvs_par)
    runner = JobRunner(
        force=cli_args.force, dry_run=cli_args.dry_run,
        parallelism=pvs_par, name="p04",
    )
    n_items = 0
    for _pvs_id, pvs in local_shard(test_config.pvses):
        if cli_args.skip_online_services and pvs.is_online():
            log.warning("Skipping PVS %s because it is an online service", pvs)
            continue
        n_items += 1
        for pp in test_config.post_processings:
            runner.add(
                cp.create_cpvs(
                    pvs, pp,
                    rawvideo=getattr(cli_args, "rawvideo", False),
                    nonraw_crf=int(getattr(cli_args, "nonraw_crf", 17)),
                    device=device,
                )
            )
        if getattr(cli_args, "lightweight_preview", False):
            runner.add(cp.create_preview(pvs, device=device))
    tm.stage_items("p04", n_items)
    launches0 = dict(cuda_kernels.LAUNCHES)
    pool0 = bufpool.DEFAULT_POOL.stats()
    opens0 = io_video.decoder_opens()
    totals0 = cp.RENDER_TOTALS.snapshot()
    t0 = time.perf_counter()
    done = runner.run()
    if not cli_args.dry_run:
        pool = bufpool.DEFAULT_POOL.stats()
        totals = cp.RENDER_TOTALS.snapshot()
        log.info("p04 summary: %s", json.dumps({
            "renders": len(done), "seconds": round(time.perf_counter() - t0, 6),
            **{k: round(totals[k] - totals0[k], 6) for k in totals},
            "launches": {k: v - launches0.get(k, 0) for k, v in cuda_kernels.LAUNCHES.items()},
            "decoder_opens": io_video.decoder_opens() - opens0,
            "bufpool": {"hits": pool["hits"] - pool0["hits"],
                        "misses": pool["misses"] - pool0["misses"],
                        "outstanding": pool["outstanding"]},
        }))
    return test_config
