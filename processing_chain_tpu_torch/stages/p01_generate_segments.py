"""Stage 1: encode every required segment (port of
processing_chain_tpu/stages/p01_generate_segments.py; reference
p01_generateSegments.py:30-101).

Each local segment becomes one encode job (models/segments.encode_segment:
decode the SRC window on the host, scale on the device, encode on the
host), run `-p`-wide like the reference's Pool(4). Online segments (a
download or a Bitmovin encode) are skipped with `-sos`, as in the JAX
package; without it the stage refuses them at plan time, naming every one:
the online services are ROADMAP Queue A item 9b of the PyTorch package.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from .. import telemetry as tm
from ..config import TestConfig
from ..config.errors import ConfigError
from ..engine.jobs import JobRunner
from ..io import video as io_video
from ..models import segments as seg_model
from ..ops import cuda_kernels
from ..parallel.distributed import local_shard
from ..utils.log import get_logger


def run(cli_args, test_config: Optional[TestConfig] = None, device=None) -> TestConfig:
    with tm.stage_span("p01"):
        return _run(cli_args, test_config, device)


def _run(cli_args, test_config: Optional[TestConfig], device) -> TestConfig:
    log = get_logger()
    if test_config is None:
        test_config = TestConfig(
            cli_args.test_config, cli_args.filter_src, cli_args.filter_hrc,
            cli_args.filter_pvs,
        )
    # "warn once per run": a run is one p01 invocation, not the process
    # lifetime
    seg_model.reset_run_state()
    runner = JobRunner(
        force=cli_args.force,
        dry_run=cli_args.dry_run,
        parallelism=cli_args.parallelism,
        name="p01",
    )
    online: list[str] = []
    # several hosts: each process takes a deterministic shard of the
    # segment set (keyed by filename; distinct outputs per key)
    all_segments = {s.filename: s for s in sorted(test_config.get_required_segments())}
    for _, segment in local_shard(all_segments):
        if getattr(segment.video_coding, "is_online", False):
            if cli_args.skip_online_services:
                log.warning("Skipping online segment %s", segment.filename)
            else:
                online.append(segment.filename)
            continue
        runner.add(seg_model.encode_segment(segment, device=device))
    if online:
        lines = "\n".join(f"  {name}" for name in online)
        raise ConfigError(
            f"{len(online)} online segment(s) cannot be produced by the PyTorch "
            f"package:\n{lines}\n(the online services are ROADMAP Queue A item 9b; "
            "use -sos to skip online services)"
        )
    log.info("p01: %d segment encodes planned", len(runner.jobs))
    tm.stage_items("p01", len(runner.jobs))
    launches0 = dict(cuda_kernels.LAUNCHES)
    opens0 = io_video.decoder_opens()
    t0 = time.perf_counter()
    done = runner.run()
    if not cli_args.dry_run:
        log.info("p01 summary: %s", json.dumps({
            "encodes": len(done), "seconds": round(time.perf_counter() - t0, 6),
            "launches": {k: v - launches0.get(k, 0) for k, v in cuda_kernels.LAUNCHES.items()},
            "decoder_opens": io_video.decoder_opens() - opens0,
        }))
        # encode-time priors priming (JAX :101-127) waits for priors
        # extraction, ROADMAP Queue A item 4b; in the JAX package it is never
        # fatal, and no segment byte or plan hash depends on it
        log.info("p01: priors priming skipped: priors extraction is ROADMAP "
                 "Queue A item 4b of the PyTorch package")
    return test_config
