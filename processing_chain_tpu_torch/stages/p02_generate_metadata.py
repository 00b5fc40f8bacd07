"""Stage 2: metadata artifacts (port of
processing_chain_tpu/stages/p02_generate_metadata.py; reference
p02_generateMetadata.py:33-152).

One job a PVS (models/metadata.metadata_job): `.qchanges`, `.vfi`, `.afi`
and, for a PVS with buffering, `.buff`, from the encoded segments'
bitstreams. Host work only, run `-p`-wide.
"""

from __future__ import annotations

from typing import Optional

from .. import telemetry as tm
from ..config import TestConfig
from ..engine.jobs import JobRunner
from ..models import metadata as md
from ..parallel.distributed import local_shard
from ..utils.log import get_logger


def run(cli_args, test_config: Optional[TestConfig] = None, device=None) -> TestConfig:
    """`device` is accepted for the stage interface and unused: p02 reads
    bitstreams on the host."""
    with tm.stage_span("p02"):
        return _run(cli_args, test_config)


def _run(cli_args, test_config: Optional[TestConfig]) -> TestConfig:
    log = get_logger()
    if test_config is None:
        test_config = TestConfig(
            cli_args.test_config, cli_args.filter_src, cli_args.filter_hrc,
            cli_args.filter_pvs,
        )
    # a job a PVS, so the four tables commit to the artifact store together
    # under one plan (segment digests + stall schedule); one PVS's tables
    # never read another's, so the jobs run -p-wide
    runner = JobRunner(
        force=cli_args.force, dry_run=cli_args.dry_run,
        parallelism=cli_args.parallelism, name="p02",
    )
    n_items = 0
    for _pvs_id, pvs in local_shard(test_config.pvses):
        if cli_args.skip_online_services and pvs.is_online():
            log.warning("Skipping PVS %s because it is an online service", pvs)
            continue
        runner.add(md.metadata_job(pvs, force=cli_args.force))
        n_items += 1
    tm.stage_items("p02", n_items)
    runner.run()
    return test_config
