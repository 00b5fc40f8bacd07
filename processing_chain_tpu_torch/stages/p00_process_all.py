"""Orchestrator: stages p01-p04 in order (port of
processing_chain_tpu/stages/p00_process_all.py; reference
p00_processAll.py:24-53).

The parsed TestConfig is threaded through so later stages skip
re-parsing, and `-str "1234"` selects a subset of the stages. On several
hosts no host starts a stage until every host has finished the one before
(a file barrier under the database's logs/), since a stage's inputs can
lie on another host's shard.
"""

from __future__ import annotations

import importlib
from typing import Optional

from ..config import TestConfig
from ..utils.log import get_logger

#: script number -> stage module
STAGES = {
    "1": "p01_generate_segments",
    "2": "p02_generate_metadata",
    "3": "p03_generate_avpvs",
    "4": "p04_generate_cpvs",
}


def run(cli_args, test_config: Optional[TestConfig] = None, device=None) -> Optional[TestConfig]:
    from ..parallel.distributed import (
        barrier_run_id,
        fs_barrier,
        fs_barrier_init,
        process_topology,
    )

    log = get_logger()
    selection = cli_args.scripts_to_run
    if selection == "all":
        selection = "1234"
    multi_host = process_topology()[1] > 1
    if multi_host:
        barrier_run_id()  # fail fast if PC_RUN_ID is missing or unsafe
    barrier_ready = False
    for key in "1234":
        if key not in selection:
            continue
        log.info("=== stage p0%s ===", key)
        stage = importlib.import_module(f".{STAGES[key]}", __package__)
        test_config = stage.run(cli_args, test_config=test_config, device=device)
        if multi_host and test_config is not None:
            if not barrier_ready:
                fs_barrier_init(test_config.get_logs_path())
                barrier_ready = True
            fs_barrier(f"p0{key}", test_config.get_logs_path())
    return test_config
