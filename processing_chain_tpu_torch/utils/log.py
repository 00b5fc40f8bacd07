"""Central logger for the chain: one process-wide logger named "main"
(counterpart of processing_chain_tpu/utils/log.py; only `get_logger` is
carried over, the port configures no handlers of its own)."""

from __future__ import annotations

import logging


def get_logger() -> logging.Logger:
    return logging.getLogger("main")
