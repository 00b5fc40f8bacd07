"""The stage command line of the port (counterpart of
processing_chain_tpu/cli.py:49-260 and `main` :393, for `p03` and `p04`):

    python -m processing_chain_tpu_torch p03 -c DB/DB.yaml [-f60] [-z] …
    python -m processing_chain_tpu_torch p04 -c DB/DB.yaml [-e] [-a] [-ccrf N] …

The flags are the JAX package's (utils/parse_args), so one command line
drives either package. The stage runs on `cuda:0`, or on the card `-g N`
names; the CPU only when a caller of `main` passes `device="cpu"` (the
tests do). The observability flags (--telemetry, --profile, --trace,
--watchdog-*, --live-port, --status-file) are ROADMAP Queue A item 6 and
are refused. ConfigError, ChainError, MediaError and a missing device exit
1 with their message, as the reference's sys.exit(1) sites do.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Sequence

from .config.errors import ConfigError
from .io.medialib import MediaError
from .utils import log as log_mod
from .utils import parse_args as pa
from .utils.device import DeviceError, resolve_device, select_device
from .utils.runner import ChainError
from .utils.version import check_requirements

#: parse_args flags whose machinery the port has not carried yet
_OBSERVABILITY_FLAGS = ("telemetry", "profile", "trace", "watchdog_soft",
                        "watchdog_hard", "live_port", "status_file")


def setup_logger(verbose: bool = False):
    """The chain-wide "main" logger on stderr (reference utils/log.py)."""
    import logging

    logger = log_mod.get_logger()
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s",
                                               "%H:%M:%S"))
        logger.addHandler(handler)
    logger.propagate = False
    return logger


#: the stages the port runs, by name: (script number, module name)
STAGES = {"p03": (3, "p03_generate_avpvs"), "p04": (4, "p04_generate_cpvs")}


def _process_seconds() -> Optional[float]:
    """Seconds since this process started (/proc/self/stat's start time
    against /proc/uptime), or None where /proc does not tell."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return round(uptime - start / os.sysconf("SC_CLK_TCK"), 3)
    except (OSError, ValueError, IndexError):
        return None


def _dispatch_stage(stage: str, argv: Sequence[str], device=None) -> int:
    import importlib

    startup = {"to_main_s": _process_seconds()}
    t0 = time.perf_counter()
    args = pa.parse_args(stage, STAGES[stage][0], argv)
    log = setup_logger(args.verbose)
    given = [f"--{f.replace('_', '-')}" for f in _OBSERVABILITY_FLAGS
             if getattr(args, f, None) is not None]
    if given:
        log.error("%s: %s: the run's observability flags are ROADMAP Queue A item 6 "
                  "of the PyTorch package", stage, ", ".join(given))
        return 2
    try:
        dev = resolve_device(device) if device is not None else select_device(args.set_gpu_loc)
    except DeviceError as exc:
        log.error("%s: %s", stage, exc)
        return 1
    startup["device_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    if not args.skip_requirements and not check_requirements(need_device=dev.type == "cuda"):
        return 1
    startup["requirements_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    from .store import runtime as store_runtime

    module = importlib.import_module(f".stages.{STAGES[stage][1]}", __package__)
    store = store_runtime.configure_from_args(args)
    if store is not None:
        log.info("artifact store: %s", store.root)
    startup["stage_import_s"] = round(time.perf_counter() - t0, 3)
    # where a process's seconds go before the stage starts: the
    # interpreter and imports, the device pick, the requirements check
    # (libav located, bound and its layout round trips), the stage's
    # modules
    log.info("%s start-up: %s", stage, json.dumps(startup))
    log.info("%s on %s", stage, dev)
    try:
        module.run(args, device=dev)
    except (ConfigError, ChainError, MediaError) as exc:
        log.error("%s", exc)
        return 1
    finally:
        if store is not None:
            # persist the stat-keyed input digest cache (best-effort)
            store.digests.save()
    return 0


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    """`p03 …` or `p04 …` runs the stage; `device` (a torch device or its
    name) overrides the card the flags select."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in STAGES:
        sys.stderr.write("usage: python -m processing_chain_tpu_torch p03|p04 -c DB.yaml …\n")
        return 2
    return _dispatch_stage(argv[0], argv[1:], device)


if __name__ == "__main__":
    sys.exit(main())
