"""The stage command line of the port (counterpart of
processing_chain_tpu/cli.py:49-260 and `main` :393, for `p03` only):

    python -m processing_chain_tpu_torch p03 -c DB/DB.yaml [-f60] [-z] …

The flags are the JAX package's (utils/parse_args), so one command line
drives either package. The stage runs on `cuda:0`, or on the card `-g N`
names; the CPU only when a caller of `main` passes `device="cpu"` (the
tests do). The observability flags (--telemetry, --profile, --trace,
--watchdog-*, --live-port, --status-file) are ROADMAP Queue A item 6 and
are refused. ConfigError, ChainError, MediaError and a missing device exit
1 with their message, as the reference's sys.exit(1) sites do.
"""

from __future__ import annotations

import sys
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


def _dispatch_p03(argv: Sequence[str], device=None) -> int:
    args = pa.parse_args("p03", 3, argv)
    log = setup_logger(args.verbose)
    given = [f"--{f.replace('_', '-')}" for f in _OBSERVABILITY_FLAGS
             if getattr(args, f, None) is not None]
    if given:
        log.error("p03: %s: the run's observability flags are ROADMAP Queue A item 6 "
                  "of the PyTorch package", ", ".join(given))
        return 2
    try:
        dev = resolve_device(device) if device is not None else select_device(args.set_gpu_loc)
    except DeviceError as exc:
        log.error("p03: %s", exc)
        return 1
    if not args.skip_requirements and not check_requirements(need_device=dev.type == "cuda"):
        return 1
    from .store import runtime as store_runtime
    from .stages import p03_generate_avpvs

    store = store_runtime.configure_from_args(args)
    if store is not None:
        log.info("artifact store: %s", store.root)
    log.info("p03 on %s", dev)
    try:
        p03_generate_avpvs.run(args, device=dev)
    except (ConfigError, ChainError, MediaError) as exc:
        log.error("%s", exc)
        return 1
    finally:
        if store is not None:
            # persist the stat-keyed input digest cache (best-effort)
            store.digests.save()
    return 0


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    """`p03 …` runs the stage; `device` (a torch device or its name)
    overrides the card the flags select."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "p03":
        sys.stderr.write("usage: python -m processing_chain_tpu_torch p03 -c DB.yaml …\n")
        return 2
    return _dispatch_p03(argv[1:], device)


if __name__ == "__main__":
    sys.exit(main())
