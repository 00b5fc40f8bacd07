"""Chain version reporting and the requirements check (counterpart of
processing_chain_tpu/utils/version.py).

The version string is `git describe` when available, else the repo's
VERSION file, else the package version. It is folded into every plan
hash (store/keys.chain_version), and the port reads it from the same
repo root as the reference, so one unit plans to one hash in both
packages. `check_requirements` checks torch, the CUDA device when one is
needed, and that the media boundary binds (the reference asks
`jax.devices()` instead).
"""

from __future__ import annotations

from . import log


def get_processing_chain_version() -> str:
    import os

    from .runner import ChainError, shell

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        # bounded: `git describe` can hang on a wedged network filesystem
        # or a lock-holding concurrent git process, and version reporting
        # must never hang a run — expiry degrades to the VERSION file
        result = shell(
            ["git", "describe", "--always", "--dirty"],
            check=False,
            timeout=10,
            cwd=pkg_root,
        )
        if result.returncode == 0 and result.stdout.strip():
            return result.stdout.strip()
    except (OSError, ChainError):
        pass
    version_file = os.path.join(pkg_root, "VERSION")
    if os.path.isfile(version_file):
        with open(version_file) as f:
            content = f.read().strip()
        if content:
            return content
    from .. import __version__

    return __version__


def check_requirements(need_device: bool = False) -> bool:
    """Verify the runtime environment: torch imports, a CUDA device is
    visible when `need_device`, and io/medialib binds a libav. Returns
    True when usable; logs each failure."""
    logger = log.get_logger()
    ok = True
    try:
        import torch

        if need_device and not torch.cuda.is_available():
            logger.error("no CUDA device visible to torch %s", torch.__version__)
            ok = False
    except Exception as exc:  # pragma: no cover - environment-specific
        logger.error("torch unavailable: %r", exc)
        ok = False
    try:
        from ..io import medialib

        logger.info("media boundary: %s", medialib.version())
    except Exception as exc:
        logger.error("media boundary unavailable: %r", exc)
        ok = False
    logger.info("processing chain version: %s", get_processing_chain_version())
    return ok
