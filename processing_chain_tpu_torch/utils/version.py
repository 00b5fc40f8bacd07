"""Chain version reporting (copy of `get_processing_chain_version` from
processing_chain_tpu/utils/version.py).

The version string is `git describe` when available, else the repo's
VERSION file, else the package version. It is folded into every plan
hash (store/keys.chain_version), and the port reads it from the same
repo root as the reference, so one unit plans to one hash in both
packages. The reference's `check_requirements` calls `jax.devices()`
and is not carried over.
"""

from __future__ import annotations


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
