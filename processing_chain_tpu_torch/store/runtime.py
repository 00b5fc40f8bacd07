"""Process-wide active-store slot (copy of
processing_chain_tpu/store/runtime.py).

The engine consults `active()` at plan and commit time; the stage CLI
configures it from its flags, the serve service to its store at
construction.
"""

from __future__ import annotations

import os
from typing import Optional

from .store import ArtifactStore

_ACTIVE: Optional[ArtifactStore] = None


def configure(root: Optional[str],
              tiers: Optional[str] = None) -> Optional[ArtifactStore]:
    """Install the store rooted at `root` (created on demand) as the
    process-wide active store; None deactivates. `tiers` is an optional
    `--store-tiers` placement spec (store/tiers.py: warm/cold backends
    and per-tier budgets); a bare root stays a one-tier config. Returns
    the store."""
    global _ACTIVE
    _ACTIVE = ArtifactStore(root, tier_spec=tiers) if root else None
    return _ACTIVE


def configure_from_args(args) -> Optional[ArtifactStore]:
    """CLI wiring: --no-store wins, then --store DIR, then PC_STORE_DIR;
    the tier spec comes from --store-tiers, then PC_STORE_TIERS.
    Always reassigns the slot so successive in-process dispatches (tests,
    orchestrators) never inherit a previous run's store by accident."""
    if getattr(args, "no_store", False):
        return configure(None)
    # plan-exempt: (names WHERE the store lives, never what an artifact contains)
    root = getattr(args, "store", None) or os.environ.get("PC_STORE_DIR") or None
    # plan-exempt: (names WHERE artifact bytes are placed, never what they contain)
    tiers = getattr(args, "store_tiers", None) or os.environ.get("PC_STORE_TIERS") or None
    return configure(root, tiers=tiers)


def active() -> Optional[ArtifactStore]:
    return _ACTIVE
