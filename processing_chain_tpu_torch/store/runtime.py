"""Process-wide active-store slot (trimmed copy of
processing_chain_tpu/store/runtime.py, without the stage CLI's
`configure_from_args`).

The engine consults `active()` at plan and commit time; the serve
service configures it to its store at construction.
"""

from __future__ import annotations

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


def active() -> Optional[ArtifactStore]:
    return _ACTIVE
