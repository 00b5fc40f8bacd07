"""Process-wide active-store slot (trimmed copy of
processing_chain_tpu/store/runtime.py: one local store, no tier spec).

The engine consults `active()` at plan and commit time; the serve
service configures it to its store at construction.
"""

from __future__ import annotations

from typing import Optional

from .store import ArtifactStore

_ACTIVE: Optional[ArtifactStore] = None


def configure(root: Optional[str]) -> Optional[ArtifactStore]:
    """Install the store rooted at `root` (created on demand) as the
    process-wide active store; None deactivates. Returns the store."""
    global _ACTIVE
    _ACTIVE = ArtifactStore(root) if root else None
    return _ACTIVE


def active() -> Optional[ArtifactStore]:
    return _ACTIVE
