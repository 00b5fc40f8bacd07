"""The media boundary's error type (copy of `MediaError` from
processing_chain_tpu/io/medialib.py:145-156).

The reference's native libav loader (`_build`, `ensure_loaded`) and the
decode/encode crossings are not ported yet; they arrive with the io layer
and the p03 stage. The domain model (`config/domain.Src`) already raises
and catches this class, so it lives here alone until then.
"""

from __future__ import annotations

from typing import Optional


class MediaError(RuntimeError):
    """A native media-boundary failure. `kind` is the serve failure
    taxonomy's surface (docs/SERVE.md "Failure taxonomy"): raisers that
    KNOW the failure class tag it "transient" (full disk, wedged host),
    "permanent" (bad parameters) or "poison" (hostile input bytes — the
    SRC itself is the problem; serve quarantines its content digest
    fleet-wide). None = no claim; serve/scheduler.classify_failure
    falls back to exception-type heuristics."""

    def __init__(self, *args, kind: Optional[str] = None) -> None:
        super().__init__(*args)
        self.kind = kind
