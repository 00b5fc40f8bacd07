"""Pluggable CAS backends: where artifact bytes live (docs/STORE.md
"Tier hierarchy").

A `StoreBackend` owns one medium full of content-addressed objects and
nothing else — no manifests, no pins, no heat. The store's metadata
plane (manifests, the adoption ledger, the digest cache) always stays
on the store root; backends only hold and serve bytes, keyed by their
sha256. Three implementations ship:

  * `LocalBackend`  — the classic `objects/<sha[:2]>/<sha>` directory
    layout, extracted from store.py unchanged so every existing store
    root keeps working with zero migration (a bare root IS a one-tier
    config).
  * `SharedBackend` — the same layout rooted at a second local-FS path
    (an NFS/fuse mount shared by the fleet): the warm tier.
  * `ObjectBackend` — an S3-shaped cold tier speaking a minimal
    put/get/head/delete/list client interface; the directory-backed
    `DirObjectClient` reference implementation lets tests and CI run
    the full three-tier stack with no cloud in sight.

Commit discipline: `put`/`put_stream` are atomic where the medium
allows (tmp + fsync + rename on filesystems; a single PUT on object
stores) and `put_stream` verifies the streamed content digest BEFORE
the commit becomes visible — the integrity check lives at the boundary
the bytes cross, so a corrupt source can never materialize as a valid
key in another tier.

The port's copy of processing_chain_tpu/store/backends/__init__.py.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Callable, Iterator, Optional

from .local import LocalBackend, SharedBackend
from .object import DirObjectClient, ObjectBackend, ObjectClient

__all__ = [
    "StoreBackend",
    "LocalBackend",
    "SharedBackend",
    "ObjectBackend",
    "ObjectClient",
    "DirObjectClient",
    "BackendIntegrityError",
    "make_backend",
    "crashpoint",
    "CRASH_HOOK",
]


class BackendIntegrityError(RuntimeError):
    """Streamed bytes did not match the digest they were keyed under;
    the commit was aborted before becoming visible."""


#: test seam for the placement-move crash-safety suite: when set, it is
#: called with a named commit boundary ("pre_commit" — destination tmp
#: bytes durable but not yet renamed; "pre_delete" — destination commit
#: durable, source copy still present) and may SIGKILL the process to
#: prove neither instant can tear an object or lose the only copy.
#: Never set in production.
CRASH_HOOK: Optional[Callable[[str], None]] = None


def crashpoint(name: str) -> None:
    hook = CRASH_HOOK
    if hook is not None:
        hook(name)


class StoreBackend:
    """The backend protocol. Implementations override everything; the
    base class only documents the contract.

    * `put(src_path, sha256)`      — commit a local file's bytes under a
      digest the caller already computed (the hot commit path: no
      re-hash, hardlink when the medium allows).
    * `put_stream(fileobj, sha256)` — stream bytes in, hashing as they
      arrive; the commit aborts with BackendIntegrityError on mismatch
      and is atomic+durable on success. Returns bytes written. This is
      the only way bytes cross tiers.
    * `open_read(sha256)`          — a binary file object over the bytes
      (an fd for filesystem media: the serve path fd-pins it).
    * `head(sha256)`               — object size, or None when absent.
    * `delete(sha256)`             — True when an object was removed.
    * `list()`                     — (sha256, size) for every object.
    * `local_path(sha256)`         — a filesystem path when the medium
      has one (hardlink materialization, fd serving), else None.
    * `tmp_dirs()`                 — in-flight commit scratch dirs for
      GC's tmp sweep (empty for media without one).
    """

    kind: str = "?"

    def put(self, src_path: str, sha256: str) -> None:
        raise NotImplementedError

    def put_stream(self, fileobj: BinaryIO, sha256: str) -> int:
        raise NotImplementedError

    def open_read(self, sha256: str) -> BinaryIO:
        raise NotImplementedError

    def head(self, sha256: str) -> Optional[int]:
        raise NotImplementedError

    def delete(self, sha256: str) -> bool:
        raise NotImplementedError

    def list(self) -> Iterator[tuple[str, int]]:
        raise NotImplementedError

    def local_path(self, sha256: str) -> Optional[str]:
        return None

    def tmp_dirs(self) -> tuple[str, ...]:
        return ()


def make_backend(kind: str, path: str) -> StoreBackend:
    """Backend factory for the `--store-tiers` spec kinds."""
    path = os.path.abspath(path)
    if kind == "local":
        return LocalBackend(os.path.join(path, "objects"),
                            os.path.join(path, "tmp"))
    if kind == "shared":
        return SharedBackend(path)
    if kind == "object":
        return ObjectBackend(DirObjectClient(path))
    raise ValueError(f"unknown store backend kind {kind!r} "
                     "(expected local, shared, or object)")
