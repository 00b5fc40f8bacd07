"""S3-shaped cold-tier backend.

`ObjectBackend` speaks a minimal object-store client interface —
put/get/head/delete/list by key — so a real S3/GCS client drops in
behind one adapter. The repo ships `DirObjectClient`, a directory-backed
reference implementation with the same visible semantics (atomic PUT,
flat key namespace, stream reads), so tests and CI exercise the full
three-tier stack without any cloud dependency.

The backend deliberately returns `local_path() -> None` even when the
reference client is directory-backed: cold-tier readers must go through
streamed `open_read`, exactly as they would against a remote store —
keeping the serving code honest about which tiers have fds to pin.

The port's copy of processing_chain_tpu/store/backends/object.py.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import BinaryIO, Iterator, Optional

_COPY_BLOCK = 1 << 20


class ObjectClient:
    """The S3-shaped client protocol ObjectBackend drives. Keys are
    opaque strings (the backend uses bare sha256 digests)."""

    def put_object_stream(self, key: str, fileobj: BinaryIO) -> int:
        """Store the stream under `key` atomically (visible all-or-
        nothing); returns bytes written."""
        raise NotImplementedError

    def get_object(self, key: str) -> BinaryIO:
        raise NotImplementedError

    def head_object(self, key: str) -> Optional[int]:
        raise NotImplementedError

    def delete_object(self, key: str) -> bool:
        raise NotImplementedError

    def list_objects(self) -> Iterator[tuple[str, int]]:
        raise NotImplementedError

    def tmp_dirs(self) -> tuple[str, ...]:
        return ()


class DirObjectClient(ObjectClient):
    """Directory-backed reference client: one flat namespace of keys
    under `root/`, PUTs staged in `root/.tmp` and renamed in — the
    atomic-PUT semantics of a real object store, on local disk."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self._tmp = os.path.join(self.root, ".tmp")
        os.makedirs(self.root, exist_ok=True)
        os.makedirs(self._tmp, exist_ok=True)

    def _key_path(self, key: str) -> str:
        safe = key.replace("/", "_")
        return os.path.join(self.root, safe)

    def put_object_stream(self, key: str, fileobj: BinaryIO) -> int:
        from . import crashpoint

        dest = self._key_path(key)
        tmp = os.path.join(
            self._tmp, f"{os.path.basename(dest)}."
                       f"{os.getpid()}.{threading.get_ident()}.part")
        nbytes = 0
        try:
            with open(tmp, "wb") as out:
                while True:
                    block = fileobj.read(_COPY_BLOCK)
                    if not block:
                        break
                    nbytes += len(block)
                    out.write(block)
                out.flush()
                os.fsync(out.fileno())
            crashpoint("pre_commit")
            os.replace(tmp, dest)
        except BaseException:
            if os.path.isfile(tmp):
                os.unlink(tmp)
            raise
        return nbytes

    def get_object(self, key: str) -> BinaryIO:
        return open(self._key_path(key), "rb")

    def head_object(self, key: str) -> Optional[int]:
        try:
            return os.stat(self._key_path(key)).st_size
        except OSError:
            return None

    def delete_object(self, key: str) -> bool:
        try:
            os.unlink(self._key_path(key))
            return True
        except OSError:
            return False

    def list_objects(self) -> Iterator[tuple[str, int]]:
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for name in names:
            if name == ".tmp":
                continue
            try:
                yield name, os.stat(os.path.join(self.root, name)).st_size
            except OSError:
                continue

    def tmp_dirs(self) -> tuple[str, ...]:
        return (self._tmp,)


class _HashingReader:
    """Wraps a stream so the digest accumulates as the client consumes
    it — integrity verification rides the single copy the upload makes
    instead of a second full read."""

    def __init__(self, fileobj: BinaryIO) -> None:
        self._f = fileobj
        self.hasher = hashlib.sha256()

    def read(self, n: int = -1) -> bytes:
        block = self._f.read(n)
        if block:
            self.hasher.update(block)
        return block


class ObjectBackend:
    """Cold tier over an ObjectClient; keys are bare sha256 digests."""

    kind = "object"

    def __init__(self, client: ObjectClient) -> None:
        self.client = client

    def put(self, src_path: str, sha256: str) -> None:
        with open(src_path, "rb") as f:
            self.put_stream(f, sha256)

    def put_stream(self, fileobj: BinaryIO, sha256: str) -> int:
        from . import BackendIntegrityError

        if self.client.head_object(sha256) is not None:
            size = self.client.head_object(sha256)
            return int(size or 0)
        reader = _HashingReader(fileobj)
        nbytes = self.client.put_object_stream(sha256, reader)
        if reader.hasher.hexdigest() != sha256:
            # the PUT already landed; take it back out — a wrong-keyed
            # object must never become readable
            self.client.delete_object(sha256)
            raise BackendIntegrityError(
                f"object {sha256[:12]}: streamed digest "
                f"{reader.hasher.hexdigest()[:12]} does not match its key"
            )
        return nbytes

    def open_read(self, sha256: str) -> BinaryIO:
        return self.client.get_object(sha256)

    def head(self, sha256: str) -> Optional[int]:
        return self.client.head_object(sha256)

    def delete(self, sha256: str) -> bool:
        return self.client.delete_object(sha256)

    def list(self) -> Iterator[tuple[str, int]]:
        return self.client.list_objects()

    def local_path(self, sha256: str) -> Optional[str]:
        return None

    def tmp_dirs(self) -> tuple[str, ...]:
        return self.client.tmp_dirs()
