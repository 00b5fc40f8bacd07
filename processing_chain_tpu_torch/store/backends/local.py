"""Filesystem CAS backends: the classic `objects/` layout (hot) and the
same layout on a second shared root (warm).

The layout and commit protocol are the store's originals, extracted
verbatim (docs/STORE.md "On-disk layout"): `objects/<sha[:2]>/<sha>`,
tmp + rename commits with pid+thread-unique scratch names, an explicit
ingestion-time mtime stamp so GC's min-object-age guard protects
adopted-but-ancient files. An existing flat store root therefore opens
under a LocalBackend with zero migration.

The port's copy of processing_chain_tpu/store/backends/local.py.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import threading
from typing import BinaryIO, Iterator, Optional

_COPY_BLOCK = 1 << 20


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        # cross-device stores (or filesystems without hardlinks) copy
        shutil.copyfile(src, dst)


class LocalBackend:
    """One `objects/` directory plus its in-flight `tmp/` scratch."""

    kind = "local"

    def __init__(self, objects_dir: str, tmp_dir: str) -> None:
        self.objects_dir = os.path.abspath(objects_dir)
        self.tmp_dir = os.path.abspath(tmp_dir)
        os.makedirs(self.objects_dir, exist_ok=True)
        os.makedirs(self.tmp_dir, exist_ok=True)

    # ------------------------------------------------------------ layout

    def local_path(self, sha256: str) -> Optional[str]:
        return os.path.join(self.objects_dir, sha256[:2], sha256)

    def tmp_dirs(self) -> tuple[str, ...]:
        return (self.tmp_dir,)

    def _tmp_name(self, sha256: str) -> str:
        # pid+thread-unique: two workers committing byte-identical
        # objects must not truncate one scratch file under each other
        return os.path.join(
            self.tmp_dir,
            f"{sha256}.{os.getpid()}.{threading.get_ident()}.part",
        )

    # ------------------------------------------------------------ writes

    def put(self, src_path: str, sha256: str) -> None:
        obj = self.local_path(sha256)
        if os.path.isfile(obj):
            return  # identical objects dedupe by construction
        os.makedirs(os.path.dirname(obj), exist_ok=True)
        tmp = self._tmp_name(sha256)
        try:
            _link_or_copy(src_path, tmp)
            os.replace(tmp, obj)
        except BaseException:
            if os.path.isfile(tmp):
                os.unlink(tmp)
            raise
        self._stamp(obj)

    def put_stream(self, fileobj: BinaryIO, sha256: str) -> int:
        from . import BackendIntegrityError, crashpoint

        obj = self.local_path(sha256)
        if os.path.isfile(obj):
            return os.stat(obj).st_size
        os.makedirs(os.path.dirname(obj), exist_ok=True)
        tmp = self._tmp_name(sha256)
        hasher = hashlib.sha256()
        nbytes = 0
        try:
            with open(tmp, "wb") as out:
                while True:
                    block = fileobj.read(_COPY_BLOCK)
                    if not block:
                        break
                    hasher.update(block)
                    nbytes += len(block)
                    out.write(block)
                out.flush()
                os.fsync(out.fileno())
            if hasher.hexdigest() != sha256:
                raise BackendIntegrityError(
                    f"object {sha256[:12]}: streamed digest "
                    f"{hasher.hexdigest()[:12]} does not match its key"
                )
            crashpoint("pre_commit")
            os.replace(tmp, obj)
        except BaseException:
            if os.path.isfile(tmp):
                os.unlink(tmp)
            raise
        self._stamp(obj)
        return nbytes

    @staticmethod
    def _stamp(obj: str) -> None:
        try:
            # hardlinked objects inherit the SOURCE file's mtime; stamp
            # ingestion time explicitly so GC's min-object-age guard
            # protects a just-committed object regardless of its origin
            os.utime(obj)
        except OSError:
            pass

    # ------------------------------------------------------------- reads

    def open_read(self, sha256: str) -> BinaryIO:
        return open(self.local_path(sha256), "rb")

    def head(self, sha256: str) -> Optional[int]:
        try:
            return os.stat(self.local_path(sha256)).st_size
        except OSError:
            return None

    def delete(self, sha256: str) -> bool:
        try:
            os.unlink(self.local_path(sha256))
            return True
        except OSError:
            return False

    def list(self) -> Iterator[tuple[str, int]]:
        try:
            shards = sorted(os.listdir(self.objects_dir))
        except OSError:
            return
        for shard in shards:
            shard_dir = os.path.join(self.objects_dir, shard)
            if not os.path.isdir(shard_dir):
                continue
            for name in sorted(os.listdir(shard_dir)):
                try:
                    yield name, os.stat(
                        os.path.join(shard_dir, name)).st_size
                except OSError:
                    continue


class SharedBackend(LocalBackend):
    """The warm tier: the identical layout rooted at a second local-FS
    path (typically a mount the whole fleet shares). Separate class so
    configs and forensics name the ROLE, not just the medium."""

    kind = "shared"

    def __init__(self, root: str) -> None:
        root = os.path.abspath(root)
        super().__init__(os.path.join(root, "objects"),
                         os.path.join(root, "tmp"))
        self.root = root
