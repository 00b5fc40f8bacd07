"""Filesystem write discipline (copy of `atomic_write`, `atomic_write_text`
and `atomic_write_json` from
processing_chain_tpu/utils/fsio.py)."""

from __future__ import annotations

import json
import os
import threading
from typing import Callable


def _fsync_path(path: str) -> None:
    """Best-effort fsync of an existing path (file or directory)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, write_fn: Callable[[str], None],
                 durable: bool = False) -> None:
    """Write `path` via temp-then-os.replace so an interrupted run never
    leaves a truncated file that a later run's exists-check would trust
    (same-directory temp keeps the replace atomic). `write_fn` receives
    the temp path; the temp is removed on failure. The temp name is pid-
    and thread-unique, so concurrent writers of one path never share a
    temp file.

    `durable=True` additionally fsyncs the temp file before the replace
    and (best-effort) the parent directory after it: tmp+rename alone is
    SIGKILL-proof but not power-loss-proof."""
    tmp = f"{path}.part.{os.getpid()}.{threading.get_ident()}"
    try:
        write_fn(tmp)
        if durable:
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        if os.path.isfile(tmp):
            os.unlink(tmp)
        raise
    if durable:
        _fsync_path(os.path.dirname(os.path.abspath(path)))


def atomic_write_text(path: str, text: str, durable: bool = False) -> None:
    """atomic_write of one pre-rendered string: owns the open/close so no
    caller can forget the flush before the replace."""
    def _write(tmp: str) -> None:
        with open(tmp, "w") as f:
            f.write(text)

    atomic_write(path, _write, durable=durable)


def atomic_write_json(path: str, obj, durable: bool = False,
                      **json_kw) -> None:
    """atomic_write of one JSON document (indent=1 by default, the chain's
    artifact style)."""
    json_kw.setdefault("indent", 1)

    def _write(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(obj, f, **json_kw)

    atomic_write(path, _write, durable=durable)
