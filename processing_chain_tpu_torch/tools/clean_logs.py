"""Purge transient chain byproducts from a database folder (copy of
processing_chain_tpu/tools/clean_logs.py).

Parity target: reference util/clean_logs.sh:19-23 — removes `*.log`,
`*.mbtree` (x264 two-pass lookahead stats) and `*.temp` files left in the
database tree. Here the two-pass stats files (`*.stats`, `*.stats.cutree`,
the libav names for what x264's CLI calls mbtree) and trace reports are
included; provenance `.log` files are only removed with `--provenance`
since they are the chain's per-artifact audit trail.
"""

from __future__ import annotations

import argparse
import fnmatch
import os
from typing import Optional, Sequence

from ..utils.log import get_logger

# NOTE: *.inprogress crash sentinels (engine/jobs.Job) are deliberately
# NOT purged here — deleting one would make the next run trust a
# possibly-truncated artifact; Job completion removes them itself.
TRANSIENT_PATTERNS = (
    "*.mbtree", "*.temp", "*.stats", "*.stats.cutree", "*.stats.mbtree",
)
PROVENANCE_PATTERNS = ("*.log", "trace_*.json")
#: barrier markers are only swept once no run can still be polling them
#: (fs_barrier's wait times out after 24 h)
BARRIER_PATTERN = ".barrier_*"
BARRIER_MIN_AGE_S = 25 * 3600.0


def collect(
    root: str, include_provenance: bool = False
) -> list[str]:
    import time

    patterns = TRANSIENT_PATTERNS + (
        PROVENANCE_PATTERNS if include_provenance else ()
    )
    now = time.time()
    hits: list[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            path = os.path.join(dirpath, name)
            if any(fnmatch.fnmatch(name, pat) for pat in patterns):
                hits.append(path)
            elif fnmatch.fnmatch(name, BARRIER_PATTERN):
                # an active multi-host run may be waiting on this marker
                try:
                    if now - os.path.getmtime(path) > BARRIER_MIN_AGE_S:
                        hits.append(path)
                except OSError:
                    pass
    return sorted(hits)


def run(
    root: str, include_provenance: bool = False, dry_run: bool = False
) -> list[str]:
    log = get_logger()
    removed = []
    for path in collect(root, include_provenance):
        if dry_run:
            log.info("[dry-run] would remove %s", path)
        else:
            log.debug("removing %s", path)
            os.unlink(path)
        removed.append(path)
    log.info(
        "%s %d transient file(s) under %s",
        "would remove" if dry_run else "removed", len(removed), root,
    )
    return removed


def build_parser(
    parser: Optional[argparse.ArgumentParser] = None,
) -> argparse.ArgumentParser:
    parser = parser or argparse.ArgumentParser(
        description="purge transient chain byproducts from a database folder"
    )
    parser.add_argument("root", help="database folder to clean")
    parser.add_argument(
        "--provenance", action="store_true",
        help="also remove provenance .log files and trace reports",
    )
    parser.add_argument("-n", "--dry-run", action="store_true")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.root):
        get_logger().error("%s is not a directory", args.root)
        return 1
    run(args.root, include_provenance=args.provenance, dry_run=args.dry_run)
    return 0
