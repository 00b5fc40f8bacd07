"""`tools serve-admin` — operator surface for the serve quarantine.

The poison registry (docs/SERVE.md "Failure taxonomy", docs/
ROBUSTNESS.md "Quarantine & re-arm") quarantines hostile SRC uploads by
CONTENT DIGEST: one JSON entry per digest under `<root>/poison/`,
written when an execution settles with the `poison` failure kind, and
consulted at every enqueue so sibling plans fail fast fleet-wide. This
CLI is the operator's handle on it:

    python -m processing_chain_tpu_torch tools serve-admin \
        --root DIR poison ls                # every registry entry
    python -m processing_chain_tpu_torch tools serve-admin \
        --root DIR poison show DIGEST       # one entry, full forensics
    python -m processing_chain_tpu_torch tools serve-admin \
        --root DIR poison rearm DIGEST      # drop entry, re-arm records

`rearm` drops the registry entry and re-arms every quarantined record
carrying the digest (fresh attempts budget) — the step after replacing
or repairing a convicted upload. If the bytes are still hostile, the
next execution re-convicts the digest; nothing is lost by re-arming.

All subcommands operate on the shared serve ROOT over the same durable
queue surface the replicas use (flock-serialized), so they are safe to
run against a live fleet.

The port's copy of processing_chain_tpu/tools/serve_admin.py.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..utils.log import get_logger


class _QueueHandle:
    """Scoped operator handle on the shared durable queue: opened like
    any replica (recovery + liveness claims), ALWAYS closed so the
    admin's transient identity never pins stale liveness."""

    def __init__(self, root: str) -> None:
        self._root = root

    def __enter__(self):
        import os

        from ..serve.queue import DurableQueue

        self._q = DurableQueue(os.path.join(self._root, "queue"),
                               replica="serve-admin")
        return self._q

    def __exit__(self, *exc) -> None:
        self._q.close()


def poison_ls(args) -> int:
    with _QueueHandle(args.root) as q:
        entries = q.poisoned_digests()
    print(json.dumps({"poisoned": entries, "count": len(entries)},
                     sort_keys=True))
    return 0


def poison_show(args) -> int:
    with _QueueHandle(args.root) as q:
        entry = q.src_poisoned(args.digest)
    if entry is None:
        get_logger().error("serve-admin: digest %s is not in the poison "
                           "registry", args.digest)
        return 1
    print(json.dumps(entry, sort_keys=True))
    return 0


def poison_rearm(args) -> int:
    with _QueueHandle(args.root) as q:
        result = q.rearm_src(args.digest)
    print(json.dumps(result, sort_keys=True))
    if not result["was_poisoned"]:
        get_logger().warning(
            "serve-admin: digest %s was not in the registry (re-armed "
            "%d stray quarantined record(s))", args.digest,
            len(result["rearmed"]))
    else:
        get_logger().info(
            "serve-admin: digest %s cleared; %d record(s) re-armed",
            args.digest, len(result["rearmed"]))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tools serve-admin",
        description="operator surface for the serve poison quarantine "
                    "(docs/ROBUSTNESS.md)",
    )
    p.add_argument("--root", required=True,
                   help="the serve root shared by the replica fleet")
    sub = p.add_subparsers(dest="surface", required=True)
    poison = sub.add_parser("poison", help="the SRC-digest quarantine")
    psub = poison.add_subparsers(dest="action", required=True)
    psub.add_parser("ls", help="list every quarantined digest")
    show = psub.add_parser("show", help="one entry, full forensics")
    show.add_argument("digest")
    rearm = psub.add_parser("rearm",
                            help="drop the entry, re-arm its records")
    rearm.add_argument("digest")
    args = p.parse_args(argv)
    return {"ls": poison_ls, "show": poison_show,
            "rearm": poison_rearm}[args.action](args)


if __name__ == "__main__":
    raise SystemExit(main())
