"""Operator surface of the artifact store: `tools store <cmd>`.

    tools store ls       [--store DIR]             manifest inventory
    tools store verify   [--store DIR] [--deep] [--drop]
    tools store gc       [--store DIR] [--max-bytes N] [--dry-run]
                         [--tmp-max-age S] [--min-object-age S]
    tools store pin      [--store DIR] HASH [--label TEXT]
    tools store unpin    [--store DIR] HASH
    tools store tier     [--store DIR] ls
    tools store tier     [--store DIR] promote|demote HASH

The store root resolves like the pipeline's: --store DIR, else
PC_STORE_DIR; the placement spec (hot/warm/cold tiers, docs/STORE.md
"Tier hierarchy") resolves from --tiers SPEC, else PC_STORE_TIERS. `verify` deep-checks every manifest's objects and exits 1
when corruption is found (counted in chain_store_corrupt_total); with
--drop, corrupt manifests are removed so the next pipeline run rebuilds
exactly those artifacts. `gc` is store.gc.collect with a human report —
the same run-report ergonomics as `tools run-report` (docs/STORE.md).

The port's copy of processing_chain_tpu/tools/store_admin.py, routed as
`tools store` (the reference's name) and as `tools store-admin`.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from ..store import gc as store_gc
from ..store import heat as store_heat
from ..store.store import ArtifactStore, StoreCorruption
from ..utils.log import get_logger


def _human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def _parse_bytes(text: str) -> int:
    """'500M', '2G', '1024' → bytes."""
    text = text.strip().upper()
    mult = 1
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30),
                      ("T", 1 << 40)):
        if text.endswith(suffix) or text.endswith(suffix + "B"):
            text = text[: -1 - text.endswith(suffix + "B")]
            mult = m
            break
    return int(float(text) * mult)


def _open_store(root: Optional[str],
                tiers: Optional[str] = None) -> ArtifactStore:
    # plan-exempt: (names WHERE the store lives, never what an artifact contains)
    root = root or os.environ.get("PC_STORE_DIR") or ""
    if not root:
        raise ValueError(
            "no store root: pass --store DIR or set PC_STORE_DIR"
        )
    if not os.path.isdir(root):
        # admin never creates a store (the pipeline does): a mistyped
        # root must error, not mkdir an empty tree and report a false
        # "verified 0 ok" all-clear
        raise ValueError(f"store root {root} does not exist")
    # plan-exempt: (names WHERE artifact bytes are placed, never what they contain)
    tiers = tiers or os.environ.get("PC_STORE_TIERS") or None
    return ArtifactStore(root, tier_spec=tiers)


def _cmd_ls(store: ArtifactStore) -> int:
    pins = store.pins()
    rows = []
    for m in store.iter_manifests():
        age_s = max(0.0, time.time() - m.created_at) if m.created_at else 0.0
        size = m.object.get("size", 0)
        size += sum(d.get("size", 0) for d in m.sidecars.values())
        size += sum(d.get("size", 0) for d in m.extras.values())
        rows.append((
            m.plan_hash[:12],
            _human_bytes(size),
            f"{age_s / 3600:.1f}h",
            "pin" if m.plan_hash in pins else "",
            "adopted" if m.provenance.get("adopted") else "",
            m.producer,
        ))
    if not rows:
        print(f"{store.root}: empty store")
        return 0
    widths = [max(len(r[i]) for r in rows) for i in range(5)]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r[:5], widths)) + "  " + r[5])
    s = store.stats()
    print(
        f"-- {s['manifests']} manifest(s), {s['objects']} object(s), "
        f"{_human_bytes(s['bytes'])}, {s['pins']} pin(s)"
    )
    return 0


def _cmd_verify(store: ArtifactStore, deep: bool, drop: bool) -> int:
    ok = 0
    corrupt = []
    # unparseable manifest files first: lookup reports them as misses
    # (read paths must not mutate the store), so iter_manifests would
    # silently walk past them — verify is where they must surface
    for name in sorted(os.listdir(store.manifests_dir)):
        if not name.endswith(".json"):
            continue
        ph = name[:-5]
        if (store.lookup(ph) is None
                and os.path.isfile(store.manifest_path(ph))):
            corrupt.append((ph, None, "manifest unreadable/unparseable"))
    for m in store.iter_manifests():
        try:
            for digest in m.all_digests():
                store.verify_object(digest, deep=deep)
            ok += 1
        except StoreCorruption as exc:
            corrupt.append((m.plan_hash, m, str(exc)))
    for ph, m, why in corrupt:
        print(f"CORRUPT {ph[:12]} ({m.producer if m else '?'}): {why}")
        if drop:
            if m is not None:
                # bytes go with the manifest: a rebuild re-produces the
                # same digest and _ingest would dedupe onto the corrupt
                # object (unknowable for an unparseable manifest — its
                # orphaned objects fall to `gc`)
                store.drop_corrupt_objects(m)
            store._drop_manifest(ph)
    if corrupt and drop:
        print(
            f"dropped {len(corrupt)} corrupt manifest(s); the next "
            "pipeline run rebuilds exactly those artifacts (orphaned "
            "objects are swept by `tools store-admin gc`)"
        )
    print(
        f"-- verified {ok} ok, {len(corrupt)} corrupt "
        f"({'deep' if deep else 'spot'} check)"
    )
    return 1 if corrupt else 0


def _cmd_gc(store: ArtifactStore, max_bytes: Optional[int], dry_run: bool,
            tmp_max_age: float, min_object_age: float) -> int:
    # a real (non-dry) pass journals its evictions so the serve fleet's
    # regret detector sees operator-driven evictions too — the CLI and
    # the pressure hook must not keep separate forensic truths
    heat = None if dry_run else store_heat.HeatLedger(
        store.root, replica="store-gc"
    )
    report = store_gc.collect(
        store, size_budget_bytes=max_bytes, dry_run=dry_run,
        tmp_max_age_s=tmp_max_age, min_object_age_s=min_object_age,
        heat=heat,
    )
    tag = "[dry-run] " if dry_run else ""
    print(f"{tag}tmp swept:        {report['tmp_removed']}")
    print(f"{tag}orphans removed:  {report['orphans_removed']} "
          f"({_human_bytes(report['orphan_bytes'])})")
    if report["demotions"]:
        print(f"{tag}demoted:          {len(report['demotions'])} "
              f"object(s) ({_human_bytes(report['demoted_bytes'])})")
        for d in report["demotions"]:
            print(f"{tag}  demote {d['object'][:12]}  "
                  f"{d['from_tier']} -> {d['to_tier']}  "
                  f"{d.get('reads', 0)} recorded read(s)  "
                  f"{_human_bytes(d['bytes'])}")
    print(f"{tag}manifests evicted:{len(report['evicted_manifests']):>2} "
          f"({_human_bytes(report['evicted_bytes'])})")
    # per-victim evidence: the SAME dicts the store_evict events and
    # the heat ledger's forensics journal carry (store/gc.py) — tier
    # included, so the render says which tier the bytes actually left
    for v in report["victims"]:
        if v["reason"] == "orphan":
            print(f"{tag}  orphan {v['object'][:12]}  "
                  f"tier {v.get('tier', 'hot')}  "
                  f"age {v['age_s'] / 3600:.1f}h  "
                  f"freed {_human_bytes(v['freed_bytes'])}")
        else:
            print(f"{tag}  evict {v['plan'][:12]}  over budget  "
                  f"from {v.get('tier', 'hot')}  "
                  f"last used {v['last_used_age_s'] / 3600:.1f}h ago  "
                  f"{v['reads']} recorded read(s)  "
                  f"freed {_human_bytes(v['freed_bytes'])}")
    print(f"{tag}kept:             {report['kept_manifests']} manifest(s), "
          f"{_human_bytes(report['kept_bytes'])}")
    print(f"{tag}freed:            {_human_bytes(report['bytes_freed'])} "
          f"({report['objects_evicted']} object(s)); "
          f"{report['pins_honored']} pin(s) honored")
    if heat is not None:
        heat.close()
    return 0


def _cmd_tier(store: ArtifactStore, action: str,
              ref: Optional[str]) -> int:
    """Placement inspection and manual moves (docs/STORE.md "Tier
    hierarchy"). `promote`/`demote` accept a plan hash (moves every
    object the manifest references) or a bare object sha256."""
    tiers = store.tiers
    if action == "ls":
        stats = tiers.tier_stats()
        for t in tiers.tiers:
            s = stats[t.name]
            budget = (_human_bytes(t.budget_bytes)
                      if t.budget_bytes else "-")
            print(f"{t.name:<8} {t.backend.kind:<7} "
                  f"{s['objects']:>6} object(s)  "
                  f"{_human_bytes(s['bytes']):>10}  budget {budget}")
        if not tiers.multi:
            print("-- single-tier store (no --tiers / PC_STORE_TIERS "
                  "spec in force)")
        return 0
    if not ref:
        raise ValueError(f"tier {action} needs a plan hash or object "
                         "sha256")
    manifest = store.lookup(ref)
    if manifest is not None:
        shas = [(d["sha256"], ref) for d in manifest.all_digests()]
    else:
        shas = [(ref, None)]
    # manual moves journal like automatic ones: the forensics trail
    # must not have operator-shaped holes
    heat = store_heat.HeatLedger(store.root, replica="store-admin")
    status = 0
    try:
        for sha, plan in shas:
            src = tiers.locate(sha)
            if src is None:
                print(f"absent  {sha[:12]}: in no tier")
                status = 1
                continue
            if action == "promote":
                evidence = tiers.promote(sha, plan=plan, heat=heat)
                if evidence is None:
                    print(f"noop    {sha[:12]}: already hot")
                    continue
            else:
                i = tiers.tiers.index(src)
                if i == len(tiers.tiers) - 1:
                    print(f"noop    {sha[:12]}: already in last tier "
                          f"({src.name})")
                    continue
                evidence = tiers.demote(sha, src, tiers.tiers[i + 1],
                                        plan=plan, heat=heat)
            print(f"{evidence['op']:<8}{evidence['object'][:12]}  "
                  f"{evidence['from_tier']} -> {evidence['to_tier']}  "
                  f"{_human_bytes(evidence['bytes'])}")
    finally:
        heat.close()
    return status


def main(argv: Optional[Sequence[str]] = None) -> int:
    # --store is accepted both before and after the subcommand (the
    # docs show the natural `tools store-admin verify --store DIR` order).
    # SUPPRESS keeps an unset subparser occurrence from clobbering a
    # pre-subcommand value with its default.
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--store", default=argparse.SUPPRESS, metavar="DIR",
                        help="store root (default: PC_STORE_DIR)")
    common.add_argument("--tiers", default=argparse.SUPPRESS,
                        metavar="SPEC",
                        help="hot/warm/cold placement spec "
                        "(default: PC_STORE_TIERS; see docs/STORE.md)")
    parser = argparse.ArgumentParser(prog="tools store", description=__doc__,
                                     parents=[common])
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ls", help="manifest inventory", parents=[common])
    p_verify = sub.add_parser("verify", help="integrity-check every object",
                              parents=[common])
    p_verify.add_argument("--deep", action="store_true",
                          help="full content digest for every object "
                          "(default: size + head/full spot check)")
    p_verify.add_argument("--drop", action="store_true",
                          help="remove corrupt manifests so the next run "
                          "rebuilds them")
    p_gc = sub.add_parser("gc", help="mark-and-sweep garbage collection",
                          parents=[common])
    p_gc.add_argument("--max-bytes", default=None, metavar="N",
                      help="LRU size budget (accepts K/M/G suffixes)")
    p_gc.add_argument("--dry-run", action="store_true")
    p_gc.add_argument("--tmp-max-age", default=3600.0, type=float,
                      metavar="S", help="sweep tmp/ entries older than S")
    p_gc.add_argument("--min-object-age", default=3600.0, type=float,
                      metavar="S", help="never sweep objects younger than S")
    p_pin = sub.add_parser("pin", help="exempt a plan hash from GC",
                           parents=[common])
    p_pin.add_argument("plan_hash")
    p_pin.add_argument("--label", default="")
    p_unpin = sub.add_parser("unpin", help="remove a pin", parents=[common])
    p_unpin.add_argument("plan_hash")
    p_tier = sub.add_parser("tier", help="tier placement: inspect and "
                            "move objects", parents=[common])
    p_tier.add_argument("action", choices=("ls", "promote", "demote"))
    p_tier.add_argument("ref", nargs="?", default=None,
                        help="plan hash or object sha256 "
                        "(promote/demote)")
    args = parser.parse_args(argv)

    store = _open_store(getattr(args, "store", None),
                        getattr(args, "tiers", None))
    if args.cmd == "ls":
        return _cmd_ls(store)
    if args.cmd == "verify":
        return _cmd_verify(store, deep=args.deep, drop=args.drop)
    if args.cmd == "gc":
        max_bytes = _parse_bytes(args.max_bytes) if args.max_bytes else None
        return _cmd_gc(store, max_bytes, args.dry_run, args.tmp_max_age,
                       args.min_object_age)
    if args.cmd == "tier":
        return _cmd_tier(store, args.action, args.ref)
    if args.cmd == "pin":
        store.pin(args.plan_hash, args.label)
        get_logger().info("pinned %s", args.plan_hash[:12])
        return 0
    store.unpin(args.plan_hash)
    get_logger().info("unpinned %s", args.plan_hash[:12])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
