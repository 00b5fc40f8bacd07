"""`python -m processing_chain_tpu_torch tools chain-lint` — run the
chain's own static analysis on the port (its package and chip_smoke.py by
default) against the port's registries and baseline.

Exit codes: 0 clean (baselined findings allowed), 1 findings or stale
baseline entries, 2 usage/configuration errors. Run bare, it is the
port's gate; `--update-baseline --reason "…"` is the grandfathering
workflow (docs/LINT.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from .baseline import (
    DEFAULT_BASELINE, BaselineError, apply_baseline, load_baseline,
    write_baseline,
)
from .core import ALL_RULES, LintConfig, run_lint


def find_repo_root(start: Optional[str] = None) -> str:
    """Nearest ancestor holding the package dir (or .git) — chain-lint
    must work from any cwd inside the checkout."""
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(cur, "processing_chain_tpu_torch")) or \
                os.path.isdir(os.path.join(cur, ".git")):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return os.path.abspath(start or os.getcwd())
        cur = nxt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tools chain-lint",
        description="invariant-aware static analysis for the chain "
                    "(rules: %s)" % ", ".join(ALL_RULES),
    )
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the shipped tree)")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detect from cwd)")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: <root>/{DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (report everything)")
    p.add_argument("--rules", default=None,
                   help="comma-separated subset of rules to run")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline: keep matched entries, add "
                        "current findings under --reason, expire stale")
    p.add_argument("--reason", default=None,
                   help="reason recorded for entries added by "
                        "--update-baseline (required with it)")
    p.add_argument("--allow-stale", action="store_true",
                   help="don't fail on stale baseline entries")
    p.add_argument("--show-baselined", action="store_true",
                   help="also print suppressed (baselined) findings")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(list(argv) if argv is not None else None)
    root = os.path.abspath(args.root) if args.root else find_repo_root()
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(ALL_RULES)
        if unknown:
            print(f"chain-lint: unknown rule(s): {sorted(unknown)} "
                  f"(known: {', '.join(ALL_RULES)})", file=sys.stderr)
            return 2
    else:
        rules = None
    if args.update_baseline and not args.reason:
        print("chain-lint: --update-baseline requires --reason "
              "(every grandfathered finding must say why)", file=sys.stderr)
        return 2

    cfg = LintConfig(
        root=root,
        targets=[os.path.abspath(p) for p in args.paths],
        rules=rules,
    )
    findings = run_lint(cfg)
    n_files = sum(1 for _ in cfg.iter_files())

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    entries = []
    if not args.no_baseline:
        try:
            entries = load_baseline(baseline_path)
        except BaselineError as exc:
            print(f"chain-lint: {exc}", file=sys.stderr)
            return 2
    result = apply_baseline(findings, entries)

    if args.update_baseline:
        kept = [e for e in entries if e not in result.stale]
        n = write_baseline(baseline_path, result.new, kept, args.reason)
        print(f"chain-lint: baseline updated: {n} entries "
              f"({len(result.new)} added, {len(result.stale)} expired) "
              f"-> {baseline_path}")
        return 0

    if args.as_json:
        print(json.dumps({
            "root": root,
            "files": n_files,
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "symbol": f.symbol, "message": f.message,
                 "fingerprint": f.fingerprint()}
                for f in result.new
            ],
            "baselined": len(result.baselined),
            "stale_baseline_entries": [
                e.as_dict() for e in result.stale
            ],
        }, indent=1))
    else:
        for f in result.new:
            print(f.render())
        if args.show_baselined and result.baselined:
            print(f"-- {len(result.baselined)} baselined finding(s):")
            for f in result.baselined:
                print(f"   (baselined) {f.render()}")
        for e in result.stale:
            print(f"chain-lint: STALE baseline entry ({e.rule} at {e.path}"
                  f" [{e.symbol}]): the finding is gone — expire it with "
                  "--update-baseline")
        counts: dict = {}
        for f in result.new:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        if result.new:
            summary = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
            print(f"chain-lint: FAIL — {len(result.new)} finding(s) "
                  f"({summary})"
                  + (f", {len(result.baselined)} baselined" if result.baselined else "")
                  + f" in {n_files} file(s)")
        elif result.stale and not args.allow_stale:
            print(f"chain-lint: FAIL — {len(result.stale)} stale baseline "
                  "entr(y/ies)")
        else:
            print("chain-lint: OK — 0 findings"
                  + (f", {len(result.baselined)} baselined" if result.baselined else "")
                  + (f", {len(result.stale)} stale (allowed)" if result.stale else "")
                  + f" in {n_files} file(s)")

    if result.new:
        return 1
    if result.stale and not args.allow_stale:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
