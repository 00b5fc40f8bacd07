"""Baseline: grandfathered findings, each with a mandatory reason.

The committed ``baseline.json`` beside this module lets the gate turn on before
every historical finding is fixed, without letting NEW violations in.
Semantics:

  * a finding whose fingerprint matches a baseline entry is *suppressed*
    (reported only under ``--show-baselined``);
  * a finding with no entry **fails** the lint;
  * an entry matching no finding is *stale* — the code got fixed, the
    entry must go. Stale entries fail the lint too (baseline hygiene is
    part of the gate; ``--allow-stale`` relaxes this for transitional
    branches) and ``--update-baseline`` expires them.
  * every entry carries a non-empty ``reason``; a reasonless entry is a
    lint error — nothing gets grandfathered silently.

Fingerprints are line-number-free (rule + file + symbol + normalized
source line), so unrelated edits above a grandfathered site don't churn
the file. ``--update-baseline`` preserves the reasons of surviving
entries and stamps new ones with the operator-supplied ``--reason``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from ...utils.fsio import atomic_write_text
from .core import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = "processing_chain_tpu_torch/tools/chainlint/baseline.json"


class BaselineError(ValueError):
    """Malformed baseline file (schema, or an entry without a reason)."""


@dataclass
class BaselineEntry:
    rule: str
    path: str
    symbol: str
    snippet: str
    reason: str

    def fingerprint(self) -> str:
        f = Finding(rule=self.rule, path=self.path, line=0,
                    message="", symbol=self.symbol)
        f.snippet = self.snippet
        return f.fingerprint()

    def as_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "symbol": self.symbol,
            "snippet": self.snippet, "reason": self.reason,
        }


@dataclass
class BaselineResult:
    new: list = field(default_factory=list)        # findings not baselined
    baselined: list = field(default_factory=list)  # suppressed findings
    stale: list = field(default_factory=list)      # entries with no finding


def load_baseline(path: str) -> list[BaselineEntry]:
    if not os.path.isfile(path):
        return []
    with open(path, encoding="utf-8") as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as exc:
            raise BaselineError(f"{path}: not valid JSON: {exc}") from exc
    if not isinstance(doc, dict) or "entries" not in doc:
        raise BaselineError(f"{path}: expected {{'version', 'entries'}}")
    entries = []
    for i, raw in enumerate(doc["entries"]):
        missing = {"rule", "path", "snippet", "reason"} - set(raw)
        if missing:
            raise BaselineError(
                f"{path}: entry {i} is missing {sorted(missing)}")
        if not str(raw["reason"]).strip():
            raise BaselineError(
                f"{path}: entry {i} ({raw['rule']} at {raw['path']}) has "
                "an empty reason — every grandfathered finding must say "
                "why it is exempt")
        entries.append(BaselineEntry(
            rule=raw["rule"], path=raw["path"],
            symbol=raw.get("symbol", ""), snippet=raw["snippet"],
            reason=str(raw["reason"]),
        ))
    return entries


def apply_baseline(findings: list[Finding],
                   entries: list[BaselineEntry]) -> BaselineResult:
    by_fp: dict[str, BaselineEntry] = {e.fingerprint(): e for e in entries}
    result = BaselineResult()
    matched: set[str] = set()
    for f in findings:
        fp = f.fingerprint()
        if fp in by_fp:
            matched.add(fp)
            result.baselined.append(f)
        else:
            result.new.append(f)
    result.stale = [e for e in entries if e.fingerprint() not in matched]
    return result


def write_baseline(path: str, findings: list[Finding],
                   keep: list[BaselineEntry], reason: str) -> int:
    """Rewrite the baseline: surviving entries keep their reasons, the
    still-unbaselined `findings` are added under `reason`, stale entries
    are dropped (expire). Returns the entry count written."""
    keep_fps = {e.fingerprint(): e for e in keep}
    entries = list(keep_fps.values())
    for f in findings:
        if f.fingerprint() not in keep_fps:
            entries.append(BaselineEntry(
                rule=f.rule, path=f.path, symbol=f.symbol,
                snippet=f.snippet, reason=reason,
            ))
    entries.sort(key=lambda e: (e.path, e.rule, e.snippet))
    payload = {
        "version": BASELINE_VERSION,
        "_comment": (
            "the port's grandfathered chainlint findings. Every entry needs "
            "a reason; entries whose finding is fixed are stale and expire "
            "via `python -m processing_chain_tpu_torch tools chain-lint "
            "--update-baseline`."
        ),
        "entries": [e.as_dict() for e in entries],
    }

    atomic_write_text(path, json.dumps(payload, indent=1) + "\n")
    return len(entries)
