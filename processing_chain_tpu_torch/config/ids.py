"""ID grammar of the P.NATS Phase 2 database contract (copy of
processing_chain_tpu/config/ids.py).

Parity target: reference lib/test_config.py:1012-1018. These regexes are the
public naming contract with existing databases and must not drift.
"""

from __future__ import annotations

import re

from .errors import ConfigError

REGEX_DATABASE_ID = r"P2(S|L)(TR|PT|IT|VL|XM)[\d]{2,3}"
REGEX_QL_ID = r"Q[\d]+"
REGEX_CODING_ID = r"(A|V)C[\d]+"
REGEX_SRC_ID = r"SRC[\d]{3,5}"
REGEX_HRC_ID = r"HRC[\d]{3,4}"
REGEX_PVS_ID = r"P2(S|L)(TR|PT|IT|VL|XM)[\d]{2,3}_SRC[\d]{3,5}_HRC[\d]{3,4}"
REGEX_CPVS_ID = (
    r"P2(S|L)(TR|PT|IT|VL|XM)[\d]{2,3}_SRC[\d]{3,5}_HRC[\d]{3,4}_(PC|MO|TA|HD|UH)"
)


def validate(kind: str, value: str, pattern: str) -> str:
    """Check `value` against the ID `pattern` (anchored at the start, like the
    reference's re.match) and return it; raise ConfigError otherwise."""
    if not re.match(pattern, value):
        raise ConfigError(f"{kind} ID {value!r} does not match syntax {pattern}")
    return value


def src_id_of_pvs(pvs_id: str) -> str:
    """Extract the SRC id embedded in a PVS id (reference :1420)."""
    m = re.findall(r"SRC\d+", pvs_id)
    if not m:
        raise ConfigError(f"PVS ID {pvs_id!r} contains no SRC id")
    return m[0]


def hrc_id_of_pvs(pvs_id: str) -> str:
    """Extract the HRC id embedded in a PVS id (reference :1421)."""
    m = re.findall(r"HRC\d+", pvs_id)
    if not m:
        raise ConfigError(f"PVS ID {pvs_id!r} contains no HRC id")
    return m[0]
