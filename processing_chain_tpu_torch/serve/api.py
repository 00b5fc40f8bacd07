"""Request grammar of the serve surface (copy of
processing_chain_tpu/serve/api.py).

A processing request names a database and an SRC×HRC grid in the
P.NATS Phase 2 ID grammar the whole chain already enforces
(config/ids.py) — the serve layer validates at the front door with the
same regexes, so a malformed ID is a 400 here instead of a ConfigError
three stages deep. The grid expands into per-PVS *units*: one unit per
(database, SRC, HRC) cell plus the request's executor params, and the
unit (not the request) is the grain of queueing, dedup and execution —
two requests whose grids overlap share the overlapping units' jobs.
"""

from __future__ import annotations

import re
import secrets
from dataclasses import dataclass, field

from ..config import ids

#: priority classes and their scheduler weights (scheduler.py folds the
#: class weight into the tenant stride: interactive work drains ~4x
#: faster than normal, ~16x faster than bulk, but nothing starves)
PRIORITIES: dict[str, int] = {"interactive": 16, "normal": 4, "bulk": 1}

_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")

#: client-supplied trace ids (distributed-tracing context propagation:
#: a gateway that already minted a trace can thread it through the
#: chain); server-minted ones are `tr-<hex>` and always match
_TRACE_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.:-]{3,127}$")


def new_trace_id() -> str:
    """Mint a fleet-unique trace id for one request. Every
    POST /v1/requests gets one (client-supplied `trace` wins), and it
    rides the request doc, the durable queue records, the span journal
    and the job events end to end (docs/TELEMETRY.md)."""
    return "tr-" + secrets.token_hex(8)

#: one request may expand to at most this many units (a full config-5
#: database is 1000 PVSes; anything past this is a typo'd range, and a
#: million-cell grid must arrive as many requests, not one)
MAX_UNITS = 4096


class RequestError(ValueError):
    """A request document failed validation (HTTP 400)."""


@dataclass(frozen=True)
class Unit:
    """One PVS-granular unit of work: the queue/dedup/execution grain."""

    database: str
    src: str
    hrc: str
    params: dict = field(default_factory=dict, hash=False, compare=False)

    @property
    def pvs_id(self) -> str:
        return f"{self.database}_{self.src}_{self.hrc}"


def _require(payload: dict, key: str, typ: type) -> object:
    if key not in payload:
        raise RequestError(f"missing required field {key!r}")
    value = payload[key]
    if not isinstance(value, typ):
        raise RequestError(
            f"field {key!r} must be {typ.__name__}, got {type(value).__name__}"
        )
    return value


def _id_list(payload: dict, key: str, kind: str, pattern: str) -> list[str]:
    raw = _require(payload, key, list)
    if not raw:
        raise RequestError(f"field {key!r} must name at least one {kind}")
    out: list[str] = []
    for value in raw:
        if not isinstance(value, str):
            raise RequestError(f"{key!r} entries must be strings")
        try:
            ids.validate(kind, value, pattern)
        except Exception as exc:  # ConfigError ⊂ ValueError
            raise RequestError(str(exc)) from exc
        if value not in out:  # dedup inside one request, order kept
            out.append(value)
    return out


def validate_request(payload: object) -> dict:
    """Validate a POST /v1/requests document; returns the normalized
    form {tenant, priority, database, srcs, hrcs, params}. Everything
    wrong raises RequestError with an operator-readable message."""
    if not isinstance(payload, dict):
        raise RequestError("request body must be a JSON object")
    tenant = _require(payload, "tenant", str)
    if not _TENANT_RE.match(tenant):
        raise RequestError(
            f"tenant {tenant!r} does not match {_TENANT_RE.pattern}"
        )
    priority = payload.get("priority", "normal")
    if priority not in PRIORITIES:
        raise RequestError(
            f"priority {priority!r} not one of {sorted(PRIORITIES)}"
        )
    database = _require(payload, "database", str)
    try:
        ids.validate("database", database, ids.REGEX_DATABASE_ID)
    except Exception as exc:
        raise RequestError(str(exc)) from exc
    srcs = _id_list(payload, "srcs", "SRC", ids.REGEX_SRC_ID)
    hrcs = _id_list(payload, "hrcs", "HRC", ids.REGEX_HRC_ID)
    if len(srcs) * len(hrcs) > MAX_UNITS:
        raise RequestError(
            f"grid of {len(srcs)}x{len(hrcs)} units exceeds the per-request "
            f"cap of {MAX_UNITS}; split it into several requests"
        )
    params = payload.get("params", {})
    if not isinstance(params, dict):
        raise RequestError("field 'params' must be a JSON object")
    trace = payload.get("trace")
    if trace is not None:
        if not isinstance(trace, str) or not _TRACE_RE.match(trace):
            raise RequestError(
                f"trace {trace!r} does not match {_TRACE_RE.pattern}"
            )
    return {
        "tenant": tenant,
        "priority": priority,
        "database": database,
        "srcs": srcs,
        "hrcs": hrcs,
        "params": params,
        "trace": trace,
    }


def expand_units(normalized: dict) -> list[Unit]:
    """The SRC×HRC grid as per-PVS units, row-major (src outer)."""
    return [
        Unit(
            database=normalized["database"], src=src, hrc=hrc,
            params=dict(normalized["params"]),
        )
        for src in normalized["srcs"]
        for hrc in normalized["hrcs"]
    ]
