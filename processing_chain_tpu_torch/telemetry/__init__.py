"""Telemetry subsystem of the port: metrics registry + structured events
(trimmed copy of processing_chain_tpu/telemetry/__init__.py).

Carries what the serve path uses: process-wide enablement, the metric
constructors, the event log and the heartbeat registry. The stage spans,
the profiling monitor and the run-output writers of the reference are
not carried over. Enablement is OFF by default; every instrumentation
site pays one attribute check while it is off. Metric and event names
are the reference catalog's (telemetry/catalog.py).
"""

from __future__ import annotations

from .events import (  # noqa: F401  (re-exports)
    EVENTS,
    EventLog,
    emit,
)
from .heartbeat import HEARTBEATS, HeartbeatRegistry  # noqa: F401
from .metrics import (  # noqa: F401
    REGISTRY,
    MetricError,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)


def enabled() -> bool:
    return REGISTRY.enabled


def enable() -> None:
    REGISTRY.enabled = True
    EVENTS.enabled = True
    HEARTBEATS.enabled = True


def disable() -> None:
    REGISTRY.enabled = False
    EVENTS.enabled = False
    HEARTBEATS.enabled = False


def reset() -> None:
    """Zero all series, drop all events and heartbeats (registrations
    and bound handles stay valid)."""
    REGISTRY.reset()
    EVENTS.clear()
    HEARTBEATS.reset()
