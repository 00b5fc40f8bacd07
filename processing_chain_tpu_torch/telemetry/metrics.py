"""Process-wide metrics registry: counters, gauges, histograms with labels
(copy of processing_chain_tpu/telemetry/metrics.py without its file
writers).

The chain's quantitative observability layer (docs/TELEMETRY.md). Design
constraints, in order:

  1. Zero hot-path cost when telemetry is off. Every mutation method
     starts with a plain attribute check on the shared registry — no
     dict, tuple, or string allocation happens for a disabled metric.
     Hot loops (prefetch chunks, writer chunks) bind a labeled child
     ONCE outside the loop (`metric.labels(queue="decode")`) and call
     `inc`/`observe` on the bound handle.
  2. Thread-safe like `utils.tracing.Tracer`: producers are the decode /
     encode / pool worker threads; one registry lock serializes updates
     (mutation frequency is per-chunk, not per-frame, so a coarse lock
     costs nothing measurable).
  3. Self-describing exports: `snapshot()` (JSON-able dict) and
     `render_prometheus()` (the Prometheus text format, served at
     /metrics).

Metric names follow Prometheus conventions: `chain_<noun>_<unit>_total`
for counters, `_seconds` histograms for latencies.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Iterable, Optional, Sequence
from ..utils import lockdebug

DEFAULT_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0,
)
DEFAULT_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)


class MetricError(ValueError):
    """Registration/usage contract violation (kind or label mismatch)."""


class _Bound:
    """A metric narrowed to one label-value tuple. Mutations check the
    registry's `enabled` flag first so a disabled chain pays one
    attribute load + branch, nothing else."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "_Metric", key: tuple) -> None:
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        metric = self._metric
        # kind check BEFORE the enabled check (like set/observe): a wrong
        # call site must fail in telemetry-off CI runs, not only on the
        # first production --telemetry run
        if metric.kind == "histogram":
            raise MetricError(f"{metric.name}: inc() on a histogram")
        if not metric._registry.enabled:
            return
        with metric._registry._lock:
            metric._values[self._key] = metric._values.get(self._key, 0.0) + amount

    def dec(self, amount: float = 1.0) -> None:
        if self._metric.kind != "gauge":
            raise MetricError(f"{self._metric.name}: dec() on a {self._metric.kind}")
        self.inc(-amount)

    def set(self, value: float) -> None:
        metric = self._metric
        if metric.kind != "gauge":
            raise MetricError(f"{metric.name}: set() on a {metric.kind}")
        if not metric._registry.enabled:
            return
        with metric._registry._lock:
            metric._values[self._key] = float(value)

    def observe(self, value: float) -> None:
        metric = self._metric
        if metric.kind != "histogram":
            raise MetricError(f"{metric.name}: observe() on a {metric.kind}")
        if not metric._registry.enabled:
            return
        with metric._registry._lock:
            state = metric._values.get(self._key)
            if state is None:
                state = [0] * (len(metric.buckets) + 1), [0.0, 0]
                metric._values[self._key] = state
            counts, agg = state
            counts[bisect_left(metric.buckets, value)] += 1
            agg[0] += value
            agg[1] += 1

    def get(self) -> float:
        """Current value (counter/gauge) — 0.0 when never touched."""
        metric = self._metric
        with metric._registry._lock:
            if metric.kind == "histogram":
                state = metric._values.get(self._key)
                return float(state[1][0]) if state else 0.0
            return float(metric._values.get(self._key, 0.0))


class _Metric:
    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help_: str,
        kind: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> None:
        self._registry = registry
        self.name = name
        self.help = help_
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets)) if kind == "histogram" else ()
        # counter/gauge: {label values: float}
        # histogram:     {label values: ([bucket counts..., +inf count], [sum, n])}
        self._values: dict = {}  # guarded-by: _registry._lock
        self._bound: dict[tuple, _Bound] = {}  # guarded-by: _registry._lock
        self._nolabels = _Bound(self, ())

    def labels(self, **labels: str) -> _Bound:
        """Bound child for one label-value combination; cached, so hot
        paths can call this once and keep the handle."""
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise MetricError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(sorted(labels))}"
            )
        key = tuple(str(labels[n]) for n in self.labelnames)
        # chainlint: disable=lock-guard (deliberate lock-free fast path: dict.get is GIL-atomic and a miss falls through to the locked setdefault below — hot loops bind once, never see a torn entry)
        bound = self._bound.get(key)
        if bound is None:
            with self._registry._lock:
                bound = self._bound.setdefault(key, _Bound(self, key))
        return bound

    # unlabeled convenience passthroughs
    def inc(self, amount: float = 1.0) -> None:
        self._nolabels.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._nolabels.dec(amount)

    def set(self, value: float) -> None:
        self._nolabels.set(value)

    def observe(self, value: float) -> None:
        self._nolabels.observe(value)

    def get(self) -> float:
        return self._nolabels.get()


class MetricsRegistry:
    """Get-or-create registry. Creating the same metric twice returns the
    first instance; re-creating under a different kind/labelset raises
    (two modules silently disagreeing on a metric is always a bug)."""

    def __init__(self) -> None:
        self._lock = lockdebug.make_lock("metrics")
        self._metrics: dict[str, _Metric] = {}  # guarded-by: _lock
        self.enabled = False

    def _get_or_create(
        self, name: str, help_: str, kind: str,
        labelnames: Sequence[str], buckets: Optional[Sequence[float]],
    ) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind or existing.labelnames != tuple(labelnames):
                    raise MetricError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(labelnames)} but exists as {existing.kind}"
                        f"{existing.labelnames}"
                    )
                return existing
            metric = _Metric(self, name, help_, kind, labelnames, buckets)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_: str = "", labelnames: Sequence[str] = ()) -> _Metric:
        return self._get_or_create(name, help_, "counter", labelnames, None)

    def gauge(self, name: str, help_: str = "", labelnames: Sequence[str] = ()) -> _Metric:
        return self._get_or_create(name, help_, "gauge", labelnames, None)

    def histogram(
        self, name: str, help_: str = "", labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ) -> _Metric:
        return self._get_or_create(name, help_, "histogram", labelnames, buckets)

    def reset(self) -> None:
        """Zero every series (registrations survive — module-level bound
        handles must stay valid across runs in one process)."""
        with self._lock:
            for metric in self._metrics.values():
                metric._values.clear()

    def sum_series(self, name: str, labels: Optional[dict] = None) -> Optional[float]:
        """Sum of the current values (counter/gauge) or observation sums
        (histogram) across one metric's series matching `labels` (all
        series when None). Returns None when NO matching series has ever
        recorded — callers that must distinguish 'never measured' from
        'measured zero' (the attribution engine) need exactly that, and
        a full snapshot() of every metric to read one name would stall
        concurrent updates for nothing."""
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                return None
            total, found = 0.0, False
            for key, value in metric._values.items():
                if labels is not None and dict(zip(metric.labelnames, key)) != {
                    k: str(v) for k, v in labels.items()
                }:
                    continue
                found = True
                total += (
                    float(value[1][0]) if metric.kind == "histogram"
                    else float(value)
                )
            return total if found else None

    def snapshot(self) -> dict:
        """JSON-able view of every series."""
        out: dict = {}
        with self._lock:
            for name, metric in sorted(self._metrics.items()):
                series = []
                for key in sorted(metric._values):
                    labels = dict(zip(metric.labelnames, key))
                    if metric.kind == "histogram":
                        counts, (total, n) = metric._values[key]
                        series.append({
                            "labels": labels,
                            "count": n,
                            "sum": round(total, 6),
                            "buckets": {
                                ("+Inf" if i == len(metric.buckets) else repr(metric.buckets[i])): c
                                for i, c in enumerate(counts)
                            },
                        })
                    else:
                        series.append({
                            "labels": labels,
                            "value": round(float(metric._values[key]), 6),
                        })
                out[name] = {
                    "kind": metric.kind,
                    "help": metric.help,
                    "labelnames": list(metric.labelnames),
                    "series": series,
                }
        return out

    def render_prometheus(self) -> str:
        """node_exporter textfile-collector format."""
        def fmt_labels(labels: dict, extra: Optional[tuple] = None) -> str:
            items = list(labels.items()) + ([extra] if extra else [])
            if not items:
                return ""
            body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
            return "{" + body + "}"

        lines: list[str] = []
        snap = self.snapshot()
        for name, data in snap.items():
            if data["help"]:
                lines.append(f"# HELP {name} {data['help']}")
            lines.append(f"# TYPE {name} {data['kind']}")
            for s in data["series"]:
                if data["kind"] == "histogram":
                    cum = 0
                    for le, c in s["buckets"].items():
                        cum += c
                        lines.append(
                            f"{name}_bucket{fmt_labels(s['labels'], ('le', le))} {cum}"
                        )
                    lines.append(f"{name}_sum{fmt_labels(s['labels'])} {s['sum']}")
                    lines.append(f"{name}_count{fmt_labels(s['labels'])} {s['count']}")
                else:
                    lines.append(f"{name}{fmt_labels(s['labels'])} {_num(s['value'])}")
        return "\n".join(lines) + ("\n" if lines else "")

def _escape(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _num(value: float) -> str:
    return repr(int(value)) if float(value).is_integer() else repr(value)


REGISTRY = MetricsRegistry()


def counter(name: str, help_: str = "", labelnames: Iterable[str] = ()) -> _Metric:
    return REGISTRY.counter(name, help_, tuple(labelnames))


def gauge(name: str, help_: str = "", labelnames: Iterable[str] = ()) -> _Metric:
    return REGISTRY.gauge(name, help_, tuple(labelnames))


def histogram(
    name: str, help_: str = "", labelnames: Iterable[str] = (),
    buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
) -> _Metric:
    return REGISTRY.histogram(name, help_, tuple(labelnames), buckets)
