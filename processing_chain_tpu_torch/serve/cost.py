"""Predicted-cost model for the serve scheduler (docs/SERVE.md
"Cost-aware scheduling & admission").

The priors subsystem (docs/PRIORS.md) predicts per-clip coding cost
from metadata the chain already decoded; this module turns that — plus
the request's own geometry/codec/bitrate facts — into *predicted
execution seconds per unit*, and the serve layer consumes the number
three ways:

  * **wave packing** — the scheduler balances predicted seconds per
    wave instead of unit counts, so one wave of four heavy clips and
    one wave of four trivial ones stop being "the same size"
    (`Scheduler.wave_budget_s`);
  * **admission control** — a request whose cold units exceed the
    per-request or per-tenant budget is refused AT POST TIME with a
    429-style forensic body naming the predicted cost, the budget and
    the heaviest units, instead of becoming hours of durable queue
    backlog (`check_admission`);
  * **accounting** — per-tenant predicted/observed seconds ride the
    metrics surface (`chain_serve_cost_*`), merged fleet-wide by
    telemetry/fleet.py into /fleet and `tools fleet-top`.

The model is deliberately a small, documented parametric formula over
features each executor extracts from its own units
(`Executor.cost_features`), because an auditable estimator beats an
opaque one: the **feedback loop** records observed execution seconds
against each unit's prediction at settle time (`CostLedger.observed`)
and reports the model error (ratio percentiles, MAPE), so an operator
can SEE when the coefficients have drifted from the hardware.

The formula (coefficients below, seconds):

    cost_s = BASE_S + fixed_s                        # per-unit overhead
           + work_s                                  # declared work (synthetic)
           + out_bytes * BYTES_S                     # artifact write
           + enc_fmpix  * ENC_S_PER_FMPIX * codec_mult * complexity_mult
           + dev_fmpix  * DEVICE_S_PER_FMPIX        # device resize/render
           + cpvs_fmpix * CPVS_S_PER_FMPIX          # per-context rewrites

where *_fmpix are frame-megapixels (frames × width × height / 1e6),
`codec_mult` scales encoder families by their measured relative cost,
and `complexity_mult` comes from the priors complexity score
(QP-normalized rate — tools/complexity.get_priors_difficulty): a clip
twice as complex as the reference point costs ~2^(Δ/2) more to encode.

The port's copy of processing_chain_tpu/serve/cost.py.
"""

from __future__ import annotations

import math
from typing import Optional

from .. import telemetry as tm
from ..utils import lockdebug

_PREDICTED = tm.counter(
    "chain_serve_cost_predicted_seconds_total",
    "predicted execution seconds admitted into the queue, per tenant",
    ("tenant",),
)
_OBSERVED = tm.counter(
    "chain_serve_cost_observed_seconds_total",
    "observed execution seconds of settled units, per tenant",
    ("tenant",),
)
_ERROR_RATIO = tm.histogram(
    "chain_serve_cost_error_ratio",
    "observed/predicted execution-seconds ratio per settled unit — the "
    "cost model's audit trail (1.0 = perfect prediction)",
    buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.1, 1.5, 2.0, 4.0, 10.0),
)
_REJECTED = tm.counter(
    "chain_serve_cost_rejected_total",
    "requests refused by cost admission control, per reason",
    ("reason",),
)
_CAL_SCALE = tm.gauge(
    "chain_serve_cost_calibration_scale",
    "current per-host calibration multiplier applied to every cost "
    "prediction (1.0 = the documented base coefficients; refit from "
    "the CostLedger's observed/predicted ratio ring)",
)

# ------------------------------------------------------- model constants
#
# Equal to the reference's (processing_chain_tpu/serve/cost.py), so
# admission refusals and cost-aware wave packing come out the same in
# both packages on the same records. They are the reference's CPU-fitted
# base, NOT times measured on a CUDA card: they were calibrated against
# the reference container's CPU bench (docs/PERF.md: e2e ffv1 ~19 f/s at
# 160×90–640×360 scale ⇒ tens of ms per frame-megapixel across the four
# stages). A card's own figure is the calibration scale below, refit
# from its observed/predicted ratios (`--cost-calibrate`; PERF.md
# records the one fitted on an H100). Deliberately coarse — the
# feedback loop (`CostLedger.report`) is the instrument that says when
# they drift; the scheduler only needs RELATIVE ranking to pack waves
# and the admission gate only needs the right order of magnitude.

#: fixed per-unit overhead (job bookkeeping, store commit, probes);
#: executors with heavier per-unit setup (the chain's four stage
#: passes) add their own `fixed_s` feature on top
BASE_S = 0.02
#: seconds per artifact byte written (≈ 300 MB/s effective writeback)
BYTES_S = 1.0 / (300 * 1024 * 1024)
#: encode seconds per frame-megapixel (x264-class software encode;
#: from the repo's own e2e bench: ~0.3 s/fMpix across the four stages
#: on the reference container, split ~1/3 encode)
ENC_S_PER_FMPIX = 0.10
#: device resize/render seconds per frame-megapixel (AVPVS pass)
DEVICE_S_PER_FMPIX = 0.10
#: per-PostProcessing CPVS rewrite seconds per frame-megapixel
CPVS_S_PER_FMPIX = 0.08
#: encoder-family relative cost multipliers (libx264 ≡ 1.0)
CODEC_MULT = {
    "h264": 1.0, "libx264": 1.0,
    "h265": 2.5, "hevc": 2.5, "libx265": 2.5,
    "vp9": 3.0, "libvpx-vp9": 3.0,
    "av1": 4.0, "libaom-av1": 4.0, "libsvtav1": 2.0,
}
#: priors complexity score at which complexity_mult == 1.0 (the
#: reference-bitrate normalization of ops/siti puts typical SD/HD
#: content near here; see tools/complexity.py)
COMPLEXITY_REF = 5.0
#: complexity units per doubling of predicted encode cost
COMPLEXITY_PER_DOUBLING = 2.0
#: complexity_mult clamp — the model must never let one mis-probed clip
#: claim a 1000x cost
COMPLEXITY_MULT_RANGE = (0.5, 4.0)
#: predicted cost for a unit whose features are unknowable (foreign
#: record, raising feature hook): keeps packing/accounting total
DEFAULT_COST_S = 1.0

# ----------------------------------------------------- host calibration
#
# The base coefficients above were measured on ONE reference container;
# a deployment's hosts run the same formula at a different absolute
# speed (and the fused p04 path shifts execution seconds again). The
# calibration layer refits a single per-host SCALE from the ledger's
# observed/predicted ratio ring — one auditable number (reported in
# /status and /fleet, and as `chain_serve_cost_calibration_scale`)
# instead of silently re-deriving every coefficient. A scale is all the
# scheduler needs: wave packing and admission compare RELATIVE costs,
# and the absolute budget error is exactly the median ratio the refit
# removes.

#: refuse to fit from fewer settled observations than this
CALIBRATION_MIN_SAMPLES = 32
#: fitted-scale clamp: one pathological soak must not 100x the gate
CALIBRATION_SCALE_RANGE = (0.1, 10.0)

_CAL_LOCK = lockdebug.make_lock("serve_cost_cal")
_CALIBRATION: dict = {"scale": 1.0, "n": 0}   # guarded-by: _CAL_LOCK


def calibration() -> dict:
    """The calibration in force: {"scale", "n" (samples behind it)}."""
    with _CAL_LOCK:
        return dict(_CALIBRATION)


def calibration_scale() -> float:
    with _CAL_LOCK:
        return float(_CALIBRATION["scale"])


def set_calibration(scale: float, n: int = 0) -> dict:
    """Install a per-host prediction multiplier (clamped). Applied by
    `predict_unit_cost` to every later prediction."""
    lo, hi = CALIBRATION_SCALE_RANGE
    scale = float(min(hi, max(lo, scale)))
    with _CAL_LOCK:
        _CALIBRATION.update(scale=scale, n=int(n))
        doc = dict(_CALIBRATION)
    _CAL_SCALE.set(scale)
    return doc


def reset_calibration() -> None:
    with _CAL_LOCK:
        _CALIBRATION.update(scale=1.0, n=0)
    _CAL_SCALE.set(1.0)


def fit_scale(ratios: list, min_samples: int = CALIBRATION_MIN_SAMPLES
              ) -> Optional[dict]:
    """Fit a correction factor from observed/predicted ratios: the
    MEDIAN ratio (robust against the heavy tail warm-adjacent waves put
    on the mean), clamped. None when there are too few finite samples
    to trust a refit."""
    clean = sorted(
        r for r in ratios
        if isinstance(r, (int, float)) and math.isfinite(r) and r > 0
    )
    if len(clean) < max(1, min_samples):
        return None
    mid = len(clean) // 2
    median = (
        clean[mid] if len(clean) % 2
        else 0.5 * (clean[mid - 1] + clean[mid])
    )
    lo, hi = CALIBRATION_SCALE_RANGE
    return {"scale": round(min(hi, max(lo, median)), 4), "n": len(clean)}


def complexity_multiplier(complexity: Optional[float]) -> float:
    """Encode-cost multiplier from a priors complexity score (None —
    no priors available — is neutral)."""
    if complexity is None or not math.isfinite(complexity):
        return 1.0
    lo, hi = COMPLEXITY_MULT_RANGE
    # clamp the EXPONENT (an absurd score must not overflow pow)
    exponent = (complexity - COMPLEXITY_REF) / COMPLEXITY_PER_DOUBLING
    exponent = min(math.log2(hi), max(math.log2(lo), exponent))
    return float(min(hi, max(lo, 2.0 ** exponent)))


def codec_multiplier(codec: Optional[str]) -> float:
    if not codec:
        return 1.0
    return float(CODEC_MULT.get(str(codec).casefold(), 1.5))


def cost_from_features(features: Optional[dict]) -> float:
    """The documented formula (module docstring) over one unit's
    feature dict. Unknown/missing features contribute zero; a None
    feature dict costs DEFAULT_COST_S. Never raises, never negative."""
    if not isinstance(features, dict):
        return DEFAULT_COST_S
    try:
        cost = BASE_S
        cost += max(0.0, float(features.get("fixed_s", 0.0) or 0.0))
        cost += max(0.0, float(features.get("work_s", 0.0) or 0.0))
        cost += max(0.0, float(features.get("out_bytes", 0.0) or 0.0)) \
            * BYTES_S
        enc = max(0.0, float(features.get("enc_fmpix", 0.0) or 0.0))
        if enc:
            cost += (enc * ENC_S_PER_FMPIX
                     * codec_multiplier(features.get("codec"))
                     * complexity_multiplier(features.get("complexity")))
        cost += max(0.0, float(features.get("dev_fmpix", 0.0) or 0.0)) \
            * DEVICE_S_PER_FMPIX
        cost += max(0.0, float(features.get("cpvs_fmpix", 0.0) or 0.0)) \
            * CPVS_S_PER_FMPIX
        return cost
    except (TypeError, ValueError):
        return DEFAULT_COST_S


def predict_unit_cost(executor, record_unit: dict) -> float:
    """Predicted execution seconds for one unit under `executor`.
    Totality contract mirrors `bucket_key`: a unit the executor's
    feature hook cannot parse degrades to DEFAULT_COST_S, never a
    raise — this runs at the POST front door and in the scheduler's
    packing pass."""
    features = None
    hook = getattr(executor, "cost_features", None)
    if hook is not None:
        try:
            features = hook(record_unit)
        except Exception:  # noqa: BLE001 - any feature failure = default cost
            features = None
    # the per-host calibration multiplies the WHOLE prediction: the
    # observed/predicted ratio it was fitted from is a whole-cost ratio
    return cost_from_features(features) * calibration_scale()


# ----------------------------------------------------------- admission


class AdmissionError(Exception):
    """A request was refused by cost admission control (HTTP 429).
    `doc` is the forensic response body; `retryable` says whether the
    same request can succeed later (tenant budget frees as work
    settles) or is simply too big (split it)."""

    def __init__(self, message: str, doc: dict, retryable: bool) -> None:
        super().__init__(message)
        self.doc = dict(doc)
        self.doc.setdefault("error", message)
        self.doc["retryable"] = retryable
        self.retryable = retryable


def _heaviest(costed_units: list, n: int = 5) -> list[dict]:
    ranked = sorted(costed_units, key=lambda cu: -cu[1])[:n]
    return [{"pvs": pvs_id, "predicted_s": round(cost_s, 3)}
            for pvs_id, cost_s in ranked]


def check_admission(
    tenant: str,
    costed_units: list,
    request_budget_s: Optional[float],
    tenant_budget_s: Optional[float],
    tenant_outstanding_s: float,
) -> float:
    """Gate one request's COLD units (warm ones cost nothing) against
    the configured budgets. `costed_units` is [(pvs_id, cost_s), ...].
    Returns the request's total predicted seconds; raises
    AdmissionError (→ 429) when a budget is exceeded. Either budget
    being None disables that check."""
    predicted_s = sum(cost for _, cost in costed_units)
    if request_budget_s is not None and predicted_s > request_budget_s:
        _REJECTED.labels(reason="request_budget").inc()
        tm.emit("serve_admission_rejected", tenant=tenant,
                reason="request_budget",
                predicted_s=round(predicted_s, 3),
                budget_s=request_budget_s)
        raise AdmissionError(
            f"request predicted cost {predicted_s:.3g}s exceeds the "
            f"per-request budget {request_budget_s:.3g}s — split the "
            "grid into smaller requests",
            doc={
                "reason": "request_budget",
                "predicted_s": round(predicted_s, 3),
                "budget_s": request_budget_s,
                "cold_units": len(costed_units),
                "heaviest": _heaviest(costed_units),
            },
            retryable=False,
        )
    if tenant_budget_s is not None and \
            tenant_outstanding_s + predicted_s > tenant_budget_s:
        _REJECTED.labels(reason="tenant_budget").inc()
        tm.emit("serve_admission_rejected", tenant=tenant,
                reason="tenant_budget",
                predicted_s=round(predicted_s, 3),
                outstanding_s=round(tenant_outstanding_s, 3),
                budget_s=tenant_budget_s)
        raise AdmissionError(
            f"tenant {tenant!r} has {tenant_outstanding_s:.3g}s of work "
            f"outstanding; admitting {predicted_s:.3g}s more would exceed "
            f"the tenant budget {tenant_budget_s:.3g}s — retry as queued "
            "work settles",
            doc={
                "reason": "tenant_budget",
                "tenant": tenant,
                "predicted_s": round(predicted_s, 3),
                "outstanding_s": round(tenant_outstanding_s, 3),
                "budget_s": tenant_budget_s,
                "cold_units": len(costed_units),
                "heaviest": _heaviest(costed_units),
            },
            retryable=True,
        )
    return predicted_s


# ------------------------------------------------------------- feedback


class CostLedger:
    """Per-tenant cost accounting + the observed-vs-predicted feedback
    loop. Admitted predictions and settled observations land here (and
    on the `chain_serve_cost_*` counters the fleet view merges); the
    in-memory aggregates back /status and the soak report.

    The error ratios keep a bounded sample (newest-biased ring) — an
    always-on daemon must not grow an unbounded list, and model drift
    is a question about RECENT predictions anyway."""

    _MAX_RATIOS = 4096

    def __init__(self) -> None:
        self._lock = lockdebug.make_lock("serve_cost_ledger")
        self._tenants: dict[str, dict] = {}   # guarded-by: _lock
        self._ratios: list[float] = []        # guarded-by: _lock
        self._ratio_i = 0                     # guarded-by: _lock

    # holds-lock: _lock
    def _tenant(self, tenant: str) -> dict:
        return self._tenants.setdefault(tenant, {
            "predicted_s": 0.0, "observed_s": 0.0,
            "settled_units": 0, "warm_units": 0,
        })

    def admitted(self, tenant: str, predicted_s: float) -> None:
        """A request's cold units were admitted with this much
        predicted work."""
        if predicted_s <= 0:
            return
        with self._lock:
            self._tenant(tenant)["predicted_s"] += predicted_s
        _PREDICTED.labels(tenant=tenant).inc(predicted_s)

    def observed(self, tenant: str, predicted_s: float,
                 exec_s: float) -> None:
        """One unit settled after really executing for `exec_s`."""
        with self._lock:
            entry = self._tenant(tenant)
            entry["observed_s"] += exec_s
            entry["settled_units"] += 1
            if predicted_s > 0:
                ratio = exec_s / predicted_s
                if len(self._ratios) < self._MAX_RATIOS:
                    self._ratios.append(ratio)
                else:
                    self._ratios[self._ratio_i % self._MAX_RATIOS] = ratio
                self._ratio_i += 1
        _OBSERVED.labels(tenant=tenant).inc(exec_s)
        if predicted_s > 0:
            _ERROR_RATIO.observe(exec_s / predicted_s)

    def warm(self, tenant: str) -> None:
        """A unit settled from the store without executing."""
        with self._lock:
            self._tenant(tenant)["warm_units"] += 1

    def ratios(self) -> list:
        """Snapshot of the observed/predicted ratio ring."""
        with self._lock:
            return list(self._ratios)

    def calibrate(self, min_samples: int = CALIBRATION_MIN_SAMPLES
                  ) -> Optional[dict]:
        """Refit the per-host scale from the ratio ring and install it.
        The ring's ratios were observed against predictions carrying
        the scale in force at THEIR time, so the fit COMPOSES with the
        current scale (iterative refinement: a perfectly-calibrated
        host fits median ≈ 1 and the scale is a fixed point). A
        successful refit DRAINS the ring: its ratios are now stale
        (they argue against a scale no longer in force), and a
        periodic tick (--cost-calibrate) re-fitting them would
        compound the same correction exponentially. The next refit
        waits for `min_samples` fresh post-refit observations. Returns
        the installed calibration, or None when the ring is too thin."""
        fitted = fit_scale(self.ratios(), min_samples)
        if fitted is None:
            return None
        cal = set_calibration(
            calibration_scale() * fitted["scale"], fitted["n"]
        )
        with self._lock:
            self._ratios.clear()
            self._ratio_i = 0
        return cal

    def report(self) -> dict:
        """The auditable summary: per-tenant sums + model error. Error
        percentiles are over the observed/predicted ratio (1.0 =
        perfect); `mape` is mean |ratio - 1|."""
        from ..telemetry.fleet import percentile_exact

        with self._lock:
            tenants = {
                name: {
                    "predicted_s": round(entry["predicted_s"], 3),
                    "observed_s": round(entry["observed_s"], 3),
                    "settled_units": entry["settled_units"],
                    "warm_units": entry["warm_units"],
                }
                for name, entry in sorted(self._tenants.items())
            }
            ratios = list(self._ratios)
        error: Optional[dict] = None
        if ratios:
            error = {
                "n": len(ratios),
                "ratio_p50": round(percentile_exact(ratios, 0.50), 4),
                "ratio_p95": round(percentile_exact(ratios, 0.95), 4),
                "mape": round(
                    sum(abs(r - 1.0) for r in ratios) / len(ratios), 4
                ),
            }
        return {"tenants": tenants, "model_error": error}
