"""What a serve unit of work IS: the Executor protocol + built-ins (port
of processing_chain_tpu/serve/executors.py).

An executor turns a validated per-PVS unit into (a) a *plan* — the
JSON-able payload whose store hash is the unit's identity for dedup,
warm hits and artifact addressing — and (b) bytes on disk, produced by
`run_batch` for a whole wave of units at once. The batch signature is
the point: units from DIFFERENT requests that share a `bucket_key`
(geometry bucket, parallel/p03_batch semantics) are handed to one call
so the executor can pack them into one device wave.

Built-ins:

  * `synthetic` — deterministic pseudo-artifacts (bytes derived from
    the canonical plan), optional simulated work time. The toy-corpus
    executor CI smoke, the soak harness and the kill/restart test run
    against: cheap, exactly reproducible, and honest about identity
    (different params ⇒ different plan hash ⇒ different artifact).
  * `wave` — REAL shared device waves: builds a p03_batch.Lane per unit
    (deterministic synthetic YUV), drives the whole bucket through
    `run_bucket` on the executor's device (the `resize_ring` and
    `siti_partials` CUDA kernels on a card), writes the scaled Y, U and
    V planes. Same plans, hashes and bytes as the reference executor.

The reference's `chain` executor (real databases through p01-p04) needs
the file-level readers and writers, which the port does not have yet
(ROADMAP Queue A item 11); `make_executor("chain")` says so.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Optional, Protocol

import numpy as np

from .. import telemetry as tm
from ..store import keys
from ..utils.fsio import atomic_write, atomic_write_text
from ..utils.runner import ChainError
from .api import Unit

_WAVES = tm.counter(
    "chain_serve_waves_total", "batched executions dispatched by the scheduler"
)
_WAVE_LANES = tm.histogram(
    "chain_serve_wave_lanes", "units packed into each dispatched wave"
)


class Executor(Protocol):
    """The serve execution contract (docs/SERVE.md "Executors")."""

    kind: str

    def plan(self, unit: Unit) -> dict:
        """JSON-able identity payload: everything that determines the
        artifact's bytes. Hashed by the store (plan-hash dedup key)."""
        ...

    def output_name(self, unit: Unit, plan_hash: str) -> str:
        """Artifact filename under the serve artifacts root."""
        ...

    def bucket_key(self, unit: dict) -> Optional[tuple]:
        """Geometry bucket for wave packing; None = cannot batch.
        Called with the RECORD's unit dict (queue.JobRecord.unit).
        MUST NOT raise: it runs inside every scheduler worker's packing
        pass over the whole queued snapshot, so one unparseable record
        would poison every worker — return None instead."""
        ...

    def validate_params(self, params: dict) -> None:
        """Reject executor params this executor cannot execute
        (raise ValueError). Called at the HTTP front door so a bad
        request 400s instead of becoming a durable queue record."""
        ...

    def src_digest(self, record_unit: dict) -> Optional[str]:
        """Content digest of the unit's SRC bytes — the poison-
        quarantine key (docs/SERVE.md "Failure taxonomy"): a `poison`
        settle quarantines this digest fleet-wide, so every plan
        referencing the same hostile upload fails fast. Same totality
        contract as bucket_key (None = no digest, digest quarantine
        simply never applies to the unit); never raise."""
        ...

    def cost_features(self, record_unit: dict) -> Optional[dict]:
        """Feature dict for the predicted-cost model (serve/cost.py:
        work_s / out_bytes / enc_fmpix / dev_fmpix / cpvs_fmpix /
        codec / complexity). Same totality contract as bucket_key —
        it runs at the POST front door and in the scheduler's packing
        pass, so return None for an unparseable unit, never raise
        (cost.predict_unit_cost guards anyway and falls back to
        DEFAULT_COST_S)."""
        ...

    def run_batch(self, units: list[Unit], outputs: list[str]) -> None:
        """Produce every output. Called inside engine.Job (sentinels,
        store commit, telemetry ride along)."""
        ...


def _unit_of(record_unit: dict) -> Unit:
    return Unit(
        database=record_unit["database"], src=record_unit["src"],
        hrc=record_unit["hrc"], params=dict(record_unit.get("params", {})),
    )


def record_waves(n_units: int) -> None:
    """Wave accounting shared by every executor dispatch path."""
    _WAVES.inc()
    _WAVE_LANES.observe(float(n_units))


class SyntheticExecutor:
    """Deterministic toy processing: artifact bytes are a SHA-256
    stream over the canonical plan. Params (all optional):

        size_bytes  artifact size (default 4096)
        work_ms     simulated compute per unit (default 0)
        geometry    [w, h] — units sharing it batch into one wave
        fail_times  fault injection: the first N execution attempts of
                    this unit raise a TRANSIENT ChainError (a durable
                    counter next to the output tracks attempts across
                    replica restarts) — the chaos/soak harnesses' disk-
                    error stand-in, exercising retry + backoff
        poison      fault injection: every attempt raises a PERMANENT
                    ChainError — exercises the quarantine path
        poison_src  fault injection: every attempt raises a POISON
                    ChainError — the corrupt-upload stand-in: the unit's
                    SRC content digest is quarantined fleet-wide, so
                    sibling plans sharing the SRC fail fast without
                    executing (docs/ROBUSTNESS.md; the serve-chaos
                    --corrupt-corpus workload rides this)
    """

    kind = "synthetic"

    def plan(self, unit: Unit) -> dict:
        return {
            "op": "serve.synthetic",
            "schema": 1,
            "database": unit.database,
            "src": unit.src,
            "hrc": unit.hrc,
            "params": dict(unit.params),
        }

    def output_name(self, unit: Unit, plan_hash: str) -> str:
        return f"{unit.pvs_id}_{plan_hash[:12]}.bin"

    def validate_params(self, params: dict) -> None:
        geometry = params.get("geometry")
        if geometry is not None:
            try:
                if isinstance(geometry, (str, bytes)):
                    raise TypeError
                [int(g) for g in geometry]
            except (TypeError, ValueError):
                raise ValueError(
                    "params.geometry must be a list of integers, got "
                    f"{geometry!r}"
                ) from None
        for key, cast in (("work_ms", float), ("size_bytes", int),
                          ("fail_times", int)):
            if params.get(key) is not None:
                try:
                    cast(params[key])
                except (TypeError, ValueError):
                    raise ValueError(
                        f"params.{key} must be a number, got {params[key]!r}"
                    ) from None
        for flag in ("poison", "poison_src"):
            if not isinstance(params.get(flag, False), bool):
                raise ValueError(
                    f"params.{flag} must be a boolean, got "
                    f"{params[flag]!r}"
                )

    def bucket_key(self, record_unit: dict) -> Optional[tuple]:
        try:
            geometry = record_unit.get("params", {}).get("geometry")
            if not geometry:
                return None
            return ("synthetic", *(int(g) for g in geometry))
        except (AttributeError, TypeError, ValueError):
            # a pre-validation durable record with garbage params (null,
            # non-dict, unparseable geometry): unbatchable, never a raise
            return None

    def cost_features(self, record_unit: dict) -> Optional[dict]:
        """Synthetic units declare their cost outright: work_ms of
        simulated compute + the artifact bytes they write."""
        try:
            params = record_unit.get("params", {}) or {}
            return {
                "work_s": float(params.get("work_ms", 0) or 0) / 1e3,
                "out_bytes": float(params.get("size_bytes", 4096) or 4096),
            }
        except (AttributeError, TypeError, ValueError):
            return None

    def src_digest(self, record_unit: dict) -> Optional[str]:
        """Synthetic SRCs have no file bytes; their digest is the
        deterministic hash of the (database, src) identity — which is
        exactly what makes the poison-sweep fleet semantics testable:
        every unit naming one SRC shares one digest."""
        try:
            return hashlib.sha256(
                f"synthetic:{record_unit['database']}:{record_unit['src']}"
                .encode()
            ).hexdigest()
        except (KeyError, TypeError, AttributeError):
            return None

    def _inject_failures(self, unit: Unit, output: str) -> None:
        """Scripted fault injection (chaos/soak harnesses only; see the
        class docstring). Raises BEFORE any bytes are produced, so an
        injected failure never leaves a half-made artifact behind."""
        params = unit.params
        if params.get("poison_src"):
            # attributed verdict: naming the digest on the exception is
            # what the real executor does (first-contact validation),
            # and it is what lets the scheduler convict the SRC from a
            # packed wave instead of waiting for a solo-wave retry
            raise ChainError(
                f"injected poison SRC for {output} (corrupt upload "
                "stand-in)", kind="poison",
                src_digest=self.src_digest(
                    {"database": unit.database, "src": unit.src}),
            )
        if params.get("poison"):
            raise ChainError(
                f"injected permanent failure for {output}",
                kind="permanent",
            )
        fail_times = int(params.get("fail_times", 0) or 0)
        if fail_times > 0:
            marker = output + ".injected-failures"
            try:
                with open(marker) as f:
                    injected = int(f.read().strip() or "0")
            except (OSError, ValueError):
                injected = 0
            if injected < fail_times:
                atomic_write_text(marker, str(injected + 1))
                raise ChainError(
                    f"injected transient failure {injected + 1}/"
                    f"{fail_times} for {output}",
                    kind="transient",
                )

    def run_batch(self, units: list[Unit], outputs: list[str]) -> None:
        record_waves(len(units))
        for unit, output in zip(units, outputs):
            params = unit.params
            self._inject_failures(unit, output)
            work_ms = float(params.get("work_ms", 0) or 0)
            if work_ms > 0:
                time.sleep(work_ms / 1000.0)
            size = int(params.get("size_bytes", 4096) or 4096)
            seed = keys.canonical_json(self.plan(unit)).encode()
            chunks: list[bytes] = []
            digest = hashlib.sha256(seed).digest()
            produced = 0
            while produced < size:
                chunks.append(digest)
                produced += len(digest)
                digest = hashlib.sha256(digest).digest()
            data = b"".join(chunks)[:size]

            def _write(tmp: str, payload: bytes = data) -> None:
                with open(tmp, "wb") as f:
                    f.write(payload)

            atomic_write(output, _write)


class _PlaneFile:
    """The emit sink of one wave lane: writes each block's Y, U and V
    planes straight into the unit's output file at their final offsets
    (all Y frames, then all U, then all V; the reference's byte layout),
    so the pinned host blocks `run_bucket` hands out are released as
    soon as they are written instead of being held for the whole unit.
    The file has its full length only once every frame is in, so
    `check_complete` must hold before it is committed: a short lane
    would otherwise leave zero-filled gaps."""

    def __init__(self, fd: int, n_frames: int, name: str) -> None:
        self._fd = fd
        self._n = n_frames
        self._name = name
        self._t = 0  # frames written so far

    def __call__(self, planes: list) -> None:
        if self._t + planes[0].shape[0] > self._n:
            raise ChainError(
                f"{self._name}: lane emitted more than {self._n} frames")
        base = 0
        for plane in planes:
            frame_bytes = plane[0].nbytes
            view = memoryview(np.ascontiguousarray(plane)).cast("B")
            offset = base + self._t * frame_bytes
            while view:
                written = os.pwrite(self._fd, view, offset)
                view = view[written:]
                offset += written
            base += self._n * frame_bytes
        self._t += planes[0].shape[0]

    def check_complete(self) -> None:
        if self._t != self._n:
            raise ChainError(
                f"{self._name}: lane emitted {self._t} of {self._n} frames")


class DeviceWaveExecutor(SyntheticExecutor):
    """Real cross-request device waves: every unit in the batch becomes
    one p03_batch.Lane over deterministic synthetic YUV, and the whole
    bucket runs through `run_bucket` on the executor's device —
    independent requests share the wave step's kernel launches. Params:

        frames            lane length (default 8)
        src_h/src_w       source geometry (default 36x64)
        dst_h/dst_w       target geometry (default 72x128)

    `device=None` means every visible card (the wave mesh spans them,
    `cuda:0` holding the staging) and raises where CUDA is absent (the
    executor never moves to the CPU on its own); a pinned device (tests
    pass "cpu") gives a one-slot mesh on it.
    """

    kind = "wave"

    _GEO = ("src_h", "src_w", "dst_h", "dst_w")
    _DEFAULTS = {"frames": 8, "src_h": 36, "src_w": 64,
                 "dst_h": 72, "dst_w": 128}

    def __init__(self, device=None) -> None:
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self._pinned = device is not None
        if self.device.type == "cuda":
            # build the wave step's kernels now, so a first-use nvcc run
            # never sits inside a job's execution lease
            from ..ops import _build

            _build.build()

    def _geometry(self, params: dict) -> dict:
        geo = dict(self._DEFAULTS)
        for key in ("frames", *self._GEO):
            if key in params:
                geo[key] = int(params[key])
        return geo

    def plan(self, unit: Unit) -> dict:
        # Byte for byte the reference executor's plan: the same unit
        # hashes to the same plan hash and artifact name in both
        # packages. Sound only because the port's u8 bicubic resize and
        # quantize equal the reference's golden swscale path bit for bit
        # (tests/test_torch_serve.py holds the artifacts equal), so
        # either package's bytes may answer the other's plan.
        plan = super().plan(unit)
        plan["op"] = "serve.wave"
        plan["geometry"] = self._geometry(unit.params)
        return plan

    def validate_params(self, params: dict) -> None:
        for key in ("frames", *self._GEO):
            if key in params:
                try:
                    value = int(params[key])
                except (TypeError, ValueError):
                    raise ValueError(
                        f"params.{key} must be an integer, got "
                        f"{params[key]!r}"
                    ) from None
                if value <= 0:
                    raise ValueError(
                        f"params.{key} must be positive, got {value}"
                    )

    def bucket_key(self, record_unit: dict) -> Optional[tuple]:
        # params=None stays unbatchable (not defaulted): _unit_of would
        # reject the record at dispatch, and a solo wave confines that
        # failure instead of letting it take healthy siblings down
        try:
            geo = self._geometry(record_unit.get("params", {}))
        except (AttributeError, TypeError, ValueError):
            return None  # pre-validation garbage record: unbatchable
        return ("wave",) + tuple(geo[k] for k in self._GEO)

    def cost_features(self, record_unit: dict) -> Optional[dict]:
        """Wave units are device resizes: frames × destination pixels."""
        try:
            geo = self._geometry(record_unit.get("params", {}))
        except (AttributeError, TypeError, ValueError):
            return None
        return {
            "dev_fmpix": geo["frames"] * geo["dst_h"] * geo["dst_w"] / 1e6,
            "out_bytes": geo["frames"] * geo["dst_h"] * geo["dst_w"] * 1.5,
        }

    def _mesh(self):
        from ..parallel.mesh import make_mesh

        return make_mesh([self.device] if self._pinned else None)

    def source_planes(self, unit: Unit) -> list:
        """The unit's seeded synthetic YUV ([T, H, W] u8 Y, U, V), the
        seed taken from its canonical plan as in the reference."""
        geo = self._geometry(unit.params)
        n, sh, sw = geo["frames"], geo["src_h"], geo["src_w"]
        seed = int.from_bytes(
            hashlib.sha256(
                keys.canonical_json(self.plan(unit)).encode()
            ).digest()[:8], "big",
        )
        rng = np.random.default_rng(seed)
        return [
            rng.integers(0, 255, size=(n, sh, sw), dtype=np.uint8),
            rng.integers(0, 255, size=(n, sh // 2, sw // 2), dtype=np.uint8),
            rng.integers(0, 255, size=(n, sh // 2, sw // 2), dtype=np.uint8),
        ]

    def run_batch(self, units: list[Unit], outputs: list[str]) -> None:
        import torch

        from ..parallel import p03_batch

        record_waves(len(units))
        if self.device.type == "cuda":
            # scheduler worker thread: its current device must be ours
            # before run_bucket makes its copy stream
            torch.cuda.set_device(self.device)
        geo = self._geometry(units[0].params)
        sh, sw = geo["src_h"], geo["src_w"]
        dh, dw = geo["dst_h"], geo["dst_w"]
        tmps = [f"{out}.part.{os.getpid()}.{threading.get_ident()}"
                for out in outputs]
        files: list = []
        try:
            lanes, sinks = [], []
            for unit, tmp in zip(units, tmps):
                f = open(tmp, "wb")
                files.append(f)
                frames = self._geometry(unit.params)["frames"]
                sinks.append(_PlaneFile(f.fileno(), frames, unit.pvs_id))
                lanes.append(p03_batch.Lane(
                    chunks=iter([self.source_planes(unit)]),
                    emit=sinks[-1],
                    n_frames_hint=frames,
                    name=unit.pvs_id,  # wave-journal identity (meshobs)
                ))
            p03_batch.run_bucket(
                lanes, self._mesh(), dh, dw, "bicubic", (2, 2), False,
                chunk=8, bucket=p03_batch.bucket_label(dh, dw, False, sh, sw),
            )
            for sink in sinks:
                sink.check_complete()
            for f in files:
                f.close()
            for tmp, out in zip(tmps, outputs):
                os.replace(tmp, out)
        except BaseException:
            for f in files:
                f.close()
            for tmp in tmps:
                if os.path.isfile(tmp):
                    os.unlink(tmp)
            raise


EXECUTORS = {
    SyntheticExecutor.kind: SyntheticExecutor,
    DeviceWaveExecutor.kind: DeviceWaveExecutor,
}


def make_executor(kind: str, device=None):
    """The executor of `kind`; `device` goes to the device executors."""
    if kind == "chain":
        raise ValueError(
            "serve executor 'chain' is not ported yet: it waits for the "
            "port's file-level readers and writers (ROADMAP Queue A item 11)"
        )
    if kind == DeviceWaveExecutor.kind:
        return DeviceWaveExecutor(device=device)
    try:
        return EXECUTORS[kind]()
    except KeyError:
        raise ValueError(
            f"unknown serve executor {kind!r}; known: "
            f"{sorted([*EXECUTORS, 'chain'])}"
        ) from None
