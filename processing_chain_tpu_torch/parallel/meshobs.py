"""Device-plane flight recorder: wave occupancy accounting and the step
ledger (copy of processing_chain_tpu/parallel/meshobs.py).

  * **Per-wave occupancy.** Every dispatched wave step (one [n_pvs,
    t_step] block through the wave step) records its bucket, lanes and
    frame-slot breakdown:
      - `valid`          slots carrying real frames,
      - `pad_tail`       tail-repeat padding of a partial block,
      - `pad_exhausted`  slots burned by exhausted lanes riding the wave
                         until the longest lane finishes,
      - `pad_mesh`       batch-axis padding up to the mesh "pvs" size.
    By construction valid + pads == n_pvs x t_step (the dispatched slot
    count).
  * **Step ledger.** The wave step is cached per geometry, so one geometry
    flip costs exactly one new step; its first dispatch records its
    bucket, geometry and first-call seconds (`record_compile`, the JAX
    package's name for the same entry).
  * **One journal file per replica** (`<dir>/<replica>.jsonl`): appends
    are flushed (not fsynced), a predecessor's torn tail is sealed before
    the first append, readers tolerate a torn final line, and a disk fault
    degrades to a logged warning.

Record fields are those of the JAX package, so the two journals compare
field by field; a wave record also names its mesh ("{pvs}x{time}").
`journal_stats` is the tail-sampled summary for frequent readers.

Metrics (`chain_mesh_*`, the reference catalog's names) and the
`mesh_wave` / `mesh_compile` events update whether or not a journal is
attached, and the /status "mesh" section serves the in-memory aggregate
(`tools mesh-top` reads either).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Optional

from .. import telemetry as tm
from ..telemetry import live as _live
from ..utils.log import get_logger

WAVES = tm.counter(
    "chain_mesh_waves_total",
    "dispatched device wave-steps (one [n_pvs, t_step] block through the "
    "wave step), per geometry bucket",
    ("bucket",),
)
SLOTS = tm.counter(
    "chain_mesh_wave_slots_total",
    "frame-slots of dispatched wave-steps by occupancy kind (valid = real "
    "frames; pad_tail = tail-repeat padding; pad_exhausted = exhausted "
    "lanes riding the wave; pad_mesh = batch-axis padding) — the kinds "
    "sum to the dispatched slot count",
    ("bucket", "kind"),
)
WAVE_SECONDS = tm.histogram(
    "chain_mesh_wave_seconds",
    "wall seconds per dispatched wave-step, dispatch to outputs on the host "
    "(the overlapped next-block host assembly is excluded)",
    ("bucket",),
)
WASTE = tm.gauge(
    "chain_mesh_waste_fraction",
    "running padded-slot fraction of all dispatched slots per bucket "
    "(0 = every slot carried a real frame)",
    ("bucket",),
)
RECOMPILES = tm.counter(
    "chain_mesh_recompiles_total",
    "first dispatches of device steps per geometry bucket: no XLA compile "
    "exists on the card, so this counts each (mesh, geometry) step's first "
    "dispatch, which builds its kernels on their first use (the step is "
    "cached per geometry; revisiting a bucket adds none)",
    ("bucket",),
)
COMPILE_SECONDS = tm.counter(
    "chain_mesh_compile_seconds_total",
    "seconds of those first dispatches per bucket (kernel builds on first "
    "use + the first step's compute)",
    ("bucket",),
)

#: occupancy kinds of one dispatched frame-slot, in render order
SLOT_KINDS = ("valid", "pad_tail", "pad_exhausted", "pad_mesh")

_SAFE_NAME = re.compile(r"[^A-Za-z0-9._-]+")


def _journal_name(replica: str) -> str:
    return _SAFE_NAME.sub("_", replica) + ".jsonl"


def _new_agg() -> dict:
    return {"waves": 0, "valid": 0, "pad_tail": 0, "pad_exhausted": 0,
            "pad_mesh": 0, "dispatched": 0, "step_s": 0.0,
            "recompiles": 0, "compile_s": 0.0}


class MeshRecorder:
    """The process-wide wave/step recorder. The in-memory per-bucket
    aggregate always updates; journal lines are written only while a
    journal is attached. Thread-safe; appends never raise."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._replica = "host0"
        self._path: Optional[str] = None
        self._f = None
        self._seq = 0
        self._buckets: dict = {}

    # -------------------------------------------------------- journal

    def attach_journal(self, journal_dir: str, replica: str = "host0") -> None:
        """Point the recorder at a journal directory. Idempotent per (dir,
        replica); attaching elsewhere closes the previous journal stream."""
        with self._lock:
            path = os.path.join(os.path.abspath(journal_dir), _journal_name(replica))
            if path == self._path:
                return
            f, self._f = self._f, None
            self._dir = os.path.abspath(journal_dir)
            self._replica = replica
            self._path = path
        _close_quietly(f)

    def detach_journal(self) -> None:
        with self._lock:
            f, self._f = self._f, None
            self._dir = self._path = None
        _close_quietly(f)

    def _seal_torn_tail(self) -> None:
        """A predecessor killed mid-write leaves a torn final line;
        terminate it before O_APPEND glues our first record onto it."""
        try:
            with open(self._path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
        except FileNotFoundError:
            return
        except OSError:
            pass  # the append itself will surface a real disk fault

    def _append_locked(self, record: dict) -> None:
        """One journal record; never raises; a no-op while no journal is
        attached. Caller holds _lock."""
        if self._path is None:
            return
        record.setdefault("ts", round(time.time(), 6))
        record["replica"] = self._replica
        record["pid"] = os.getpid()
        self._seq += 1
        record["seq"] = self._seq
        try:
            if self._f is None:
                os.makedirs(self._dir, exist_ok=True)
                self._seal_torn_tail()
                self._f = open(self._path, "a")
            self._f.write(json.dumps(record, sort_keys=True) + "\n")
            self._f.flush()
        except (OSError, ValueError):
            get_logger().warning(
                "meshobs: could not append %s record", record.get("kind"),
                exc_info=True)
            _close_quietly(self._f)
            self._f = None

    # --------------------------------------------------------- writes

    def record_wave(self, bucket: str, *, wave: int, block: int,
                    lanes: list, n_pvs: int, t_step: int, valid: int,
                    pad_tail: int, pad_exhausted: int, pad_mesh: int,
                    step_s: float, first: bool = False, mesh: str = "") -> None:
        """One dispatched wave step with its full slot breakdown. `lanes`
        is the lane names in wave order; `first` flags the first dispatch
        of the bucket's step; `mesh` is the step's "{pvs}x{time}" grid."""
        dispatched = n_pvs * t_step
        record = {
            "kind": "wave", "bucket": bucket, "wave": wave,
            "block": block, "lanes": list(lanes), "n_pvs": n_pvs,
            "t_step": t_step, "valid": valid, "pad_tail": pad_tail,
            "pad_exhausted": pad_exhausted, "pad_mesh": pad_mesh,
            "dispatched": dispatched, "step_s": round(step_s, 6),
        }
        if mesh:
            record["mesh"] = mesh
        if first:
            record["first"] = True
        WAVES.labels(bucket=bucket).inc()
        for kind in SLOT_KINDS:
            SLOTS.labels(bucket=bucket, kind=kind).inc(record[kind])
        WAVE_SECONDS.labels(bucket=bucket).observe(step_s)
        with self._lock:
            agg = self._buckets.setdefault(bucket, _new_agg())
            agg["waves"] += 1
            for kind in SLOT_KINDS:
                agg[kind] += record[kind]
            agg["dispatched"] += dispatched
            agg["step_s"] += step_s
            waste = waste_fraction(agg)
            self._append_locked(record)
        WASTE.labels(bucket=bucket).set(waste)
        tm.emit("mesh_wave", bucket=bucket, wave=wave, block=block,
                lanes=len(lanes), valid=valid, pad_tail=pad_tail,
                pad_exhausted=pad_exhausted, pad_mesh=pad_mesh,
                step_s=round(step_s, 6))

    def record_compile(self, bucket: str, *, step: str, geometry: dict,
                       seconds: float) -> None:
        """The first dispatch of a new step, with its geometry."""
        RECOMPILES.labels(bucket=bucket).inc()
        COMPILE_SECONDS.labels(bucket=bucket).inc(seconds)
        record = {
            "kind": "compile", "bucket": bucket, "step": step,
            "geometry": dict(geometry), "seconds": round(seconds, 6),
        }
        with self._lock:
            agg = self._buckets.setdefault(bucket, _new_agg())
            agg["recompiles"] += 1
            agg["compile_s"] += seconds
            self._append_locked(record)
        tm.emit("mesh_compile", bucket=bucket, step=step,
                seconds=round(seconds, 6), **{
                    k: v for k, v in geometry.items()
                    if isinstance(v, (str, int, float, bool))
                })

    # --------------------------------------------------------- reads

    def summary(self) -> Optional[dict]:
        """Per-bucket occupancy/waste/recompile aggregates since process
        start; None until the first wave dispatches."""
        with self._lock:
            if not self._buckets:
                return None
            buckets = {
                b: {**agg, "step_s": round(agg["step_s"], 4),
                    "compile_s": round(agg["compile_s"], 4),
                    "waste_fraction": waste_fraction(agg)}
                for b, agg in self._buckets.items()
            }
            journal = self._path
        return {
            "buckets": buckets,
            "waves": sum(a["waves"] for a in buckets.values()),
            "recompiles": sum(a["recompiles"] for a in buckets.values()),
            "journal": journal,
        }

    def close(self) -> None:
        self.detach_journal()


def _close_quietly(f) -> None:
    if f is not None:
        try:
            f.close()
        except OSError:
            pass


#: the process-wide recorder the wave loop writes to
RECORDER = MeshRecorder()


def attach_journal(journal_dir: str, replica: str = "host0") -> None:
    RECORDER.attach_journal(journal_dir, replica)


def detach_journal() -> None:
    RECORDER.detach_journal()


def waste_fraction(agg: dict) -> float:
    """Padded-slot fraction of one aggregate entry (0.0 when nothing
    dispatched)."""
    dispatched = agg.get("dispatched", 0)
    if not dispatched:
        return 0.0
    pads = (agg.get("pad_tail", 0) + agg.get("pad_exhausted", 0)
            + agg.get("pad_mesh", 0))
    return round(pads / dispatched, 4)


# ---------------------------------------------------------------- readers


def read_journal(path: str) -> list[dict]:
    """One journal file; every complete record stands, a torn line is
    skipped."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue
                if isinstance(record, dict):
                    out.append(record)
    except OSError:
        return []
    return out


def read_journals(root: str) -> list[dict]:
    """Every replica's wave journal under `root`, merged and ordered by
    (ts, replica, seq)."""
    records: list[dict] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    for name in names:
        if name.endswith(".jsonl"):
            records.extend(read_journal(os.path.join(root, name)))
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("replica", ""),
                                r.get("seq", 0)))
    return records


def aggregate(root: str) -> dict:
    """Full-history journal rollup: per-bucket occupancy, waste,
    recompiles and the per-wave lane schedule, plus the count of records
    that break valid + pads == dispatched (a wave-loop accounting bug,
    reported, never dropped)."""
    buckets: dict = {}
    schedule: dict = {}
    violations = 0
    for record in read_journals(root):
        kind = record.get("kind")
        bucket = record.get("bucket") or "?"
        agg = buckets.setdefault(bucket, _new_agg())
        if kind == "wave":
            agg["waves"] += 1
            for slot_kind in SLOT_KINDS:
                agg[slot_kind] += int(record.get(slot_kind) or 0)
            agg["dispatched"] += int(record.get("dispatched") or 0)
            agg["step_s"] += float(record.get("step_s") or 0.0)
            total = sum(int(record.get(k) or 0) for k in SLOT_KINDS)
            if total != int(record.get("dispatched") or 0):
                violations += 1
            if record.get("block") == 0:
                schedule.setdefault(bucket, []).append({
                    "wave": record.get("wave"),
                    "lanes": record.get("lanes", []),
                })
        elif kind == "compile":
            agg["recompiles"] += 1
            agg["compile_s"] += float(record.get("seconds") or 0.0)
    for agg in buckets.values():
        agg["waste_fraction"] = waste_fraction(agg)
        agg["step_s"] = round(agg["step_s"], 4)
        agg["compile_s"] = round(agg["compile_s"], 4)
    totals = _new_agg()
    for agg in buckets.values():
        for key in totals:
            totals[key] += agg[key]
    totals["waste_fraction"] = waste_fraction(totals)
    totals["step_s"] = round(totals["step_s"], 4)
    totals["compile_s"] = round(totals["compile_s"], 4)
    return {"buckets": buckets, "totals": totals, "schedule": schedule,
            "invariant_violations": violations}


def journal_stats(root: str, tail_bytes: int = 1 << 19) -> dict:
    """Cheap summary for frequent readers: total size from stat, counts
    parsed from each journal's TAIL; `sampled: true` flags a journal larger
    than the tail window (the counts then cover the recent window)."""
    stats = {"files": 0, "bytes": 0, "waves": 0, "compiles": 0,
             "valid": 0, "padded": 0, "sampled": False}
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return stats
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        path = os.path.join(root, name)
        try:
            size = os.stat(path).st_size
            with open(path) as f:
                if size > tail_bytes:
                    stats["sampled"] = True
                    f.seek(size - tail_bytes)
                    f.readline()  # discard the mid-record partial
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        record = json.loads(line)
                    except ValueError:
                        continue  # torn tail (or mid-window garbage)
                    if record.get("kind") == "wave":
                        stats["waves"] += 1
                        stats["valid"] += int(record.get("valid") or 0)
                        stats["padded"] += sum(int(record.get(k) or 0)
                                               for k in SLOT_KINDS if k != "valid")
                    elif record.get("kind") == "compile":
                        stats["compiles"] += 1
        except OSError:
            continue
        stats["files"] += 1
        stats["bytes"] += size
    return stats


def mesh_dir(root: str) -> str:
    """The journal directory convention of one serve root."""
    return os.path.join(os.path.abspath(root), "meshobs")


# the /status "mesh" section: registered at import so every surface that
# imports the wave loop (runs, serve, tools) exposes it
def _status_section(query) -> Optional[dict]:
    return RECORDER.summary()


_live.STATUS_PROVIDERS.setdefault("mesh", _status_section)
