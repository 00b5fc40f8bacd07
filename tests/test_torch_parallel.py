"""The port's parallel layer against tests/test_parallel.py, case by case:
the (pvs, time) slot mesh, `make_sharded_step` with its TI halo,
`run_bucket` over a time-split mesh, the sharded stall renderer, the
batch metrics step, the multi-process helpers and a two-process gloo run.

Meshes here are CPU slots: `["cpu"] * 8` with time_parallel=2 is the
counterpart of the JAX suite's 8 virtual devices, and a mesh that mixes
`cpu` and `cpu:0` (two distinct torch devices on one host) takes the
distinct-device route: rows copied between devices, the halo crossing
them. Tolerances are the flagship-step parity test's
(tests/test_torch_pipeline.py): u8 planes identical, u16 within one code
value; SI/TI within atol 1e-3 (1e-2 for u16), rtol 1e-4."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from processing_chain_tpu.models import avpvs as jav
from processing_chain_tpu.ops import overlay as jov
from processing_chain_tpu.parallel import batch_sharding as jbatch_sharding
from processing_chain_tpu.parallel import make_mesh as jmake_mesh
from processing_chain_tpu.parallel import make_sharded_step as jmake_sharded_step
from processing_chain_tpu.parallel import meshobs as jmeshobs
from processing_chain_tpu.parallel import p03_batch as jb
from processing_chain_tpu_torch import telemetry as ttm
from processing_chain_tpu_torch.models import avpvs as tav
from processing_chain_tpu_torch.ops import cuda_kernels as tk
from processing_chain_tpu_torch.ops import overlay as tov
from processing_chain_tpu_torch.parallel import distributed as tdist
from processing_chain_tpu_torch.parallel import mesh as tmesh
from processing_chain_tpu_torch.parallel import meshobs as tmeshobs
from processing_chain_tpu_torch.parallel import p03_batch as tb
from processing_chain_tpu_torch.parallel import pipeline as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SH, SW, DH, DW = 36, 64, 72, 128
MESHES = {  # label -> (slots, time_parallel)
    "8slots": (["cpu"] * 8, 2),
    "distinct": (["cpu", "cpu:0"] * 4, 2),
}


@pytest.fixture(autouse=True)
def detached_journals():
    yield
    jmeshobs.detach_journal()
    tmeshobs.detach_journal()


def _batch(b=4, t=8, seed=0, dtype=np.uint8, hi=255):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hi + 1, s).astype(dtype)
            for s in ((b, t, SH, SW), (b, t, SH // 2, SW // 2), (b, t, SH // 2, SW // 2))]


# ---------------------------------------------------------------- the mesh


def test_mesh_shapes(devices8):
    mesh = tmesh.make_mesh(["cpu"] * 8, time_parallel=2)
    assert mesh.shape == {"pvs": 4, "time": 2} == dict(jmake_mesh(devices8, time_parallel=2).shape)
    assert mesh.local_box() == (0, 4, 0, 2) and mesh.rank == 0 and mesh.group is None
    with pytest.raises(ValueError):
        tmesh.make_mesh(["cpu"] * 8, time_parallel=3)
    with pytest.raises(ValueError):
        jmake_mesh(devices8, time_parallel=3)
    with pytest.raises(ValueError):
        tmesh.make_mesh(["cpu"], time_parallel=0)


def test_block_layout_views_and_copies():
    """One device holding whole lanes takes its rows as a view; rows of a
    time-split distinct-device mesh are copied, and join puts them back."""
    x = torch.arange(4 * 8 * 2).reshape(4, 8, 2)
    one = tmesh.BlockLayout(tmesh.make_mesh(["cpu"] * 4, time_parallel=2), 4, 8)
    parts = one.split(x)
    assert list(parts) == [torch.device("cpu")] and parts[torch.device("cpu")].shape == (8, 4, 2)
    assert parts[torch.device("cpu")].data_ptr() == x.data_ptr()
    assert one.join(parts).data_ptr() == x.data_ptr()
    lay = tmesh.BlockLayout(tmesh.make_mesh(["cpu", "cpu:0"] * 2, time_parallel=2), 4, 8)
    parts = lay.split(x)
    assert lay.rows[torch.device("cpu")] == [(b, 0) for b in range(4)]
    assert torch.equal(parts[torch.device("cpu:0")][1], x[1, 4:])
    assert torch.equal(lay.join(parts), x)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.BlockLayout(tmesh.make_mesh(["cpu"] * 4, time_parallel=2), 3, 8)


# ---------------------------------------------------------------- the sharded step


@pytest.mark.parametrize("label", list(MESHES))
@pytest.mark.parametrize("dtype,hi,atol", [(np.uint8, 255, 1e-3), (np.uint16, 1023, 1e-2)])
def test_sharded_step_matches_jax_and_single_device(devices8, label, dtype, hi, atol):
    """Mirrors test_sharded_step_matches_single_device: the port's step on
    a (4, 2) mesh against the JAX step on devices8 (time_parallel=2) and
    against the port's `avpvs_siti_step` lane by lane, TI across the time
    boundary at t=4 included."""
    y, u, v = _batch(dtype=dtype, hi=hi)
    slots, tpar = MESHES[label]
    tk.reset_launches()
    ours = tp.make_sharded_step(tmesh.make_mesh(slots, time_parallel=tpar), DH, DW)(
        *(torch.from_numpy(p) for p in (y, u, v)))
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}
    jmesh = jmake_mesh(devices8, time_parallel=2)
    sharding = jbatch_sharding(jmesh)
    ref = jmake_sharded_step(jmesh, DH, DW)(*(jax.device_put(p, sharding) for p in (y, u, v)))
    assert tuple(ours[0].shape) == (4, 8, DH, DW) and tuple(ours[3].shape) == (4, 8)
    for a, b in zip(ours[:3], ref[:3]):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype
        assert np.abs(a.astype(int) - b.astype(int)).max() <= (0 if dtype == np.uint8 else 1)
    if dtype == np.uint8:
        np.testing.assert_allclose(ours[3].numpy(), np.asarray(ref[3]), rtol=1e-4, atol=atol)
        np.testing.assert_allclose(ours[4].numpy(), np.asarray(ref[4]), rtol=1e-4, atol=atol)
    for b in range(4):
        single = tp.avpvs_siti_step(*(torch.from_numpy(p[b]) for p in (y, u, v)), DH, DW)
        for a, s in zip(ours[:3], single[:3]):
            assert torch.equal(a[b], s)
        np.testing.assert_allclose(ours[3][b].numpy(), single[3].numpy(), rtol=1e-4, atol=atol)
        np.testing.assert_allclose(ours[4][b].numpy(), single[4].numpy(), rtol=1e-4, atol=atol)
        assert float(ours[4][b, 0]) == 0.0 and float(ours[4][b, 4]) > 0.0


def test_sharded_step_is_instrumented():
    """With telemetry on, the step lands in chain_device_step_seconds and
    its first call in the event log and the step ledger."""
    y, u, v = (torch.from_numpy(p) for p in _batch(b=2, t=4, seed=3))
    step = tp.make_sharded_step(tmesh.make_mesh(["cpu"] * 4, time_parallel=2), DH, DW)
    ttm.reset()
    ttm.enable()
    try:
        step(y, u, v)
        step(y, u, v)
        events = [e for e in ttm.EVENTS.records() if e.get("event") == "device_step"]
        assert [e["step"] for e in events] == ["sharded_avpvs_step"]
        series = ttm.REGISTRY.snapshot()["chain_device_step_seconds"]
        assert series
    finally:
        ttm.disable()
        ttm.reset()


# ---------------------------------------------------------------- the wave render


def _run(pkg, srcs, mesh, ten_bit, journal):
    outs = {i: [] for i in range(len(srcs))}
    feats = {i: [] for i in range(len(srcs))}
    lanes = []
    for i, yuv in enumerate(srcs):
        n = yuv[0].shape[0]
        parts = [[p[:3] for p in yuv], [p[3:] for p in yuv]] if n > 3 else [yuv]
        lanes.append(pkg.Lane(chunks=iter(parts), emit=outs[i].append, n_frames_hint=n,
                              emit_features=lambda s, t, i=i: feats[i].append((s, t)),
                              name=f"lane{i:02d}"))
    obs = jmeshobs if pkg is jb else tmeshobs
    obs.attach_journal(str(journal), replica="r0")
    pkg.run_bucket(lanes, mesh, DH, DW, "bicubic", (2, 2), ten_bit, chunk=4,
                   bucket=pkg.bucket_label(DH, DW, ten_bit, SH, SW))
    obs.detach_journal()
    res = []
    for i in range(len(srcs)):
        planes = [np.concatenate([np.asarray(b[p]) for b in outs[i]]) for p in range(3)]
        si = np.concatenate([np.asarray(s) for s, _ in feats[i]])
        ti = np.concatenate([np.asarray(t) for _, t in feats[i]])
        res.append((planes, si, ti))
    return res, obs.aggregate(str(journal))


def _sources(lengths, ten_bit, seed):
    rng = np.random.default_rng(seed)
    dtype, hi = (np.uint16, 1023) if ten_bit else (np.uint8, 255)
    return [[rng.integers(0, hi + 1, s).astype(dtype)
             for s in ((n, SH, SW), (n, SH // 2, SW // 2), (n, SH // 2, SW // 2))]
            for n in lengths]


@pytest.mark.parametrize("label", list(MESHES))
@pytest.mark.parametrize("ten_bit,lengths", [
    (False, [11, 4, 2, 7, 5]),                 # test_p03_batch_padding_and_exhaustion
    (True, [3 + (i % 5) for i in range(16)]),  # test_p03_batch_ten_bit_and_many_wave_lanes
])
def test_run_bucket_time_split_matches_jax(devices8, tmp_path, label, ten_bit, lengths):
    """The port's run_bucket on a (4, 2) mesh against the JAX one on
    devices8 with time_parallel=2 (t_step 4, a 2-frame halo boundary in
    every block): planes, features, journal slot totals and the mesh
    label of every wave record."""
    srcs = _sources(lengths, ten_bit, 7 + len(lengths))
    slots, tpar = MESHES[label]
    mesh = tmesh.make_mesh(slots, time_parallel=tpar)
    assert tb.wave_count(len(lengths), mesh) == -(-len(lengths) // 4)
    tk.reset_launches()
    ours, tagg = _run(tb, srcs, mesh, ten_bit, tmp_path / "port")
    assert tk.LAUNCHES == {name: 0 for name in tk.LAUNCHES}
    ref, jagg = _run(jb, srcs, jmake_mesh(devices8, time_parallel=2), ten_bit, tmp_path / "jax")
    atol = 1e-2 if ten_bit else 1e-3
    for n, (planes, si, ti), (rplanes, rsi, rti) in zip(lengths, ours, ref):
        for a, b in zip(planes, rplanes):
            assert a.shape == b.shape and a.shape[0] == n and a.dtype == b.dtype
            assert np.abs(a.astype(int) - b.astype(int)).max() <= (1 if ten_bit else 0)
        assert si.shape == ti.shape == (n,) and ti[0] == 0.0
        if not ten_bit:
            np.testing.assert_allclose(si, rsi, rtol=1e-4, atol=atol)
            np.testing.assert_allclose(ti, rti, rtol=1e-4, atol=atol)
        # the features are those of the lane's own planes, in order
        si_ref, ti_ref = tk.siti_frames_plain(torch.from_numpy(planes[0]))
        np.testing.assert_allclose(si, si_ref.numpy(), rtol=1e-4, atol=atol)
        np.testing.assert_allclose(ti, ti_ref.numpy(), rtol=1e-4, atol=atol)
    assert tagg["invariant_violations"] == jagg["invariant_violations"] == 0
    for key in ("waves", "valid", "pad_tail", "pad_exhausted", "pad_mesh", "dispatched"):
        assert tagg["totals"][key] == jagg["totals"][key], key
    records = [r for r in tmeshobs.read_journals(str(tmp_path / "port")) if r["kind"] == "wave"]
    assert records and {r["mesh"] for r in records} == {"4x2"}


def test_run_bucket_refuses_a_mesh_across_ranks():
    mesh = tmesh.Mesh(((tmesh.Slot(0, torch.device("cpu")),),), 0, group=object())
    with pytest.raises(ValueError, match="one process"):
        tb.run_bucket([], mesh, DH, DW, chunk=4)


def test_journal_stats_counts_waves_and_samples_the_tail(tmp_path):
    srcs = _sources([5, 3], False, 2)
    _run(tb, srcs, tmesh.make_mesh(["cpu"] * 2, time_parallel=2), False, tmp_path)
    stats = tmeshobs.journal_stats(str(tmp_path))
    agg = tmeshobs.aggregate(str(tmp_path))["totals"]
    assert stats["files"] == 1 and stats["waves"] == agg["waves"] == 3  # 2 + 1 blocks
    assert stats["valid"] == 8 and stats["padded"] == agg["dispatched"] - 8
    assert stats["sampled"] is False
    tail = tmeshobs.journal_stats(str(tmp_path), tail_bytes=64)
    assert tail["sampled"] is True and tail["waves"] < stats["waves"]
    assert tmeshobs.journal_stats(str(tmp_path / "missing"))["files"] == 0


# ---------------------------------------------------------------- stall renderer


@pytest.fixture
def one_jax_device(monkeypatch):
    devs = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devs[:1])


def _stall_chunk(pix_fmt, skipping, t=13):
    rng = np.random.default_rng(11 + skipping)
    hi, dtype = (1023, np.uint16) if "10" in pix_fmt else (255, np.uint8)
    planes = [rng.integers(0, hi + 1, s).astype(dtype)
              for s in ((t, 144, 192), (t, 72, 96), (t, 72, 96))]
    events = [[0.1, 0.5]] if skipping else [[0.2, 0.6]]
    plan = jov.plan_stalling(t, 10.0, events, skipping=skipping)
    return [p[plan.src_idx] for p in planes], (plan.stall_mask, plan.black_mask, plan.phase)


@pytest.mark.parametrize("label", list(MESHES))
@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le"])
@pytest.mark.parametrize("skipping", [False, True])
def test_sharded_stall_compositor_matches_jax(monkeypatch, label, pix_fmt, skipping):
    """The port's compositor over a mesh (frames padded to the slot count,
    rendered frame-parallel) is identical to the JAX single-device route,
    and within one code value of the JAX sharded route (its fused
    multiply-add; ROADMAP Queue C)."""
    gathered, masks = _stall_chunk(pix_fmt, skipping)
    slots, tpar = MESHES[label]
    comp = tav.make_stall_compositor(pix_fmt, tav.DEFAULT_SPINNER, skipping, 64,
                                     mesh=tmesh.make_mesh(slots, time_parallel=tpar))
    ours = [o.numpy() for o in comp([torch.from_numpy(g) for g in gathered], *masks)]
    sharded = [np.asarray(o) for o in jav.make_stall_compositor(
        pix_fmt, tav.DEFAULT_SPINNER, skipping, 64)(gathered, *masks)]
    devs = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devs[:1])
    single = [np.asarray(o) for o in jav.make_stall_compositor(
        pix_fmt, tav.DEFAULT_SPINNER, skipping, 64)(gathered, *masks)]
    for a, s, j in zip(ours, single, sharded):
        assert a.shape == s.shape and a.dtype == s.dtype
        np.testing.assert_array_equal(a, s)
        assert np.abs(a.astype(int) - j.astype(int)).max() <= 1


def test_sharded_stall_renderer_skipping_mode(devices8):
    """Mirrors test_sharded_stall_renderer_skipping_mode: no spinner banks,
    the renderer matches render_core per plane."""
    rng = np.random.default_rng(3)
    t = 16
    y, u, v = (torch.from_numpy(rng.integers(0, 255, s).astype(np.float32))
               for s in ((t, 32, 48), (t, 16, 24), (t, 16, 24)))
    stall = (np.arange(t) % 3 == 0).astype(np.float32)
    black = (np.arange(t) % 5 == 0).astype(np.float32)
    phase = np.zeros((t,), np.int32)
    step = tov.make_sharded_stall_renderer(
        tmesh.make_mesh(["cpu"] * 8), (None,) * 5, (16.0, 128.0, 128.0), ten_bit=False)
    jstep = jov.make_sharded_stall_renderer(
        jmake_mesh(devices8), (None,) * 5, (16.0, 128.0, 128.0), ten_bit=False)
    outs = step(y, u, v, stall, black, phase)
    jouts = jstep(*(jnp.asarray(p.numpy()) for p in (y, u, v)),
                  jnp.asarray(stall), jnp.asarray(black), jnp.asarray(phase))
    for got, jgot, plane, bv in zip(outs, jouts, (y, u, v), (16.0, 128.0, 128.0)):
        ref = tov.render_core(plane, stall, black, phase, None, None, bv)
        ref = torch.clamp(torch.floor(ref + 0.5), 0, 255).to(torch.uint8)
        assert torch.equal(got, ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    with pytest.raises(ValueError, match="pad them"):
        step(y[:15], u[:15], v[:15], stall[:15], black[:15], phase[:15])


# ---------------------------------------------------------------- metrics step


@pytest.mark.parametrize("label", list(MESHES))
def test_sharded_metrics_step(devices8, label):
    """Mirrors test_sharded_metrics_step: the (4, 2) mesh scores every frame
    as one slot does, and as the JAX mesh step does."""
    from processing_chain_tpu.parallel import make_batch_metrics_step as jmetrics

    rng = np.random.default_rng(1)
    ref = rng.integers(0, 255, size=(4, 8, 48, 64), dtype=np.uint8)
    deg = np.clip(ref.astype(int) + rng.integers(-6, 6, ref.shape), 0, 255).astype(np.uint8)
    slots, tpar = MESHES[label]
    psnr, ssim = tp.make_batch_metrics_step(tmesh.make_mesh(slots, time_parallel=tpar))(
        torch.from_numpy(ref), torch.from_numpy(deg))
    one = tp.make_batch_metrics_step(tmesh.make_mesh(["cpu"]))(
        torch.from_numpy(ref), torch.from_numpy(deg))
    assert tuple(psnr.shape) == tuple(ssim.shape) == (4, 8)
    assert torch.equal(psnr, one[0]) and torch.equal(ssim, one[1])
    jmesh = jmake_mesh(devices8, time_parallel=2)
    sharding = jbatch_sharding(jmesh)
    jpsnr, jssim = jmetrics(jmesh)(jax.device_put(ref, sharding), jax.device_put(deg, sharding))
    np.testing.assert_allclose(psnr.numpy(), np.asarray(jpsnr), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ssim.numpy(), np.asarray(jssim), rtol=0, atol=1e-4)
    assert float(psnr.min()) > 25.0 and 0.0 < float(ssim.min()) <= 1.0


# ---------------------------------------------------------------- host helpers


def test_shard_pvs_list():
    ids = [f"P{i:02d}" for i in range(10)]
    shards = [tdist.shard_pvs_list(ids, pid, 3) for pid in range(3)]
    assert sorted(sum(shards, [])) == sorted(ids)
    assert all(len(s) in (3, 4) for s in shards)


def test_process_topology_single_host(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tdist.process_topology() == (0, 1)
    assert tdist.initialize() is False  # no rendezvous address: one process


def test_local_shard_partitions_completely(monkeypatch):
    items = {f"PVS{i:03d}": i for i in range(11)}
    seen = []
    for pid in range(3):
        monkeypatch.setenv("WORLD_SIZE", "3")
        monkeypatch.setenv("RANK", str(pid))
        shard = tdist.local_shard(items)
        assert shard == tdist.local_shard(items)
        seen.extend(k for k, _ in shard)
    assert sorted(seen) == sorted(items)


def test_local_shard_invalid_process_id(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "5")
    with pytest.raises(ValueError, match="out of range"):
        tdist.local_shard({"a": 1})


def test_fs_barrier_waits_for_all_hosts(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("PC_RUN_ID", "t1")
    done = []

    def host0():
        tdist.fs_barrier("p01", str(tmp_path), timeout_s=10, poll_s=0.05)
        done.append(0)

    t = threading.Thread(target=host0)
    t.start()
    time.sleep(0.3)
    assert not done
    assert (tmp_path / ".barrier_t1_p01.host0").read_text()  # written atomically
    assert [p.name for p in tmp_path.iterdir()] == [".barrier_t1_p01.host0"]
    (tmp_path / ".barrier_t1_p01.host1").write_text("now")
    t.join(timeout=5)
    assert not t.is_alive() and done == [0]
    monkeypatch.setenv("PC_RUN_ID", "t2")
    with pytest.raises(TimeoutError, match="barrier p01"):
        tdist.fs_barrier("p01", str(tmp_path), timeout_s=0.3, poll_s=0.05)


def test_fs_barrier_single_host_noop(monkeypatch, tmp_path):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    tdist.fs_barrier("p01", str(tmp_path))
    assert list(tmp_path.iterdir()) == []


def test_fs_barrier_requires_run_id_multihost(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("PC_RUN_ID", raising=False)
    with pytest.raises(ValueError, match="PC_RUN_ID"):
        tdist.fs_barrier("p01", str(tmp_path))
    monkeypatch.setenv("PC_RUN_ID", "bad/id")
    with pytest.raises(ValueError, match="filename-safe"):
        tdist.fs_barrier("p01", str(tmp_path))


def test_fs_barrier_init_clears_own_run_markers(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("PC_RUN_ID", "r9")
    mine = tmp_path / ".barrier_r9_p01.host0"
    other_host = tmp_path / ".barrier_r9_p01.host1"
    other_run = tmp_path / ".barrier_r8_p01.host0"
    for f in (mine, other_host, other_run):
        f.write_text("x")
    tdist.fs_barrier_init(str(tmp_path))
    assert not mine.exists() and other_host.exists() and other_run.exists()


def test_wave_executor_mesh_follows_its_device():
    """A pinned device gives a one-slot mesh on it; an unpinned executor
    spans every visible card (and so refuses to start without CUDA)."""
    from processing_chain_tpu_torch.serve import executors as texec

    ex = texec.DeviceWaveExecutor(device="cpu")
    assert ex._mesh().shape == {"pvs": 1, "time": 1} and ex._mesh().devices == (ex.device,)


def test_mesh_report_sweep_on_cpu_slots(tmp_path):
    """tools mesh-report sweep on `["cpu"] * 8`, time_parallel=2, through
    the port's CLI: every invariant holds."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "processing_chain_tpu_torch", "tools", "mesh-report", "sweep",
         "--device", "cpu", "--out", str(out), "--journal", str(tmp_path / "j")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["ok"] and report["mesh"] == {"pvs": 4, "time": 2}
    assert [p["lanes"] for p in report["scaling"]] == [4, 8, 16]
    assert report["compile_ledger"]["recompiles"] == 3
    assert report["fragmentation"]["ragged"]["waste_fraction"] > 0.0
    assert report["ledger_journal"]["waves"] > 0


# ---------------------------------------------------------------- processes


@pytest.mark.parametrize("n_procs", [
    2,
    pytest.param(4, marks=[pytest.mark.slow, pytest.mark.skipif(
        not os.environ.get("PC_SLOW_TESTS"),
        reason="4-process ring: set PC_SLOW_TESTS=1")]),
])
def test_multiprocess_gloo_end_to_end(n_procs):
    """Mirrors test_multiprocess_distributed_end_to_end: real processes
    join a gloo group (parallel/distributed.initialize), run an all_reduce
    and an all_gather, and run make_sharded_step with the time axis split
    across the ranks, so the TI halo crosses every process boundary; each
    rank's SI/TI equal its lane's single-device reference."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, worker, f"tcp://127.0.0.1:{port}", str(n_procs), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(n_procs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        # a failed rank must not leave its peers blocked in a collective
        for q in procs:
            if q.poll() is None:
                q.kill()
    want_total = sum(range(1, n_procs + 1)) * 4 * 8 * 8.0
    for pid, rec in enumerate(outs):
        assert rec["pid"] == pid and rec["world_size"] == n_procs
        assert rec["backend"] == "gloo"
        assert rec["total"] == want_total
        assert rec["lanes"] == [float(i + 1) for i in range(n_procs)]
        assert rec["mesh"] == {"pvs": 1, "time": n_procs}
        assert rec["sharded_step_ok"] is True
        assert rec["boundary_ti"] > 0.0 or pid == 0
        assert rec["dist_init_events"] == 1
        assert rec["dist_collective_events"] == 3
        assert rec["collective_bytes"] > 0
    assert outs[0]["si_all"] == pytest.approx(outs[1]["si_all"], rel=1e-6)
    assert sorted(sum((o["shard"] for o in outs), [])) == [f"PVS{i:02d}" for i in range(10)]
    assert not set(outs[0]["shard"]) & set(outs[1]["shard"])
