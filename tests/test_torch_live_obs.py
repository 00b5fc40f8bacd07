"""The port's live observability against the JAX package's, on the CPU:
the stall watchdog and `active_stalls` (tests/test_live_obs.py's cases,
each driven through both packages on the same injected clock, with equal
incidents), /status's `run`, `counters` and `resources` sections, the
status-file writer, the chain-top and mesh-top renders (equal text on the
same documents), and `tools chain-serve --status-file` as a process."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from processing_chain_tpu import telemetry as jtm
from processing_chain_tpu.telemetry import heartbeat as jhb
from processing_chain_tpu.telemetry import watchdog as jwd
from processing_chain_tpu.tools import chain_top as jtop
from processing_chain_tpu.tools import mesh_top as jmtop
from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.parallel import mesh as tmesh
from processing_chain_tpu_torch.parallel import meshobs as tmeshobs
from processing_chain_tpu_torch.parallel import p03_batch as tb
from processing_chain_tpu_torch.telemetry import heartbeat as thb
from processing_chain_tpu_torch.telemetry import live
from processing_chain_tpu_torch.telemetry import watchdog as twd
from processing_chain_tpu_torch.tools import chain_top as ttop
from processing_chain_tpu_torch.tools import mesh_top as tmtop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (tm, thb, twd), "jax": (jtm, jhb, jwd)}


@pytest.fixture(autouse=True)
def clean_telemetry():
    for pkg in (tm, jtm):
        pkg.reset()
        pkg.enable()
    yield
    for pkg in (tm, jtm):
        pkg.disable()
        pkg.reset()


def _clocked(hb_mod):
    clk = [0.0]
    reg = hb_mod.HeartbeatRegistry(clock=lambda: clk[0])
    reg.enabled = True
    return reg, clk


def _both(scenario):
    """Run `scenario(tm, hb_mod, wd_mod, reg, clk)` for each package on its
    own clocked registry; returns {package: result}."""
    out = {}
    for name, (tmod, hb_mod, wd_mod) in PACKAGES.items():
        reg, clk = _clocked(hb_mod)
        out[name] = scenario(tmod, hb_mod, wd_mod, reg, clk)
    return out


def _events(tmod, kind):
    return [r for r in tmod.EVENTS.records() if r["event"] == kind]


def test_watchdog_soft_flags_stall_with_stack_dump():
    def scenario(tmod, hb_mod, wd_mod, reg, clk):
        hb = reg.register("stuck", kind="task")
        dog = wd_mod.Watchdog(soft_s=300, registry=reg)
        clk[0] = 200.0
        steps = [dog.scan()]
        clk[0] = 400.0
        steps.append(dog.scan())
        steps.append(dog.scan())
        stalls = [wd_mod.active_stalls(reg)]
        (ev,) = _events(tmod, "task_stalled")
        assert "thread" in ev["stacks"] and "test_torch_live_obs" in ev["stacks"]
        hb.beat()
        stalls.append(wd_mod.active_stalls(reg))
        recovered = len(_events(tmod, "task_recovered"))
        clk[0] = 800.0
        steps.append(dog.scan())
        return steps, stalls, recovered, {k: ev[k] for k in ev if k not in ("t", "stacks")}

    res = _both(scenario)
    assert res["port"] == res["jax"]
    steps, stalls, recovered, _ = res["port"]
    assert steps[0] == [] and steps[1][0]["incident"] == "stalled" and steps[2] == []
    assert stalls[0][0]["task"] == "stuck" and stalls[1] == [] and recovered == 1
    assert steps[3][0]["incident"] == "stalled"


@pytest.mark.parametrize("kind", ["prefetch", "job"])
def test_watchdog_hard_timeout(kind):
    """A cancellable kind leaves the live set as "timeout"; an execution
    wrapper stays live (with forensics and `cancelled`) and keeps its real
    outcome."""
    def scenario(tmod, hb_mod, wd_mod, reg, clk):
        hb = reg.register("wedged", kind=kind)
        dog = wd_mod.Watchdog(soft_s=10, hard_s=100, registry=reg)
        clk[0] = 150.0
        first = dog.scan()
        stalls = wd_mod.active_stalls(reg)
        (ev,) = _events(tmod, "task_hard_timeout")
        assert "stacks" in ev and hb.cancelled
        live_labels = [h.label for h in reg.live()]
        again = dog.scan()
        with pytest.raises(hb_mod.TaskCancelled):
            hb.check_cancelled()
        hb.finish("ok")
        return first, stalls, live_labels, again, reg.snapshot()["recent"][0]["status"]

    res = _both(scenario)
    assert res["port"] == res["jax"]
    first, stalls, live_labels, again, status = res["port"]
    assert first[0]["incident"] == "hard_timeout" and again == []
    if kind == "prefetch":
        assert live_labels == [] and stalls == [] and status == "timeout"
    else:
        assert live_labels == ["wedged"] and status == "ok"
        assert stalls[0]["incident"] == "hard_timeout"


def test_watchdog_ignores_stage_heartbeats_and_orders_stalls():
    def scenario(tmod, hb_mod, wd_mod, reg, clk):
        reg.stage_begin("p01")
        reg.register("older", kind="task")
        clk[0] = 50.0
        reg.register("younger", kind="device_step")
        clk[0] = 1e6
        incidents = wd_mod.Watchdog(soft_s=1, registry=reg).scan()
        return sorted(i["task"] for i in incidents), wd_mod.active_stalls(reg)

    res = _both(scenario)
    assert res["port"] == res["jax"]
    tasks, stalls = res["port"]
    assert tasks == ["older", "younger"]
    assert [s["task"] for s in stalls] == ["older", "younger"]


def test_watchdog_thread_flags_a_held_heartbeat_and_clears_on_beat():
    """The watchdog thread over the process registry: a heartbeat held
    still past a 0.5 s soft limit shows in active_stalls within 2 s and
    leaves it when it beats."""
    hb = tm.HEARTBEATS.register("held", kind="task")
    dog = twd.Watchdog(soft_s=0.5, poll_s=0.1).start()
    try:
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not twd.active_stalls():
            time.sleep(0.05)
        assert [s["task"] for s in twd.active_stalls()] == ["held"]
        hb.beat()
        assert twd.active_stalls() == []
    finally:
        dog.stop()
        hb.finish("ok")
    assert dog._thread is None


# ------------------------------------------------------------ /status


def test_build_status_carries_run_counters_and_resources():
    live.set_run_meta(name="smoke", argv=["-x"])
    try:
        tm.FRAMES_DECODED.inc(5)
        doc = live.build_status()
    finally:
        live.set_run_meta()
    assert doc["run"] == {"name": "smoke", "argv": ["-x"]}
    assert doc["counters"] == {"frames_decoded": 5.0, "frames_encoded": 0.0,
                               "bytes_encoded": 0.0}
    res = doc["resources"]
    assert {"rss_bytes", "open_fds", "pool_free_bytes", "queues"} <= set(res)
    assert "device_memory" not in res  # CUDA never initialised here
    assert live.build_status()["run"] == {}
    json.dumps(doc)


def test_status_file_writer_updates_and_final_snapshot(tmp_path):
    path = str(tmp_path / "status.json")
    writer = live.StatusFileWriter(path, interval_s=0.25).start()
    assert os.path.isfile(path)
    hb = tm.HEARTBEATS.register("late-task", kind="task")
    writer.stop()
    doc = json.loads(open(path).read())
    assert [t["label"] for t in doc["tasks"]] == ["late-task"]
    assert {"run", "counters", "resources"} <= set(doc)
    hb.finish("ok")
    assert os.listdir(tmp_path) == ["status.json"]


def test_write_status_file_leaves_no_temp_when_dump_fails(tmp_path):
    path = str(tmp_path / "status.json")
    live.write_status_file(path)
    live.RUN_META["poison"] = object()
    try:
        with pytest.raises(TypeError):
            live.write_status_file(path)
    finally:
        live.RUN_META.clear()
    assert os.listdir(tmp_path) == ["status.json"]
    assert json.loads(open(path).read())["schema"] == 1


# ---------------------------------------------------------------- renders


def _toy_status():
    return {
        "schema": 1, "pid": 42, "uptime_s": 125.0,
        "run": {"name": "processAll", "argv": ["-c", "db.yaml"]},
        "current_stage": "p03",
        "stages": {
            "p01": {"state": "ok", "jobs_done": 8, "jobs_planned": 8,
                    "progress": 1.0, "wall_s": 60.0},
            "p03": {"state": "running", "jobs_done": 3, "jobs_planned": 12,
                    "progress": 0.25, "eta_s": 540.0, "wall_s": 180.0},
        },
        "tasks": [
            {"label": "avpvs P2SXC01_SRC000_HRC001", "kind": "job",
             "age_s": 42.0, "beat_age_s": 1.0, "units_done": 0},
            {"label": "decode-prefetch", "kind": "prefetch", "age_s": 42.0,
             "beat_age_s": 400.0, "units_done": 120, "stalled": True},
        ],
        "recent": [{"label": "bad-job", "kind": "job", "status": "fail",
                    "age_s": 1.0, "beat_age_s": 1.0}],
        "counters": {"frames_decoded": 4800, "frames_encoded": 2400,
                     "bytes_encoded": 1.5e9},
        "serve": {"replica": "r1", "replica_epoch": 2, "pid": 42,
                  "queue": {"queued": 1}, "requests": {"done": 3}, "stalls": []},
        "resources": {"rss_bytes": 3e8, "cpu_percent": 12.5, "open_fds": 9,
                      "pool_outstanding_bytes": 1e8, "pool_free_bytes": 2e7,
                      "queues": {"decode": 2},
                      "device_memory": {"bytes_in_use": 4e9}},
    }


def test_chain_top_render_equals_jax():
    docs = [_toy_status(), {"pid": 1}, live.build_status()]
    for doc in docs:
        assert ttop.render(doc) == jtop.render(doc)
        assert ttop.render(doc, note="stale") == jtop.render(doc, note="stale")
    out = ttop.render(docs[0])
    assert ">p03" in out and "STALLED" in out and "hbm 4000 MB" in out


def test_chain_top_once_from_file_and_server(tmp_path, capsys):
    path = tmp_path / "status.json"
    path.write_text(json.dumps(_toy_status()))
    assert ttop.main([str(path), "--once"]) == 0
    assert "chain-top" in capsys.readouterr().out
    with live.LiveServer(0) as srv:
        assert ttop.main([srv.url, "--once"]) == 0
    assert "stages" in capsys.readouterr().out
    with pytest.raises(ttop.StatusSourceError):
        ttop.fetch_status(str(tmp_path / "absent.json"))


def test_mesh_top_render_equals_jax(tmp_path):
    """A journal the port's wave loop wrote, read through both packages'
    mesh-top: the same view, the same frame; and the live /status "mesh"
    section the port serves."""
    journal = str(tmp_path / "meshobs")
    tmeshobs.attach_journal(journal, replica="r0")
    rng = np.random.default_rng(2)
    lanes = []
    for i, n in enumerate([9, 5, 3]):
        yuv = [rng.integers(0, 256, s).astype(np.uint8)
               for s in ((n, 36, 64), (n, 18, 32), (n, 18, 32))]
        lanes.append(tb.Lane(chunks=iter([yuv]), emit=lambda p: None, n_frames_hint=n,
                             name=f"lane{i}"))
    try:
        tb.run_bucket(lanes, tmesh.make_mesh(["cpu"] * 2), 72, 128, chunk=4, bucket="b")
    finally:
        tmeshobs.detach_journal()
    view = tmtop.load_mesh(str(tmp_path))  # a serve root: its meshobs/ journal
    assert view == jmtop.load_mesh(str(tmp_path))
    assert tmtop.render(view) == jmtop.render(view)
    assert view["buckets"]["b"]["valid"] == 17
    with live.LiveServer(0) as srv:
        live_view = tmtop.load_mesh(srv.url)
    assert live_view["buckets"]["b"]["waves"] >= view["buckets"]["b"]["waves"]
    assert tmtop.render(live_view) == jmtop.render(live_view)
    with pytest.raises(ttop.StatusSourceError):
        tmtop.load_mesh(str(tmp_path / "nothing"))


# ------------------------------------------------------- chain-serve CLI


def test_chain_serve_status_file(tmp_path):
    """`tools chain-serve --device cpu --status-file F` rewrites F with the
    serve section (its stalls list included) and the daemon's run meta,
    and writes it once more on SIGTERM."""
    root = str(tmp_path / "serve")
    status_path = str(tmp_path / "status.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "processing_chain_tpu_torch", "tools", "chain-serve",
         "--root", root, "--port", "0", "--executor", "wave", "--device", "cpu",
         "--workers", "1", "--status-file", status_path],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 90.0
        doc = None
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read().decode()
            try:
                with open(status_path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                doc = None
            if doc and "serve" in doc:
                break
            time.sleep(0.1)
        assert doc is not None and doc["serve"]["stalls"] == []
        assert doc["pid"] == proc.pid and {"counters", "resources"} <= set(doc)
        assert doc["run"] == {"name": "chain-serve", "argv": [
            "--root", root, "--port", "0", "--executor", "wave", "--device", "cpu",
            "--workers", "1", "--status-file", status_path]}
        with open(os.path.join(root, "serve-info.json")) as f:
            url = json.load(f)["url"]
        with urllib.request.urlopen(url + "/status", timeout=10) as resp:
            assert json.load(resp)["serve"]["stalls"] == []
        first = doc["generated_at"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0
    with open(status_path) as f:
        assert json.load(f)["generated_at"] > first
