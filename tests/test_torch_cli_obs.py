"""The stage CLIs' observability flags in the port (cli.py:
--telemetry, --profile, --trace, --watchdog-soft/-hard, --live-port,
--status-file; telemetry.EventLog.open_stream and the log-handler bridge,
watchdog.start_watchdog/stop_watchdog, Tracer.log_summary,
PC_PROFILE_DEVICE) against the JAX CLI on the CPU: a `p03` and a `p04` run
of each package over the short databases of tests/test_torch_p03_file.py
and tests/test_torch_p04_file.py write the same artifact files (stamp
aside), and each package's run-report renders the port's directory.
"""

import json
import logging
import os
import re
import subprocess
import sys
import urllib.request

import pytest

from processing_chain_tpu.cli import main as jax_main
from processing_chain_tpu_torch import telemetry as ttm
from processing_chain_tpu_torch.cli import main as port_main
from processing_chain_tpu_torch.telemetry import catalog as tcatalog
from processing_chain_tpu_torch.telemetry import profiling as tprofiling
from processing_chain_tpu_torch.telemetry import watchdog as twatchdog
from tests.test_torch_p03_file import (  # noqa: F401  (fixtures)
    PVSES,
    ROOT,
    _copy,
    _writeback_env,
    main_log,
    short_db,
)
from tests.test_torch_p04_file import _fresh_copy, short_avpvs  # noqa: F401

#: metric names the JAX CLI's run can emit (a series with a value) that
#: the port's p03/p04 run does not, each with the reason
NOT_EMITTED = {
    "chain_device_transfer_bytes_total":
        "counted by the wave loop (parallel/p03_batch), which only the batch "
        "route runs: ROADMAP Queue A item 7",
    "chain_device_transfer_seconds_total":
        "counted by the wave loop (parallel/p03_batch): item 7",
    "chain_io_framesizes_cache_hits_total": "io/framesizes.py is not ported: item 10",
    "chain_media_deadline_expired_total": "io/faults.py is not ported: item 11",
    "chain_media_faults_injected_total": "io/faults.py is not ported: item 11",
    "chain_isolated_decodes_total": "io/isolate.py is not ported: item 11",
    "chain_bufpool_hits_total":
        "a hit needs a block released before the next acquire of its shape; the "
        "port's decode runs two chunks ahead of the writer's release, so a render "
        "of three chunks may take none",
    "chain_bufpool_recycled_bytes_total": "counted with chain_bufpool_hits_total",
    **{name: "sampled by the profile's resource monitor once a second (the CPU "
             "share from two samples, the queue depth while a queue lives): a stage "
             "of a second or two may end before a sample holds a value"
       for name in ("chain_resource_rss_bytes", "chain_resource_open_fds",
                    "chain_resource_cpu_percent", "chain_resource_queue_depth")},
}


@pytest.fixture(autouse=True)
def _telemetry_state():
    """A CLI run with the flags enables telemetry process-wide: put it
    back as it was, with the event log and the "main" logger's handlers."""
    was = ttm.enabled()
    handlers = list(logging.getLogger("main").handlers)
    yield
    logger = logging.getLogger("main")
    for h in list(logger.handlers):
        if h not in handlers:
            logger.removeHandler(h)
    ttm.EVENTS.close_stream()
    if not was:
        ttm.disable()


def _kinds(folder) -> list:
    """The files of a telemetry or profile folder with the stamp taken out."""
    out = []
    for name in os.listdir(folder):
        out.append(re.sub(r"\d{8}-\d{6}-\d+-\d+", "<stamp>", name))
    return sorted(out)


def _names(folder):
    """(names of the metrics with a value, event names) of a telemetry
    folder."""
    (metrics,) = [n for n in os.listdir(folder) if n.startswith("metrics_") and n.endswith(".json")]
    (events,) = [n for n in os.listdir(folder) if n.startswith("events_")]
    with open(os.path.join(folder, metrics)) as f:
        m = {k for k, v in json.load(f).items() if v.get("series")}
    with open(os.path.join(folder, events)) as f:
        e = {json.loads(line)["event"] for line in f if line.strip()}
    return m, e


@pytest.mark.parametrize("stage", ["p03", "p04"])
def test_flags_write_the_jax_artifact_set(short_db, short_avpvs, tmp_path, stage):
    """--telemetry and --profile on both packages' CLIs, each from a reset
    registry: the same artifact files (stamp aside), every port name in
    the port's catalog, the JAX names the port does not emit all in
    NOT_EMITTED, the same event names (run_start, stage_start, run_end
    among them)."""
    from processing_chain_tpu import telemetry as jtm

    src = short_db if stage == "p03" else short_avpvs
    copy = _copy if stage == "p03" else _fresh_copy
    jy, ty = copy(src, tmp_path / "j"), copy(src, tmp_path / "t")
    flags = ["--filter-pvs", PVSES[2]]
    jtm.reset()
    ttm.reset()
    assert jax_main([stage, "-c", jy, "--skip-requirements", "-g", "0", *flags,
                     "--telemetry", str(tmp_path / "jt"), "--profile", str(tmp_path / "jp")]) == 0
    jtm.disable()
    jtm.reset()
    assert port_main([stage, "-c", ty, *flags, "--telemetry", str(tmp_path / "tt"),
                      "--profile", str(tmp_path / "tp")], device="cpu") == 0
    assert _kinds(tmp_path / "tt") == _kinds(tmp_path / "jt") == [
        "events_<stamp>.jsonl", "metrics_<stamp>.json", "metrics_<stamp>.prom",
        "trace_<stamp>.json"]
    assert _kinds(tmp_path / "tp") == _kinds(tmp_path / "jp") == [
        "profile_<stamp>.trace.json", "resources_<stamp>.json"]
    # one stamp joins the telemetry and the profile
    stamps = {re.search(r"\d{8}-\d{6}-\d+-\d+", n).group(0)
              for d in ("tt", "tp") for n in os.listdir(tmp_path / d)}
    assert len(stamps) == 1
    (tm_names, tev), (jm_names, jev) = _names(tmp_path / "tt"), _names(tmp_path / "jt")
    assert tm_names <= set(tcatalog.METRICS) and tev <= set(tcatalog.EVENTS)
    assert jm_names - tm_names <= set(NOT_EMITTED)
    assert {n for n in tm_names - jm_names if not n.startswith("chain_resource_")} == set()
    assert tev == jev
    assert {"run_start", "stage_start", "stage_end", "run_end", "job_end"} <= tev


def test_both_run_reports_render_the_port_directory(short_db, tmp_path, capsys):
    """`tools run-report DIR` of each package renders a telemetry folder the
    port's p03 wrote, and the port's `tools chain-profile` its profile."""
    from processing_chain_tpu.telemetry import report as jreport
    from processing_chain_tpu_torch.telemetry import report as treport
    from processing_chain_tpu_torch.tools import chain_profile as tchain_profile

    ty = _copy(short_db, tmp_path / "t")
    out = tmp_path / "tt"
    assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[0], "--telemetry", str(out),
                      "--profile", str(out)], device="cpu") == 0
    capsys.readouterr()
    assert treport.main([str(out)]) == 0
    ours = capsys.readouterr().out
    assert jreport.main([str(out)]) == 0
    theirs = capsys.readouterr().out
    assert "p03" in ours and ours == theirs
    assert tchain_profile.main([str(out)]) == 0
    assert "p03" in capsys.readouterr().out


def test_trace_writes_the_timing_report_into_the_database_logs(short_db, tmp_path, main_log):
    """--trace DIR: the timing summary is logged, the report lands in the
    database's logs/, the torch.profiler trace in DIR; with --profile
    beside it the profile takes no device capture of its own."""
    ty = _copy(short_db, tmp_path / "t")
    assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[0], "--trace", str(tmp_path / "dev"),
                      "--profile", str(tmp_path / "p")], device="cpu", ) == 0
    logs = os.path.join(os.path.dirname(ty), "logs")
    assert [n for n in os.listdir(logs) if n.startswith("trace_") and n.endswith(".json")]
    assert os.path.isfile(tmp_path / "dev" / "trace.json")
    assert not [n for n in os.listdir(tmp_path / "p") if n.startswith("device_")]
    assert any("timing summary" in r.getMessage() for r in main_log.records)
    assert any("timing report: " in r.getMessage() for r in main_log.records)


def test_profile_device_env_forces_the_capture(monkeypatch, tmp_path):
    """PC_PROFILE_DEVICE=1 takes a device capture where CUDA is not
    initialised; =0 takes none; unset leaves the "CUDA initialised" rule."""
    for value, want in (("1", True), ("0", False), ("", False)):
        monkeypatch.setenv("PC_PROFILE_DEVICE", value)
        assert tprofiling.Profiler(str(tmp_path))._want_device_trace() is want
    monkeypatch.setenv("PC_PROFILE_DEVICE", "0")
    assert tprofiling.Profiler(str(tmp_path), device_trace=True)._want_device_trace()


def test_live_port_and_status_file_serve_the_run(short_db, tmp_path, monkeypatch, main_log):
    """--live-port 0 and --status-file: mid-stage /healthz and /status
    answer with the run's meta, the status file's final snapshot records
    it, and the watchdog runs for the stage and is stopped after."""
    from processing_chain_tpu_torch.stages import p03_generate_avpvs as tstage

    ty = _copy(short_db, tmp_path / "t")
    status_file = tmp_path / "status.json"
    seen = {}
    orig = tstage.run

    def stage(args, test_config=None, device=None):
        (line,) = [r.getMessage() for r in main_log.records if "live status" in r.getMessage()]
        url = re.search(r"(http://[^/]+)", line).group(1)
        seen["health"] = json.loads(urllib.request.urlopen(url + "/healthz", timeout=5).read())
        seen["status"] = json.loads(urllib.request.urlopen(url + "/status", timeout=5).read())
        seen["watchdog"] = twatchdog._ACTIVE is not None
        return orig(args, test_config, device)

    monkeypatch.setattr(tstage, "run", stage)
    argv = ["-c", ty, "--filter-pvs", PVSES[0], "--live-port", "0",
            "--status-file", str(status_file), "--watchdog-soft", "60"]
    assert port_main(["p03", *argv], device="cpu") == 0
    assert seen["health"]["status"] == "ok" and seen["watchdog"]
    assert seen["status"]["run"] == {"name": "p03", "argv": argv}
    final = json.loads(status_file.read_text())
    assert final["run"]["name"] == "p03" and final["tasks"] == []
    assert twatchdog._ACTIVE is None


@pytest.mark.parametrize("flags, started", [
    (["--telemetry", "T"], False),
    (["--profile", "T"], False),
    (["--status-file", "T/status.json"], True),
    (["--watchdog-hard", "600"], True),
])
def test_the_watchdog_rides_the_live_flags_only(short_db, tmp_path, monkeypatch, flags, started):
    """Bare --telemetry or --profile starts no watchdog (a long encode beats
    only when it ends); the live surface and the watchdog flags do."""
    calls = []
    orig = twatchdog.start_watchdog
    monkeypatch.setattr(twatchdog, "start_watchdog",
                        lambda **kw: calls.append(kw) or orig(**kw))
    ty = _copy(short_db, tmp_path / "t")
    flags = [f.replace("T", str(tmp_path / "obs")) for f in flags]
    os.makedirs(tmp_path / "obs", exist_ok=True)
    assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[0], *flags], device="cpu") == 0
    assert bool(calls) is started
    assert twatchdog._ACTIVE is None


@pytest.mark.parametrize("case", ["status_path", "port"])
def test_unopenable_live_surface_exits_1(short_db, tmp_path, main_log, case):
    """An unwritable status path or a port that cannot be bound is the
    operator's mistake: exit 1 with the reason, no stage run."""
    import socket

    ty = _copy(short_db, tmp_path / "t")
    sock = None
    if case == "status_path":
        blocker = tmp_path / "file"
        blocker.write_text("")
        flags = ["--status-file", str(blocker / "status.json")]
    else:
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        sock.listen(1)
        flags = ["--live-port", str(sock.getsockname()[1])]
    try:
        assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[0], *flags], device="cpu") == 1
    finally:
        if sock is not None:
            sock.close()
    assert any("cannot start live observability" in r.getMessage() for r in main_log.records)
    assert os.listdir(os.path.join(os.path.dirname(ty), "avpvs")) == []
    assert twatchdog._ACTIVE is None


def test_persistence_failure_keeps_the_run_exit_code(short_db, tmp_path, main_log):
    """A telemetry folder that cannot be written is logged; the run's own
    exit code stands."""
    ty = _copy(short_db, tmp_path / "t")
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert port_main(["p03", "-c", ty, "--filter-pvs", PVSES[0], "--telemetry",
                      str(blocker / "tm")], device="cpu") == 0
    assert any("could not write telemetry" in r.getMessage() for r in main_log.records)
    assert any("cannot stream events" in r.getMessage() for r in main_log.records)


def test_events_stream_while_the_run_is_alive(tmp_path):
    """EventLog.open_stream appends each record as it is emitted (a killed
    run leaves its history); write_jsonl replaces it with the complete
    file; the log-handler bridge records WARNING+ lines."""
    log = ttm.EventLog()
    log.enabled = True
    path = str(tmp_path / "events.jsonl")
    log.open_stream(path)
    log.emit("run_start", name="p03")
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    assert [x["event"] for x in lines] == ["log_meta", "run_start"] and lines[0]["streaming"]
    logger = logging.getLogger("test_torch_cli_obs")
    handler = ttm.EventLogHandler(log)
    logger.addHandler(handler)
    try:
        logger.warning("degraded %s", "path")
        logger.info("not bridged")
    finally:
        logger.removeHandler(handler)
    log.write_jsonl(path)
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    assert [x["event"] for x in lines] == ["log_meta", "run_start", "log"]
    assert lines[-1] == {**lines[-1], "level": "WARNING", "message": "degraded path"}
    assert "n_events" in lines[0]
    main = logging.getLogger("main")
    first = ttm.attach_log_handler(main)
    assert ttm.attach_log_handler(main) is first
    ttm.detach_log_handler(main)
    assert first not in main.handlers


def test_p03_with_flags_runs_as_a_process_without_jax(short_db, tmp_path):
    """The flagged CLI as a process on the CPU: exit 0, the artifacts, no
    jax and nothing of the JAX package imported."""
    ty = _copy(short_db, tmp_path / "t")
    out = str(tmp_path / "tt")
    code = ("import sys\n"
            "from processing_chain_tpu_torch.cli import main\n"
            f"assert main(['p03', '-c', {ty!r}, '--filter-pvs', {PVSES[0]!r}, '--telemetry', "
            f"{out!r}, '--profile', {out!r}, '--status-file', {out + '/s.json'!r}], "
            "device='cpu') == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'processing_chain_tpu')]\n"
            "print('FORBIDDEN', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout
    assert len(_kinds(out)) == 7 and "s.json" in os.listdir(out)
