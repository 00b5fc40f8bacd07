"""Port mirror of tests/test_plandebug.py: the PC_PLAN_DEBUG runtime
plan-purity recorder of the PyTorch package (processing_chain_tpu_torch/
utils/plandebug.py) — the unit surface (record/check/reset/dump), the
same-plan/different-bytes failure mode, directly and through the port's
store commits, and the env-diff forensics a violation must carry (the
PC_* knobs and the torch process-topology variables).

The suite-wide gate in tests/conftest.py's pytest_sessionfinish checks
only the JAX package's recorder. The port's recorder is checked here: by
the unit cases, and by a round of the port's serve path whose every
store commit must keep one plan to one byte stream."""

import ast
import json
import os

import pytest

import processing_chain_tpu_torch

from processing_chain_tpu_torch import telemetry as tm
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import runtime as store_runtime
from processing_chain_tpu_torch.store.plan_schema import ENV_INPUTS
from processing_chain_tpu_torch.store.store import ArtifactStore
from processing_chain_tpu_torch.utils import plandebug

PLAN_A = "a" * 64
PLAN_B = "b" * 64


@pytest.fixture(autouse=True)
def _recorder(monkeypatch):
    """Isolate every test's recordings AND never leak a deliberate
    violation into (or wipe real recordings out of) the suite-wide
    pytest_sessionfinish gate: run against a clean recorder, then
    restore whatever the rest of the suite had recorded so far."""
    monkeypatch.setenv("PC_PLAN_DEBUG", "1")
    saved = plandebug.snapshot_state()
    plandebug.reset()
    yield
    plandebug.restore_state(saved)


def test_disabled_records_nothing(monkeypatch):
    monkeypatch.setenv("PC_PLAN_DEBUG", "0")
    plandebug.record(PLAN_A, "d1")
    plandebug.record(PLAN_A, "d2")
    monkeypatch.setenv("PC_PLAN_DEBUG", "1")
    assert plandebug.check() == {"plans": 0, "violations": 0}


def test_same_plan_same_bytes_is_clean():
    plandebug.record(PLAN_A, "digest-1", producer="job-a")
    plandebug.record(PLAN_A, "digest-1", producer="job-a-rebuild")
    plandebug.record(PLAN_B, "digest-2")
    assert plandebug.check() == {"plans": 2, "violations": 0}


def test_same_plan_different_bytes_fails_with_env_diff(monkeypatch):
    monkeypatch.setenv("PC_FIXTURE_SLICES", "4")
    plandebug.record(PLAN_A, "digest-1", producer="first")
    monkeypatch.setenv("PC_FIXTURE_SLICES", "16")
    plandebug.record(PLAN_A, "digest-2", producer="second")
    with pytest.raises(plandebug.PlanPurityViolation) as exc:
        plandebug.check()
    msg = str(exc.value)
    assert PLAN_A[:16] in msg
    assert "PC_FIXTURE_SLICES" in msg  # the hidden input is NAMED
    assert "first" in msg and "second" in msg


def test_no_env_diff_is_reported_honestly():
    plandebug.record(PLAN_A, "digest-1")
    plandebug.record(PLAN_A, "digest-2")
    with pytest.raises(plandebug.PlanPurityViolation,
                       match="no PC_\\*/topology env key differed"):
        plandebug.check()


def test_reset_clears_violations():
    plandebug.record(PLAN_A, "d1")
    plandebug.record(PLAN_A, "d2")
    plandebug.reset()
    assert plandebug.check() == {"plans": 0, "violations": 0}


def test_dump_persists_plans_and_violations(tmp_path):
    plandebug.record(PLAN_A, "d1", producer="p1")
    plandebug.record(PLAN_A, "d2", producer="p2")
    out = str(tmp_path / "plandebug.json")
    plandebug.dump(out)
    with open(out) as f:
        doc = json.load(f)
    assert doc["plans"][PLAN_A]["sha256"] == "d1"
    assert len(doc["violations"]) == 1
    assert doc["violations"][0]["plan"] == PLAN_A
    plandebug.reset()


def _commit(store, plan_hash, path, data: bytes, producer=""):
    with open(path, "wb") as f:
        f.write(data)
    store.commit(plan_hash, str(path), producer=producer)


def test_store_commits_feed_the_recorder(tmp_path):
    """The integration point: two real store commits of the same plan
    hash with different bytes must trip check() — the exact
    cache-poisoning scenario the recorder exists to catch (a hidden
    input changed the artifact without changing the key)."""
    store = ArtifactStore(str(tmp_path / "store"))
    _commit(store, PLAN_A, tmp_path / "a1.bin", b"bytes-one", "cold")
    _commit(store, PLAN_B, tmp_path / "b.bin", b"other", "cold")
    assert plandebug.check()["plans"] == 2

    # deterministic rebuild: same plan, same bytes — still clean
    _commit(store, PLAN_A, tmp_path / "a2.bin", b"bytes-one", "rebuild")
    assert plandebug.check()["plans"] == 2

    # the poisoning case
    _commit(store, PLAN_A, tmp_path / "a3.bin", b"bytes-DIFFER", "poisoned")
    with pytest.raises(plandebug.PlanPurityViolation):
        plandebug.check()
    plandebug.reset()


def test_zero_overhead_contract_when_disabled(monkeypatch):
    """With the knob off, record() must not even snapshot the env —
    the lockdebug-style production guarantee."""
    monkeypatch.setenv("PC_PLAN_DEBUG", "")
    calls = []
    monkeypatch.setattr(plandebug, "_env_snapshot",
                        lambda: calls.append(1) or {})
    plandebug.record(PLAN_A, "d1")
    assert calls == []


def test_topology_env_is_named_in_the_diff(monkeypatch):
    """The torch topology variables store/plan_schema.py declares exempt
    are in the snapshot, so a violation names them; other variables are
    not."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("UNRELATED_VAR", "a")
    plandebug.record(PLAN_A, "d1")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("UNRELATED_VAR", "b")
    plandebug.record(PLAN_A, "d2")
    with pytest.raises(plandebug.PlanPurityViolation) as exc:
        plandebug.check()
    assert "RANK" in str(exc.value) and "UNRELATED_VAR" not in str(exc.value)


def _serve_round(root, store_root, geos):
    """One port wave service over `store_root`: a request per geometry
    for SRC001/SRC002 x HRC001; returns {pvs_id: plan hash} per request."""
    svc = ChainServeService(root=str(root), port=0, executor="wave", workers=1,
                            device="cpu", store_root=str(store_root)).start()
    try:
        plans = []
        for geo in geos:
            acc = svc.submit({"tenant": "lab-a", "database": "P2STR01",
                              "srcs": ["SRC001", "SRC002"], "hrcs": ["HRC001"],
                              "params": dict(geo)})
            assert svc.wait_request(acc["request"], timeout=60.0) == "done"
            units = svc.request_status(acc["request"])["units"]
            plans.append({pvs: u["plan"] for pvs, u in units.items()})
        return plans
    finally:
        svc.stop()
        store_runtime.configure(None)
        tm.disable()


def test_serve_round_keeps_one_plan_one_byte_stream(tmp_path):
    """The port-side gate: a round of the port's serve path (the wave
    executor over run_bucket, committing to the artifact store) feeds
    the recorder one commit per distinct plan, and check() is clean. A
    second service over the same store serves a repeated request from
    it and adds no plan; a new geometry adds its own."""
    up = {"frames": 6, "src_h": 36, "src_w": 64, "dst_h": 72, "dst_w": 128}
    down = {"frames": 6, "src_h": 72, "src_w": 128, "dst_h": 36, "dst_w": 64}
    store_root = tmp_path / "store"
    first = _serve_round(tmp_path / "a", store_root, [up, down])
    assert plandebug.check() == {"plans": 4, "violations": 0}
    again = _serve_round(tmp_path / "b", store_root, [up])
    assert again[0] == first[0]
    assert plandebug.check() == {"plans": 4, "violations": 0}
    scopes = {scope for scope, _h in plandebug.snapshot_state()[0]}
    assert scopes == {str(store_root)}


#: PC_* reads that reach no artifact: the debug recorders and the live
#: endpoint's bind address (the JAX registry leaves them out as well)
NOT_PLAN_INPUTS = {"PC_LOCK_DEBUG", "PC_PLAN_DEBUG", "PC_LIVE_HOST"}
TOPOLOGY = {"WORLD_SIZE", "RANK", "LOCAL_RANK"}


def _env_reads():
    """(name, file, line) of every literal env read in the port:
    os.environ.get / os.getenv / os.environ[...] / avpvs._env_int."""
    root = os.path.dirname(processing_chain_tpu_torch.__file__)
    reads = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                src = f.read()
            for node in ast.walk(ast.parse(src)):
                arg = None
                if isinstance(node, ast.Call) and node.args:
                    func = ast.unparse(node.func)
                    if func in ("os.environ.get", "os.getenv", "_env_int"):
                        arg = node.args[0]
                elif isinstance(node, ast.Subscript) and \
                        ast.unparse(node.value) == "os.environ":
                    arg = node.slice
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    reads.append((arg.value, path, node.lineno))
    return reads, root


def test_plan_schema_declares_the_ports_env_reads():
    """store/plan_schema.ENV_INPUTS is exactly the PC_* and topology
    names the port reads (less the debug and bind-address knobs); each
    read of an `exempt` input carries its `# plan-exempt` annotation on
    the line above, and each `plan` input's plan_key is a field of the
    wo_buffer plan payload."""
    reads, root = _env_reads()
    names = {n for n, _p, _l in reads if n.startswith("PC_") or n in TOPOLOGY}
    assert names - NOT_PLAN_INPUTS == set(ENV_INPUTS)
    for name, path, line in reads:
        if ENV_INPUTS.get(name, {}).get("status") != "exempt":
            continue
        with open(path) as f:
            lines = f.read().splitlines()
        assert "# plan-exempt:" in lines[line - 2], f"{path}:{line} reads {name}"
    with open(os.path.join(root, "models", "avpvs.py")) as f:
        tree = ast.parse(f.read())
    plan = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "_wo_buffer_plan")
    ret = next(n for n in ast.walk(plan) if isinstance(n, ast.Return))
    fields = {k.value for k in ret.value.keys}
    for name, entry in ENV_INPUTS.items():
        if entry["status"] == "plan":
            assert entry["plan_key"] in fields, name
