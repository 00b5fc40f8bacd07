"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from processing_chain_tpu_torch.models import avpvs as ta
from processing_chain_tpu_torch.models import segments as tseg
from processing_chain_tpu_torch.parallel import distributed as tdist
from processing_chain_tpu_torch.parallel import mesh as tmesh
from processing_chain_tpu_torch.priors import features as tfeat
from processing_chain_tpu_torch.tools import mesh_report as tmr
from processing_chain_tpu_torch.tools import quality_metrics as tqm
from processing_chain_tpu_torch.tools import src_analysis as tsa
from processing_chain_tpu_torch.utils import device as tdev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "processing_chain_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "processing_chain_tpu")


def _port_files():
    files = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "tune_siti.py", "tune_resize.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _port_modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_fresh_interpreter_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    for mod in ("processing_chain_tpu_torch.models.avpvs", "chip_smoke",
                "processing_chain_tpu_torch.io.bufpool",
                "processing_chain_tpu_torch.engine.prefetch",
                "processing_chain_tpu_torch.parallel.mesh",
                "processing_chain_tpu_torch.parallel.meshobs",
                "processing_chain_tpu_torch.parallel.distributed",
                "processing_chain_tpu_torch.parallel.halo",
                "processing_chain_tpu_torch.parallel.pipeline",
                "processing_chain_tpu_torch.tools.mesh_report",
                "processing_chain_tpu_torch.parallel.p03_batch",
                "processing_chain_tpu_torch.ops.overlay",
                "processing_chain_tpu_torch.ops.pad",
                "processing_chain_tpu_torch.ops.pixfmt",
                "processing_chain_tpu_torch.config.domain",
                "processing_chain_tpu_torch.models.cpvs",
                "processing_chain_tpu_torch.models.fused",
                "processing_chain_tpu_torch.models.segments",
                "processing_chain_tpu_torch.ops.fps",
                "processing_chain_tpu_torch.ops.metrics",
                "processing_chain_tpu_torch.tools.quality_metrics",
                "processing_chain_tpu_torch.tools.src_analysis",
                "processing_chain_tpu_torch.priors.features", "tune_resize",
                "processing_chain_tpu_torch.serve.service",
                "processing_chain_tpu_torch.serve.queue",
                "processing_chain_tpu_torch.serve.scheduler",
                "processing_chain_tpu_torch.serve.executors",
                "processing_chain_tpu_torch.serve.spans",
                "processing_chain_tpu_torch.serve.api",
                "processing_chain_tpu_torch.store.store",
                "processing_chain_tpu_torch.store.keys",
                "processing_chain_tpu_torch.store.runtime",
                "processing_chain_tpu_torch.store.backends.local",
                "processing_chain_tpu_torch.engine.jobs",
                "processing_chain_tpu_torch.telemetry.live",
                "processing_chain_tpu_torch.telemetry.catalog",
                "processing_chain_tpu_torch.telemetry.heartbeat",
                "processing_chain_tpu_torch.utils.runner",
                "processing_chain_tpu_torch.utils.lockdebug",
                "processing_chain_tpu_torch.utils.version",
                "processing_chain_tpu_torch.config.ids",
                "processing_chain_tpu_torch.tools.chain_serve",
                "processing_chain_tpu_torch.telemetry",
                "processing_chain_tpu_torch.telemetry.events",
                "processing_chain_tpu_torch.telemetry.metrics",
                "processing_chain_tpu_torch.telemetry.profiling",
                "processing_chain_tpu_torch.telemetry.report",
                "processing_chain_tpu_torch.telemetry.watchdog",
                "processing_chain_tpu_torch.utils.tracing",
                "processing_chain_tpu_torch.tools.chain_profile",
                "processing_chain_tpu_torch.tools.chain_top",
                "processing_chain_tpu_torch.tools.mesh_top",
                "processing_chain_tpu_torch.config",
                "processing_chain_tpu_torch.config.errors",
                "processing_chain_tpu_torch.config.probe_api",
                "processing_chain_tpu_torch.config.test_config",
                "processing_chain_tpu_torch.io.medialib",
                "processing_chain_tpu_torch.store.plan_schema",
                "processing_chain_tpu_torch.utils.plandebug",
                "processing_chain_tpu_torch.utils.parse_args",
                "processing_chain_tpu_torch.tools.clean_logs",
                "processing_chain_tpu_torch.tools.plots",
                "processing_chain_tpu_torch.store.backends",
                "processing_chain_tpu_torch.store.backends.object",
                "processing_chain_tpu_torch.store.tiers",
                "processing_chain_tpu_torch.store.gc",
                "processing_chain_tpu_torch.store.heat",
                "processing_chain_tpu_torch.serve.pressure",
                "processing_chain_tpu_torch.serve.cost",
                "processing_chain_tpu_torch.serve.autoscale",
                "processing_chain_tpu_torch.telemetry.alerts",
                "processing_chain_tpu_torch.telemetry.fleet",
                "processing_chain_tpu_torch.tools.serve_admin",
                "processing_chain_tpu_torch.tools.store_admin",
                "processing_chain_tpu_torch.tools.store_heat",
                "processing_chain_tpu_torch.tools.store_tiers",
                "processing_chain_tpu_torch.tools.fleet_doctor",
                "processing_chain_tpu_torch.tools.fleet_top",
                "processing_chain_tpu_torch.tools.queue_crashcheck",
                "processing_chain_tpu_torch.tools.trace_tool",
                "processing_chain_tpu_torch.tools.serve_soak",
                "processing_chain_tpu_torch.tools.serve_chaos",
                "processing_chain_tpu_torch.tools.chainlint",
                "processing_chain_tpu_torch.tools.chainlint.atomic",
                "processing_chain_tpu_torch.tools.chainlint.baseline",
                "processing_chain_tpu_torch.tools.chainlint.cli",
                "processing_chain_tpu_torch.tools.chainlint.core",
                "processing_chain_tpu_torch.tools.chainlint.locks",
                "processing_chain_tpu_torch.tools.chainlint.ownership",
                "processing_chain_tpu_torch.tools.chainlint.planpurity",
                "processing_chain_tpu_torch.tools.chainlint.queue_transitions",
                "processing_chain_tpu_torch.tools.chainlint.subproc",
                "processing_chain_tpu_torch.tools.chainlint.telemetry_names",
                "processing_chain_tpu_torch.io.medialib",
                "processing_chain_tpu_torch.io.probe",
                "processing_chain_tpu_torch.io.sharedscan",
                "processing_chain_tpu_torch.io.video",
                "processing_chain_tpu_torch.cli",
                "processing_chain_tpu_torch.stages.p03_generate_avpvs",
                "processing_chain_tpu_torch.__main__"):
        assert mod in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert "matplotlib" not in loaded  # tools/plots imports it only to draw


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


@pytest.mark.parametrize("path", sorted(
    os.path.join(PKG, "csrc", n) for n in os.listdir(os.path.join(PKG, "csrc"))),
    ids=os.path.basename)
def test_native_source_includes_nothing_of_the_jax_package_or_libav(path):
    """csrc/ builds from the repo alone: no JAX-package file, and the
    media boundary declares what it calls of libav instead of including
    its headers."""
    import re

    with open(path) as f:
        includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", f.read(), re.M)
    assert includes
    assert not [i for i in includes if "processing_chain_tpu" in i or "native/" in i
                or i.startswith(("libav", "libsw"))]


def test_default_device_raises_without_cuda(monkeypatch):
    if tdev.torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device resolves")
    monkeypatch.delenv("PC_CHUNK_FRAMES", raising=False)
    with pytest.raises(tdev.DeviceError, match="CUDA is not available"):
        tdev.resolve_device(None)
    with pytest.raises(tdev.DeviceError):
        ta.pump_ready(iter([]), None, ta.SiTiAccumulator(), 8, 8, "yuv420p")
    with pytest.raises(tdev.DeviceError):
        ta.chunk_frames()
    with pytest.raises(tdev.DeviceError):
        tmesh.make_mesh()
    with pytest.raises(tdev.DeviceError):
        tmesh.make_mesh(None, time_parallel=2)
    with pytest.raises(tdev.DeviceError):
        tdist.initialize("tcp://127.0.0.1:1", 1, 0)
    with pytest.raises(tdev.DeviceError):
        tmr.main(["sweep"])
    with pytest.raises(tdev.DeviceError):
        tseg.scaled_chunks(iter([]), 60.0, 30.0, 8, 8, "yuv420p")
    with pytest.raises(tdev.DeviceError):
        tqm.score_chunks(iter([]))
    with pytest.raises(tdev.DeviceError):
        tsa.src_siti_summary(iter([]))
    with pytest.raises(tdev.DeviceError):
        tfeat.temporal_features(None)
    with pytest.raises(tdev.DeviceError):
        tfeat.mv_magnitudes(np.zeros((1, 7), np.int32))
    with pytest.raises(tdev.DeviceError):
        tfeat.field_divergence(np.zeros((2, 2, 2), np.float32))
    with pytest.raises(tdev.DeviceError, match="out of range"):
        tdev.select_device(0)
    assert tdev.device_count() == 0
    assert str(tdev.resolve_device("cpu")) == "cpu"


def test_serve_refuses_to_run_without_cuda(tmp_path):
    """The wave executor of the service and of `tools chain-serve` runs
    on `cuda:0` unless a device is given: without CUDA both refuse, and
    nothing drops to the CPU on its own."""
    if tdev.torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device resolves")
    from processing_chain_tpu_torch.serve import executors as texec
    from processing_chain_tpu_torch.serve.service import ChainServeService
    from processing_chain_tpu_torch.store import runtime as store_runtime
    from processing_chain_tpu_torch import telemetry as ttm
    from processing_chain_tpu_torch.tools import chain_serve

    try:
        with pytest.raises(tdev.DeviceError, match="CUDA is not available"):
            ChainServeService(root=str(tmp_path / "svc"), port=0, executor="wave")
        with pytest.raises(tdev.DeviceError, match="CUDA is not available"):
            texec.DeviceWaveExecutor()
        with pytest.raises(tdev.DeviceError, match="CUDA is not available"):
            chain_serve.main(["--root", str(tmp_path / "cli"), "--port", "0",
                              "--executor", "wave"])
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "-m", "processing_chain_tpu_torch", "tools",
             "chain-serve", "--root", str(tmp_path / "cli2"), "--port", "0",
             "--executor", "wave"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
        assert not os.path.exists(tmp_path / "cli2" / "serve-info.json")
    finally:
        store_runtime.configure(None)
        ttm.disable()
