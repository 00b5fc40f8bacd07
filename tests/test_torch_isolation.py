"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest

from processing_chain_tpu_torch.models import avpvs as ta
from processing_chain_tpu_torch.utils import device as tdev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "processing_chain_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "processing_chain_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
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
    assert "processing_chain_tpu_torch.models.avpvs" in loaded
    assert "chip_smoke" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


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
    with pytest.raises(tdev.DeviceError, match="out of range"):
        tdev.select_device(0)
    assert tdev.device_count() == 0
    assert str(tdev.resolve_device("cpu")) == "cpu"
