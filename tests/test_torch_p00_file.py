"""The port's whole chain from a source video (`python -m
processing_chain_tpu_torch p00`, stages/p00_process_all) on the CPU,
against the JAX package: the port's p00 over one copy of a short database
(libx264 segments, a stall HRC, a PC context), and the JAX p02-p04 over
another copy holding the port's segments. The metadata must be byte-equal
and the lossless AVPVS (FFV1) and PC CPVS (UYVY) decode identical, with
the SI/TI sidecars within 1e-3, as tests/test_torch_p03_file.py holds
them. Then the `-str` subsets, a warm re-run that plans no job, and
`--filter-pvs`.

Every test that runs p03 or p04 restores PC_FFV1_WORKERS/PC_FFV1_THREADS
(the autouse fixture of tests/test_torch_p03_file.py).
"""

import os
import shutil

import numpy as np
import pytest

from processing_chain_tpu.cli import main as jax_main
from processing_chain_tpu_torch import telemetry as ttm
from processing_chain_tpu_torch.cli import main as port_main
from processing_chain_tpu_torch.config import TestConfig as TTestConfig
from tests.test_pipeline_e2e import write_db
from tests.test_torch_p03_file import (  # noqa: F401  (fixtures)
    DB,
    PVSES,
    SHORT_YAML,
    _assert_same_avpvs,
    _decoded,
    _writeback_env,
)

FAMILIES = {"qchanges": "qualityChangeEventFiles", "vfi": "videoFrameInformation",
            "afi": "audioFrameInformation", "buff": "buffEventFiles"}
#: what each stage writes, by folder
STAGE_FOLDERS = {"1": ("videoSegments",), "2": tuple(FAMILIES.values()),
                 "3": ("avpvs",), "4": ("cpvs",)}


def _folders(yaml_path: str) -> set:
    """The artifact folders of a database that hold a file."""
    root = os.path.dirname(yaml_path)
    return {d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)) and os.listdir(os.path.join(root, d))}


@pytest.fixture(scope="module")
def source_db(tmp_path_factory):
    """The short database of tests/test_torch_p03_file.py with its SRC
    only: p00 starts from the source video."""
    tmp = tmp_path_factory.mktemp("p00src")
    return write_db(tmp, DB, SHORT_YAML, {"SRC000.avi": dict(n=48, audio=True)})


def _copy(yaml_path: str, dest) -> str:
    shutil.copytree(os.path.dirname(yaml_path), dest / DB)
    return str(dest / DB / os.path.basename(yaml_path))


def _jax(stage: str, yaml_path: str, resize: str = "") -> None:
    """A JAX stage on one device (`-g 0`), with PC_RESIZE_METHOD set only
    around it when given."""
    saved = os.environ.pop("PC_RESIZE_METHOD", None)
    if resize:
        os.environ["PC_RESIZE_METHOD"] = resize
    try:
        flags = ["-g", "0"] if stage in ("p03", "p04") else []
        assert jax_main([stage, "-c", yaml_path, "--skip-requirements", *flags]) == 0
    finally:
        os.environ.pop("PC_RESIZE_METHOD", None)
        if saved is not None:
            os.environ["PC_RESIZE_METHOD"] = saved


def test_p00_equals_the_jax_stages_over_its_segments(source_db, tmp_path):
    """The port's p00 (p01 → p04); the JAX p02, p03 and p04 (its PC lift
    on the fused route the port's u8 bilinear equals, tests/
    test_torch_p04_file.py) over a copy holding the port's segments: the
    same metadata bytes, decoded-identical AVPVS (wo_buffer and stalled)
    and PC CPVS."""
    ty = _copy(source_db, tmp_path / "t")
    assert port_main(["p00", "-c", ty, "--skip-requirements", "-p", "2"], device="cpu") == 0
    assert _folders(ty) >= {f for k in "1234" for f in STAGE_FOLDERS[k]}
    jy = _copy(source_db, tmp_path / "j")
    shutil.copytree(os.path.join(os.path.dirname(ty), "videoSegments"),
                    os.path.join(os.path.dirname(jy), "videoSegments"))
    _jax("p02", jy)
    _jax("p03", jy)
    _jax("p04", jy, resize="fused")
    jtc, ttc = TTestConfig(jy), TTestConfig(ty)
    for pvs_id in PVSES:
        for family, folder in FAMILIES.items():
            if family == "buff" and not ttc.pvses[pvs_id].has_buffering():
                continue
            a, b = (os.path.join(os.path.dirname(y), folder, f"{pvs_id}.{family}")
                    for y in (jy, ty))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fb.read() == fa.read(), (pvs_id, family)
        jp, tp = jtc.pvses[pvs_id], ttc.pvses[pvs_id]
        _assert_same_avpvs(jp.get_avpvs_file_path(), tp.get_avpvs_file_path())
        if tp.has_buffering():
            _assert_same_avpvs(jp.get_avpvs_wo_buffer_file_path(),
                               tp.get_avpvs_wo_buffer_file_path())
        (ja, _), (ta, _) = _decoded(jp.get_cpvs_file_path("pc")), _decoded(tp.get_cpvs_file_path("pc"))
        assert len(ta) == len(ja) and ta[0].shape[0] >= 48
        for x, y in zip(ja, ta):
            np.testing.assert_array_equal(x, y)


def _planned() -> dict:
    """chain_jobs_planned_total by runner (p01, p02, p03, p03-stall, p04)."""
    return {r: ttm.REGISTRY.sum_series("chain_jobs_planned_total", {"runner": r}) or 0.0
            for r in ("p01", "p02", "p03", "p03-stall", "p04")}


def test_stage_subsets_then_a_warm_rerun_plans_no_job(source_db, tmp_path):
    """`-str 12` writes the segments and the metadata and nothing after
    them; `-str 34` the AVPVS and CPVS from them; a warm p00 over the
    whole chain then plans no job in any stage."""
    ty = _copy(source_db, tmp_path)
    assert port_main(["p00", "-c", ty, "--skip-requirements", "-str", "12"], device="cpu") == 0
    assert _folders(ty) & {f for k in "1234" for f in STAGE_FOLDERS[k]} == \
        set(STAGE_FOLDERS["1"]) | {"qualityChangeEventFiles", "videoFrameInformation",
                                   "audioFrameInformation", "buffEventFiles"}
    assert port_main(["p00", "-c", ty, "--skip-requirements", "-str", "34"], device="cpu") == 0
    assert _folders(ty) >= {"avpvs", "cpvs"}
    was = ttm.enabled()
    ttm.enable()
    try:
        before = _planned()
        assert port_main(["p00", "-c", ty, "--skip-requirements"], device="cpu") == 0
        after = _planned()
    finally:
        if not was:
            ttm.disable()
    assert after == before, (before, after)


def test_filter_pvs_selects_a_subset(source_db, tmp_path):
    """`--filter-pvs` keeps p00 to one PVS: its segment, metadata and
    AVPVS only."""
    ty = _copy(source_db, tmp_path)
    pvs_id = PVSES[1]
    assert port_main(["p00", "-c", ty, "--skip-requirements", "-str", "123",
                      "--filter-pvs", pvs_id], device="cpu") == 0
    root = os.path.dirname(ty)
    [seg] = TTestConfig(ty).pvses[pvs_id].segments
    assert os.listdir(os.path.join(root, "videoSegments")) == [seg.filename]
    assert sorted(os.listdir(os.path.join(root, "qualityChangeEventFiles"))) == [f"{pvs_id}.qchanges"]
    assert [n for n in os.listdir(os.path.join(root, "avpvs")) if n.endswith(".avi")] == \
        [os.path.basename(TTestConfig(ty).pvses[pvs_id].get_avpvs_file_path())]


def test_p00_and_p02_routes_and_usage(source_db, tmp_path, capsys):
    """`__main__` routes p00, p01 and p02 to the stage CLI, whose usage
    names all five stages; p02 runs on the host, with no device."""
    from processing_chain_tpu_torch.__main__ import main as pkg_main

    assert pkg_main(["p05"]) == 2
    err = capsys.readouterr().err
    assert "p00|p01|p02|p03|p04" in err
    assert port_main([]) == 2
    assert "p00|p01|p02|p03|p04" in capsys.readouterr().err
    ty = _copy(source_db, tmp_path)
    assert port_main(["p01", "-c", ty, "--skip-requirements", "--filter-pvs", PVSES[0]],
                     device="cpu") == 0
    assert pkg_main(["p02", "-c", ty, "--skip-requirements", "--filter-pvs", PVSES[0]]) == 0
    assert os.listdir(os.path.join(os.path.dirname(ty), "qualityChangeEventFiles")) == \
        [f"{PVSES[0]}.qchanges"]
