"""Port parity: the host tools that come with the database model
(processing_chain_tpu_torch/utils/parse_args, tools/clean_logs,
tools/plots) against the JAX package's, and the port's one ConfigError
class."""

import os
import time

import pytest

from processing_chain_tpu.tools import clean_logs as jcl
from processing_chain_tpu.tools import plots as jplots
from processing_chain_tpu.utils import parse_args as jpa
from processing_chain_tpu_torch.tools import clean_logs as tcl
from processing_chain_tpu_torch.tools import plots as tplots
from processing_chain_tpu_torch.utils import parse_args as tpa
from tests.fixtures import write_long_db, write_short_db

# (name, script) of every stage the JAX CLI parses for (cli._dispatch)
STAGES = [("processAll", None), ("p01", 1), ("p02", 2), ("p03", 3), ("p04", 4)]
PACKAGE_DIRS = (os.path.dirname(os.path.dirname(os.path.abspath(jpa.__file__))),
                os.path.dirname(os.path.dirname(os.path.abspath(tpa.__file__))))


def _default(value, pkg_dir):
    """A default path inside a package, relative to it (the spinner ships
    in each package's assets/)."""
    if isinstance(value, str) and value.startswith(pkg_dir + os.sep):
        return os.path.relpath(value, pkg_dir)
    return value


def _surface(parser, pkg_dir):
    return [(a.option_strings, a.dest, _default(a.default, pkg_dir), a.type, a.nargs, a.const,
             a.choices, a.required, type(a).__name__) for a in parser._actions]


@pytest.mark.parametrize("name,script", STAGES)
def test_parse_args_surface_equals_jax(name, script):
    ours = _surface(tpa.build_parser(name, script), PACKAGE_DIRS[1])
    ref = _surface(jpa.build_parser(name, script), PACKAGE_DIRS[0])
    assert ours == ref
    argv = ["-c", "db/P2SXM00.yaml", "-v", "-p", "2", "--filter-hrc", "HRC000|HRC001",
            "--trace", "--store", "/tmp/s"]
    if script in (None, 1, 3, 4):
        argv += ["-g", "0"]
    if script == 3:
        argv += ["-z", "--ffv1-workers", "3", "--avpvs-codec", "rawvideo"]
    if script == 4:
        argv += ["-e", "-a", "-ccrf", "20"]
    got = vars(tpa.parse_args(name, script, argv))
    want = vars(jpa.parse_args(name, script, argv))
    if script == 3:
        got["spinner_path"] = _default(got["spinner_path"], PACKAGE_DIRS[1])
        want["spinner_path"] = _default(want["spinner_path"], PACKAGE_DIRS[0])
        assert os.path.isfile(tpa.build_parser(name, script).get_default("spinner_path"))
    assert got == want
    with pytest.raises(SystemExit):
        tpa.parse_args(name, script, ["-v"])  # -c is required


def _tree(root):
    """A database folder with every kind of byproduct clean_logs knows."""
    files = ["logs/a.log", "logs/trace_1.json", "videoSegments/x.mbtree", "x.temp",
             "logs/passlogfile_x.stats", "logs/passlogfile_x.stats.cutree",
             "logs/p.stats.mbtree", "avpvs/P2SXM00_SRC000_HRC000.avi",
             "avpvs/P2SXM00_SRC000_HRC000.avi.inprogress", ".barrier_old", ".barrier_new",
             "cpvs/keep.mp4"]
    for rel in files:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "w").close()
    old = time.time() - 26 * 3600
    os.utime(os.path.join(root, ".barrier_old"), (old, old))


def test_clean_logs_collect_and_run_equal(tmp_path):
    roots = [str(tmp_path / "jax"), str(tmp_path / "torch")]
    for r in roots:
        _tree(r)

    def rel(paths, root):
        return [os.path.relpath(p, root) for p in paths]

    for prov in (False, True):
        assert rel(tcl.collect(roots[1], prov), roots[1]) == rel(jcl.collect(roots[0], prov),
                                                                  roots[0])
    assert rel(tcl.run(roots[1], dry_run=True), roots[1]) == \
        rel(jcl.run(roots[0], dry_run=True), roots[0])
    ours = rel(tcl.run(roots[1], include_provenance=True), roots[1])
    ref = rel(jcl.run(roots[0], include_provenance=True), roots[0])
    assert ours == ref and ".barrier_old" in ours and ".barrier_new" not in ours
    left = [sorted(rel([os.path.join(d, f) for d, _, fs in os.walk(r) for f in fs], r))
            for r in roots]
    assert left[0] == left[1] and "avpvs/P2SXM00_SRC000_HRC000.avi.inprogress" in left[1]


def test_clean_logs_cli(tmp_path):
    from processing_chain_tpu_torch.__main__ import main

    _tree(str(tmp_path))
    assert main(["tools", "clean-logs", str(tmp_path), "-n"]) == 0
    assert os.path.isfile(tmp_path / "x.temp")
    assert main(["tools", "clean-logs", str(tmp_path)]) == 0
    assert not os.path.isfile(tmp_path / "x.temp") and os.path.isfile(tmp_path / "logs/a.log")
    assert main(["tools", "clean-logs", str(tmp_path / "missing")]) == 1


EVENT_LISTS = [
    ("HRC000", [["Q0", 4], ["stall", 1.0], ["Q1", 8]], 120.0, 2.0),
    ("HRC001", [["Q0", 3], ["Q1", 12]], 30.0, 5.0),
    ("HRC002", [["Q0", 10], ["freeze", 0.5], ["Q1", 4]], 61.0, 0.0),
    ("HRC003", [["buffering", 2.0], ["Q1", 0], ["Q0", 7.5]], 20.0, 2.5),
    ("HRC004", [["stall", 1.0]], 10.0, 1.0),
]


@pytest.mark.parametrize("hrc,events,video,seg", EVENT_LISTS, ids=lambda x: str(x)[:8])
def test_plots_design_rules_equal(hrc, events, video, seg):
    assert tplots.design_warnings(hrc, events, video, seg) == \
        jplots.design_warnings(hrc, events, video, seg)
    assert tplots.event_list_duration(events) == jplots.event_list_duration(events)
    assert [tplots.height_color(h) for h in (100, 360, 500, 2160, 4320)] == \
        [jplots.height_color(h) for h in (100, 360, 500, 2160, 4320)]


def test_plot_long_and_short_write_files(tmp_path):
    long_yaml, _ = write_long_db(tmp_path / "long")
    short_yaml, _ = write_short_db(tmp_path / "short")
    out = str(tmp_path / "long.svg")
    warnings = tplots.plot_long(long_yaml, out)
    assert os.path.getsize(out) > 0
    assert warnings == jplots.plot_long(long_yaml, str(tmp_path / "long_jax.svg"))
    written = tplots.plot_short(short_yaml, str(tmp_path / "short.svg"))
    assert written == [str(tmp_path / "short.svg")] and os.path.getsize(written[0]) > 0
    per_codec = tplots.plot_short(short_yaml, str(tmp_path / "codec.svg"), codec_wise=True)
    assert len(per_codec) == 3 and all(os.path.getsize(p) > 0 for p in per_codec)


def test_plots_cli(tmp_path):
    from processing_chain_tpu_torch.__main__ import main

    short_yaml, _ = write_short_db(tmp_path)
    out = str(tmp_path / "d.svg")
    assert main(["tools", "plots", short_yaml, "--kind", "short", "-o", out]) == 0
    assert os.path.getsize(out) > 0


def test_one_config_error_class():
    """ops/fps, config/ids, the domain and TestConfig raise the one
    config.errors.ConfigError (the port once defined a second class in
    config/domain, which an `except` on the other missed)."""
    from processing_chain_tpu_torch.config import ConfigError as exported
    from processing_chain_tpu_torch.config import domain, ids
    from processing_chain_tpu_torch.config import errors
    from processing_chain_tpu_torch.ops import fps

    assert domain.ConfigError is errors.ConfigError is exported
    caught = []
    for fn in (lambda: fps.resolve_fps_spec("24/25/30", 23.976),
               lambda: fps.select_table(60.0, 17.0),
               lambda: ids.validate("SRC", "XYZ001", ids.REGEX_SRC_ID),
               lambda: domain.PostProcessing(None, {"type": "tv"})):
        try:
            fn()
        except errors.ConfigError as exc:
            caught.append(type(exc))
    assert caught == [errors.ConfigError] * 4
