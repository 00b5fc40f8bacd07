"""The port's tools/queue_crashcheck over the port's serve queue (the
contracts of tests/test_queue_crashcheck.py).

The full fault matrix runs in-process (every atomic-write boundary in
the scripted claim/settle workload AND in the recovery path, killed
both before and after the write lands), plus the self-test proving the
harness can actually fail, and the port's declared transitions rendered
by the reference's chain-lint parser: the same table docs/SERVE.md
embeds, and the same fault matrix as the reference harness."""

import os

from processing_chain_tpu_torch.serve import queue as queue_module
from processing_chain_tpu_torch.serve.queue import INITIAL, STATES, TRANSITIONS
from processing_chain_tpu_torch.tools import queue_crashcheck as qc
from processing_chain_tpu.tools.chainlint.queue_transitions import (
    load_transitions, render_table,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_full_fault_matrix_reaches_declared_states_only(tmp_path):
    summary = qc.run_crashcheck(workdir=str(tmp_path))
    assert summary["ok"], "\n".join(summary["violations"])
    # every boundary was actually explored, in both crash modes
    assert summary["fault_points"]["scenario"] >= 10
    assert summary["fault_points"]["recovery"] >= 1
    expected = 2 * (summary["fault_points"]["scenario"]
                    + summary["fault_points"]["recovery"])
    assert summary["cases"] == expected
    assert summary["transitions_declared"] == len(TRANSITIONS)


def test_harness_can_fail(tmp_path, monkeypatch):
    """Injected-violation self-test: shrink the declared state set and
    the same matrix must report violations — a gate that cannot fire is
    decoration (the repo's standing self-test discipline)."""
    monkeypatch.setattr(qc, "STATES", ("queued", "running"))
    summary = qc.run_crashcheck(workdir=str(tmp_path))
    assert not summary["ok"]
    assert any("undeclared state" in v for v in summary["violations"])


def test_cli_entrypoint(tmp_path, capsys):
    rc = qc.main(["--workdir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"ok": true' in out


def test_render_table_matches_serve_doc():
    """docs/SERVE.md embeds exactly the rendered declaration (the
    chain-lint queue-transition doc-drift check enforces edge-level
    agreement; this pins the full rendered block — including the
    meaning column, which is parsed from the TRANSITIONS entries'
    trailing comments, the single source — so even a hand-edited cell
    shows up as drift here). The port has no renderer of its own: the
    reference's parser reads the port's declaration."""
    states, initial, transitions, meanings = \
        load_transitions(queue_module.__file__)
    assert states == STATES and initial == INITIAL
    assert transitions == set(TRANSITIONS)
    assert set(meanings) == transitions  # every edge carries a meaning
    rendered = render_table(states, initial, transitions, meanings)
    with open(os.path.join(REPO, "docs", "SERVE.md")) as f:
        doc = f.read()
    assert rendered in doc, (
        "docs/SERVE.md transition table is stale — re-render with "
        "`tools queue-crashcheck --render-table`"
    )


def test_declared_table_is_connected_and_recoverable():
    """Structural sanity of the declaration itself: every state is
    reachable from INITIAL, and every non-initial state has a path back
    to 'queued' (nothing the daemon can enter is a dead end — the
    re-arm edges guarantee a failed/evicted plan can always run again).
    """
    succ: dict = {}
    for a, b in TRANSITIONS:
        assert a in STATES and b in STATES
        succ.setdefault(a, set()).add(b)
    # forward reachability from INITIAL
    seen, frontier = {INITIAL}, [INITIAL]
    while frontier:
        for nxt in succ.get(frontier.pop(), ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    assert seen == set(STATES)
    # every state reaches 'queued' again (liveness of re-arm)
    for state in STATES:
        seen2, frontier2 = {state}, [state]
        while frontier2:
            for nxt in succ.get(frontier2.pop(), ()):
                if nxt not in seen2:
                    seen2.add(nxt)
                    frontier2.append(nxt)
        assert "queued" in seen2, f"{state} cannot re-arm"


def test_fault_matrix_equals_the_reference_harness(tmp_path):
    """Parity: the port's harness over the port's queue crosses the same
    atomic-write boundaries, in the same number of cases, as the
    reference harness over the reference queue (exact equality)."""
    from processing_chain_tpu.tools import queue_crashcheck as ref_qc

    ours = qc.run_crashcheck(workdir=str(tmp_path / "port"))
    ref = ref_qc.run_crashcheck(workdir=str(tmp_path / "ref"))
    assert ours["ok"] and ref["ok"]
    for key in ("fault_points", "cases", "transitions_declared"):
        assert ours[key] == ref[key], key
