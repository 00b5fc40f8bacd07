"""Runtime lock-order recorder (the dynamic half of chainlint's
``lock-order`` rule; copy of processing_chain_tpu/utils/lockdebug.py).

``make_lock(name)`` is the chain's lock constructor. With
``PC_LOCK_DEBUG`` unset (production, benches) it returns a plain
``threading.Lock`` — ZERO added overhead, not even a flag check per
acquire, because the decision is made once at construction time. With
``PC_LOCK_DEBUG=1`` (the test suite turns it on in tests/conftest.py) it
returns a ``_TrackedLock`` that records, per thread, which named locks
are held at every acquisition and folds each (held → acquired) pair into
a process-wide edge graph. ``check()`` then asserts the observed graph
is acyclic — the same cycle detector chainlint's static checker uses, so
static and dynamic evidence can never disagree on what a deadlock is.

Edges are keyed by lock NAME, not instance: two BufferPools both named
"bufpool" are one node, which is exactly right for order policy (and
why same-name nesting is not recorded as an edge — pool A inside pool B
is instance-level, not an order inversion). An immediate inversion
(acquiring B under A when B→A was already observed) is additionally
recorded as a violation with both stacks' lock chains, so ``check()``
can name the two call sites instead of just the cycle.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union


def enabled() -> bool:
    return os.environ.get("PC_LOCK_DEBUG", "").strip().lower() in (
        "1", "on", "true", "yes",
    )


_graph_lock = threading.Lock()
#: (outer name, inner name) -> (thread name, outer-held chain at record time)
_edges: dict[tuple, tuple] = {}
#: inversions seen live: (a, b, thread, chain) for an acquire of b under a
#: when b→a already existed
_violations: list[tuple] = []
_held = threading.local()


class _TrackedLock:
    """A named lock that records acquisition order. Supports the full
    ``threading.Lock`` surface the chain uses (context manager,
    acquire/release with blocking/timeout, locked)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, rlock: bool = False) -> None:
        self.name = name
        self._lock = threading.RLock() if rlock else threading.Lock()

    def _record(self) -> None:
        chain = getattr(_held, "chain", None)
        if chain is None:
            chain = _held.chain = []
        me = self.name
        if chain:
            with _graph_lock:
                for outer in chain:
                    if outer == me:
                        continue
                    if (me, outer) in _edges and (outer, me) not in _edges:
                        _violations.append((
                            outer, me, threading.current_thread().name,
                            tuple(chain),
                        ))
                    _edges.setdefault(
                        (outer, me),
                        (threading.current_thread().name, tuple(chain)),
                    )
        chain.append(me)

    def _unrecord(self) -> None:
        chain = getattr(_held, "chain", None)
        if chain and self.name in chain:
            # remove the LAST occurrence (re-entrant same-name holds)
            for i in range(len(chain) - 1, -1, -1):
                if chain[i] == self.name:
                    del chain[i]
                    break

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._record()
        return got

    def release(self) -> None:
        self._unrecord()
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "_TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


LockLike = Union[threading.Lock, threading.RLock, _TrackedLock]


def make_lock(name: str) -> LockLike:
    """The chain's lock constructor: a plain Lock in production, a
    tracked one under PC_LOCK_DEBUG. `name` is the order-policy identity
    (one name per subsystem lock, shared across instances)."""
    if enabled():
        return _TrackedLock(name)
    return threading.Lock()


def edges() -> dict[tuple, tuple]:
    with _graph_lock:
        return dict(_edges)


def reset() -> None:
    with _graph_lock:
        _edges.clear()
        del _violations[:]


def find_cycle(graph: dict) -> Optional[list]:
    """First cycle in `{node: iterable-of-successors}` as a node list
    whose last element repeats the first ([A, B, A]); None when acyclic.
    Shared by the static checker and the runtime recorder."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {node: WHITE for node in graph}
    stack: list = []

    def dfs(node) -> Optional[list]:
        color[node] = GREY
        stack.append(node)
        for succ in sorted(graph.get(node, ())):
            if color.get(succ, WHITE) == GREY:
                return stack[stack.index(succ):] + [succ]
            if color.get(succ, WHITE) == WHITE:
                found = dfs(succ)
                if found:
                    return found
        stack.pop()
        color[node] = BLACK
        return None

    for node in sorted(graph):
        if color[node] == WHITE:
            found = dfs(node)
            if found:
                return found
    return None


class LockOrderViolation(AssertionError):
    """Raised by check(): the recorded acquisition graph has a cycle."""


def check() -> dict:
    """Assert the runtime-observed graph is acyclic; returns a summary
    dict ({'edges': n, 'nodes': n}) for test assertions/logging."""
    snap = edges()
    with _graph_lock:
        violations = list(_violations)
    graph: dict = {}
    for a, b in snap:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycle = find_cycle(graph)
    if cycle or violations:
        details = []
        if cycle:
            details.append("cycle: " + " -> ".join(cycle))
        for a, b, thread, chain in violations[:8]:
            details.append(
                f"inversion: '{b}' acquired while holding {list(chain)} "
                f"on thread {thread}, but '{b}' -> '{a}' was also observed"
            )
        raise LockOrderViolation(
            "lock-order violation recorded under PC_LOCK_DEBUG:\n  "
            + "\n  ".join(details)
        )
    return {"nodes": len(graph), "edges": len(snap)}
