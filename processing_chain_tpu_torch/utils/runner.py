"""Host-side parallel task execution (copy of `ChainError`,
`ParallelRunner` and `shell` from processing_chain_tpu/utils/runner.py).

Parity target: reference lib/cmd_utils.py:42-148. The reference's entire
parallelism engine is a multiprocessing.Pool over ffmpeg shell command
strings (`ParallelRunner`). Here the unit of work is an in-process Python
callable (usually a thin wrapper around native libav calls or a jitted device
function), so we use a thread pool: the native decode/encode paths release
the GIL and device dispatch is async.

Deliberate fixes over the reference (SURVEY.md quirks list — do-not-copy):
  * tasks are kept in an *ordered* dedup'd list, not a set
    (cmd_utils.py:73-79 dedups via set => nondeterministic order);
  * results/exceptions are recorded per task (cmd_utils.py:88-91 has dead
    code after `return` and never stores stdout/stderr);
  * fail-fast cancels not-yet-started tasks but reports the first error with
    its task label.
"""

from __future__ import annotations

import subprocess
import time
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from .. import telemetry as tm
from ..telemetry.heartbeat import HEARTBEATS
from .log import get_logger

logger_ = get_logger

_IN_FLIGHT = tm.gauge(
    "chain_runner_in_flight", "tasks currently executing", ("runner",)
)
_TASK_SECONDS = tm.histogram(
    "chain_task_duration_seconds", "per-task latency", ("runner",)
)


@dataclass
class Task:
    """A schedulable unit of host work."""

    fn: Callable[..., Any]
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    label: str = ""

    def key(self) -> str:
        return self.label or repr((self.fn, self.args, sorted(self.kwargs.items())))


class ChainError(RuntimeError):
    """Raised when any task in a fail-fast batch fails.

    `kind` is the failure-taxonomy surface (docs/SERVE.md "Failure
    taxonomy"): raisers that KNOW whether a failure is worth retrying
    tag it `"transient"` (disk pressure, device unavailable, OOM — the
    same inputs may succeed later) or `"permanent"` (bad params,
    corrupt SRC — retrying burns the attempts budget on a determined
    outcome). `None` means the raiser made no claim; consumers fall
    back to exception-type heuristics (serve/scheduler.classify_failure).

    `src_digest` attributes a `kind="poison"` verdict to the content
    digest of the convicting SRC (docs/ROBUSTNESS.md): the raiser knows
    WHICH file the decoder rejected, so a multi-unit wave failure still
    convicts exactly the right digest — wave packing never decides who
    gets quarantined.
    """

    def __init__(self, *args, kind: Optional[str] = None,
                 src_digest: Optional[str] = None) -> None:
        super().__init__(*args)
        self.kind = kind
        self.src_digest = src_digest


class ParallelRunner:
    """Ordered, dedup'd, fail-fast parallel executor for host tasks."""

    def __init__(self, max_parallel: int = 4, name: str = "runner") -> None:
        self.max_parallel = max(1, int(max_parallel))
        self.name = name
        self._tasks: list[Task] = []
        self._seen: set[str] = set()
        self.results: dict[str, Any] = {}
        self._batch_hb = None  # live batch progress, set per run()

    def add(self, fn: Callable[..., Any], *args: Any, label: str = "", **kwargs: Any) -> None:
        task = Task(fn, args, kwargs, label)
        key = task.key()
        if key in self._seen:
            logger_().debug("%s: duplicate task skipped: %s", self.name, key)
            return
        self._seen.add(key)
        self._tasks.append(task)

    def __len__(self) -> int:
        return len(self._tasks)

    def _call(self, task: Task) -> Any:
        """Worker-side task body with concurrency/latency telemetry (one
        flag check per TASK when disabled — never per item of work)."""
        if not tm.enabled() and not HEARTBEATS.enabled:
            return task.fn(*task.args, **task.kwargs)
        in_flight = _IN_FLIGHT.labels(runner=self.name)
        in_flight.inc()
        hb = HEARTBEATS.register(f"{self.name}:{task.key()}"[:120], kind="task")
        t0 = time.perf_counter()
        try:
            result = task.fn(*task.args, **task.kwargs)
        except BaseException:
            hb.finish("fail")
            raise
        else:
            hb.finish("ok")
            return result
        finally:
            in_flight.dec()
            _TASK_SECONDS.labels(runner=self.name).observe(
                time.perf_counter() - t0
            )
            if self._batch_hb is not None:
                self._batch_hb.beat(advance=1)

    def run(self) -> dict[str, Any]:
        """Run all tasks; raise ChainError on first failure (fail-fast,
        reference cmd_utils.py:97-99 aborts the whole run on any nonzero
        exit). Returns {task key: result}."""
        self.results = {}
        if not self._tasks:
            return self.results
        log = logger_()
        log.debug("%s: running %d tasks, %d-wide", self.name, len(self._tasks), self.max_parallel)
        # batch-level heartbeat: planned = this batch's task count, one
        # beat per completed task — the live per-runner progress + ETA
        self._batch_hb = HEARTBEATS.register(
            self.name, kind="runner", planned=len(self._tasks)
        )
        batch_status = "ok"
        try:
            with ThreadPoolExecutor(max_workers=self.max_parallel) as pool:
                futures = {pool.submit(self._call, t): t for t in self._tasks}
                done, not_done = wait(futures, return_when=FIRST_EXCEPTION)
                first_err: BaseException | None = None
                err_task: Task | None = None
                for fut in done:
                    task = futures[fut]
                    exc = fut.exception()
                    if exc is not None and first_err is None:
                        first_err, err_task = exc, task
                    elif exc is None:
                        self.results[task.key()] = fut.result()
                if first_err is not None:
                    for fut in not_done:
                        fut.cancel()
                    batch_status = "fail"
                    raise ChainError(
                        f"{self.name}: task '{err_task.key()}' failed: {first_err!r}"
                    ) from first_err
        finally:
            self._batch_hb.finish(batch_status)
            self._batch_hb = None
            # batch state is consumed either way: a caller that catches
            # ChainError and retries must not silently re-run the failed
            # batch on top of its new tasks (stale _seen would also
            # dedup-away legitimate resubmissions)
            self._tasks.clear()
            self._seen.clear()
        return self.results


def _stderr_tail(stderr, limit: int = 2000) -> str:
    """Bounded stderr tail for error messages: enough to diagnose, never
    megabytes of encoder spew in an exception repr."""
    text = (stderr or "").strip()
    if isinstance(text, bytes):  # TimeoutExpired may carry bytes
        text = text.decode(errors="replace").strip()
    if len(text) > limit:
        text = "…" + text[-limit:]
    return text


def shell(
    cmd: Sequence[str] | str,
    check: bool = True,
    timeout: Optional[float] = None,
    env: Optional[dict] = None,
    cwd: Optional[str] = None,
) -> subprocess.CompletedProcess:
    """THE subprocess door (chainlint rule `subprocess-hygiene`): every
    external command in the chain goes through here, with LIST argv.

    Only used at the edges (e.g. `git describe` for versioning, the
    backend health probe, the bench child); media work never goes
    through a shell in this framework. `timeout` bounds the child's
    wall time so an edge call can never hang a run (the child is killed
    on expiry), and both failure modes raise ChainError carrying a
    bounded stderr tail instead of an opaque nonzero-exit notice.
    `env`/`cwd` pass through for children that need a pinned platform
    or repo root. The string form exists for historical parity only —
    chain code passes lists (the linter enforces it).
    """
    cmd_text = cmd if isinstance(cmd, str) else " ".join(map(str, cmd))
    try:
        # chainlint: disable=subprocess-hygiene (this IS the port's shell door: the copy of the reference's runner.shell, which the rule allows by path only in the reference package)
        result = subprocess.run(
            cmd,
            shell=isinstance(cmd, str),
            check=False,
            capture_output=True,
            text=True,
            timeout=timeout,
            env=env,
            cwd=cwd,
        )
    except subprocess.TimeoutExpired as exc:
        tail = _stderr_tail(exc.stderr)
        raise ChainError(
            f"command '{cmd_text}' timed out after {timeout}s"
            + (f"; stderr tail: {tail}" if tail else "")
        ) from exc
    if check and result.returncode != 0:
        tail = _stderr_tail(result.stderr)
        raise ChainError(
            f"command '{cmd_text}' failed with exit {result.returncode}"
            + (f"; stderr tail: {tail}" if tail else "")
        )
    return result
