"""Live status surface: HTTP endpoint + atomically-rewritten status file
(copy of processing_chain_tpu/telemetry/live.py).

`LiveServer` is a stdlib `ThreadingHTTPServer` (no new dependencies)
exposing read-only endpoints while a run is in flight — and, since the
serve daemon (serve/), a *route registry* so every HTTP surface of the chain shares this one server:

    /healthz   liveness: {"status": "ok", "uptime_s": ...}
    /metrics   MetricsRegistry.render_prometheus(), LIVE — the same
               format the post-run metrics_<ts>.prom persists
    /status    JSON: per-stage progress + ETA, in-flight tasks with
               beat ages, chain counters, resources (schema below)

Additional routes (e.g. chain-serve's `/v1/requests`,
`/v1/artifacts/<key>`) register on a `RouteRegistry` — exact paths or
prefixes, per-method — instead of forking a second server with its own
port, thread and shutdown story. Handlers receive a `WebRequest`
(method/path/query/body) and return `(code, content_type, body)` where
body may be `str` or `bytes`.

`StatusFileWriter` rewrites the same /status JSON to a file every
`interval_s` atomically (utils/fsio), so a reader (tools chain-top, a
cron probe) never observes a torn write — the headless twin of the
endpoint for hosts with no reachable port.

Status document schema (docs/TELEMETRY.md "Live monitoring"):

    {"schema": 1, "pid": ..., "generated_at": epoch, "uptime_s": ...,
     "run": {...},                        # run meta set by the caller
     "stages": {stage: {state, jobs_done, jobs_planned?, progress?,
                        eta_s?, wall_s, items?}},
     "current_stage": ..., "tasks": [...], "recent": [...],
     "counters": {frames_decoded, frames_encoded, bytes_encoded},
     "resources": {...}}                  # profiling.sample_resources()

Subsystems can contribute their own top-level sections through
`STATUS_PROVIDERS` (name -> callable(query) -> dict): chain-serve adds a
"serve" section, scopable per request via `/status?request=<id>`.

Binding defaults to 127.0.0.1 (an operator forwarding the port owns the
exposure decision); PC_LIVE_HOST overrides.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import BinaryIO, Callable, Dict, Optional, Tuple, Union
from urllib.parse import parse_qsl, urlsplit

from ..utils import lockdebug
from ..utils.fsio import atomic_write_json
from ..utils.log import get_logger
from .heartbeat import HEARTBEATS
from .metrics import REGISTRY

_T0 = time.monotonic()

#: Extra /status sections: name -> callable(query: dict) -> dict | None.
#: A provider that raises or returns None is skipped — /status must
#: render on every platform no matter what a subsystem is doing.
STATUS_PROVIDERS: Dict[str, Callable[[dict], Optional[dict]]] = {}

#: POST bodies past this are refused (413): every legitimate request
#: document is a few KB of IDs; anything bigger is a mistake or abuse.
_MAX_BODY = 1 << 20


#: Mutable run metadata merged into /status. Guarded by _RUN_META_LOCK:
#: the caller replaces it via set_run_meta() while a StatusFileWriter tick
#: or an HTTP /status handler may be snapshotting it from another thread.
RUN_META: dict = {}
_RUN_META_LOCK = threading.Lock()


def set_run_meta(**meta) -> None:
    """Replace the run metadata atomically."""
    with _RUN_META_LOCK:
        RUN_META.clear()
        RUN_META.update(meta)


def _run_meta_snapshot() -> dict:
    with _RUN_META_LOCK:
        return dict(RUN_META)


def build_status(query: Optional[dict] = None) -> dict:
    """One JSON-able status document from the live registries."""
    doc = {
        "schema": 1,
        "pid": os.getpid(),
        "generated_at": round(time.time(), 3),
        "uptime_s": round(time.monotonic() - _T0, 3),
        "run": _run_meta_snapshot(),
    }
    doc.update(HEARTBEATS.snapshot())
    from . import BYTES_ENCODED, FRAMES_DECODED, FRAMES_ENCODED

    doc["counters"] = {
        "frames_decoded": FRAMES_DECODED.get(),
        "frames_encoded": FRAMES_ENCODED.get(),
        "bytes_encoded": BYTES_ENCODED.get(),
    }
    # current resources (RSS, pool bytes, queue depths, card memory) ride
    # every status document even when the full profile monitor is off, so
    # chain-top can show memory on any live run; one cheap /proc + stats()
    # sweep that never initialises CUDA
    try:
        from . import profiling

        doc["resources"] = profiling.sample_resources()
    except Exception:  # noqa: BLE001 - /status must render on every platform
        pass
    for name, provider in list(STATUS_PROVIDERS.items()):
        try:
            section = provider(query or {})
        except Exception:  # noqa: BLE001 - a broken provider must not kill /status
            continue
        if section is not None:
            doc[name] = section
    return doc


# --------------------------------------------------------------- routing


@dataclass
class WebRequest:
    """What a route handler sees: enough to act, nothing http.server."""

    method: str
    path: str                     # decoded path, query stripped
    query: dict = field(default_factory=dict)
    body: bytes = b""
    headers: dict = field(default_factory=dict)  # lowercased names


@dataclass
class FileBody:
    """A response body streamed from disk in chunks instead of being
    materialized in memory — artifact downloads are video-scale, and an
    always-on daemon answering several concurrent multi-GB GETs with
    f.read() would OOM on exactly the load it exists to serve.

    Handlers that race a deleter (the serve GC pressure hook can evict
    an artifact between the handler's check and the reply's streaming
    loop) should open the file themselves and pass `fileobj`: the open
    descriptor keeps the bytes alive for the whole response even if the
    path is unlinked mid-stream. `_reply` closes it either way.

    `on_first_byte` fires after the response headers are on the wire —
    the closest observable to the client's TTFB without kernel help —
    and `on_complete(sent_bytes, ok)` fires exactly once when the
    stream ends, with `ok=False` on a disconnect or disk failure.
    Callback exceptions are swallowed: observability hooks must never
    break the stream they time."""

    path: str
    fileobj: Optional[BinaryIO] = None
    #: single-range serving (RFC 9110 `Range: bytes=…` → 206): seek to
    #: `offset` and stream exactly `length` bytes. Defaults stream the
    #: whole file; `length` also serves as the Content-Length when set,
    #: so handlers can bound a stream without a second fstat
    offset: int = 0
    length: Optional[int] = None
    on_first_byte: Optional[Callable[[], None]] = None
    on_complete: Optional[Callable[[int, bool], None]] = None


#: handler signature: WebRequest -> (status code, content type, body)
#: or (code, content type, body, extra-headers dict) — the 4-tuple form
#: lets a handler attach response headers (ETag, Cache-Control) without
#: the registry growing a second dispatch path
Handler = Callable[[WebRequest], Tuple[int, str, Union[str, bytes, FileBody]]]


class RouteRegistry:
    """Exact-path and prefix routes with per-method dispatch. Thread-safe:
    subsystems register while the server is already answering scrapes."""

    def __init__(self) -> None:
        self._lock = lockdebug.make_lock("live_routes")
        self._exact: dict[str, dict[str, Handler]] = {}  # guarded-by: _lock
        #: longest-prefix-first [(prefix, {method: handler})]
        self._prefix: list[tuple[str, dict[str, Handler]]] = []  # guarded-by: _lock

    def add(self, path: str, handler: Handler,
            methods: tuple = ("GET",)) -> None:
        with self._lock:
            entry = self._exact.setdefault(path, {})
            for m in methods:
                entry[m.upper()] = handler

    def add_prefix(self, prefix: str, handler: Handler,
                   methods: tuple = ("GET",)) -> None:
        with self._lock:
            for p, entry in self._prefix:
                if p == prefix:
                    for m in methods:
                        entry[m.upper()] = handler
                    return
            self._prefix.append((prefix, {m.upper(): handler for m in methods}))
            self._prefix.sort(key=lambda e: -len(e[0]))

    def resolve(self, method: str, path: str
                ) -> tuple[Optional[Handler], Optional[set]]:
        """(handler, None) on a match; (None, allowed-methods) when the
        path exists under another method (405); (None, None) for 404."""
        with self._lock:
            entry = self._exact.get(path)
            if entry is None:
                for prefix, e in self._prefix:
                    if path.startswith(prefix):
                        entry = e
                        break
        if entry is None:
            return None, None
        handler = entry.get(method.upper())
        if handler is None:
            return None, set(entry)
        return handler, None

    def paths(self) -> list[str]:
        with self._lock:
            return sorted(self._exact) + sorted(
                p + "…" for p, _ in self._prefix
            )


def _healthz(req: WebRequest):
    return 200, "application/json", json.dumps({
        "status": "ok",
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _T0, 3),
    })


def _metrics(req: WebRequest):
    return 200, "text/plain; version=0.0.4", REGISTRY.render_prometheus()


def _status(req: WebRequest):
    return 200, "application/json", json.dumps(build_status(req.query))


def default_routes() -> RouteRegistry:
    """A fresh registry holding the built-in observability endpoints —
    the base every LiveServer (batch run or serve daemon) starts from."""
    routes = RouteRegistry()
    routes.add("/healthz", _healthz)
    routes.add("/metrics", _metrics)
    routes.add("/status", _status)
    return routes


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the route registry for its handlers."""

    daemon_threads = True

    def __init__(self, addr, routes: RouteRegistry) -> None:
        super().__init__(addr, _Handler)
        self.routes = routes

    def handle_error(self, request, client_address) -> None:
        # in-flight handlers racing stop() hit closed sockets; that is a
        # shutdown artifact, not a report — never traceback-spam stderr
        pass


class _Handler(BaseHTTPRequestHandler):
    server_version = "chain-live/2"

    def _dispatch(self, method: str) -> None:
        split = urlsplit(self.path)
        path = split.path
        handler, allowed = self.server.routes.resolve(method, path)
        if handler is None:
            if allowed:
                self.send_response(405)
                self.send_header("Allow", ", ".join(sorted(allowed)))
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self._reply(404, "text/plain",
                        "not found: try /healthz /metrics /status\n")
            return
        body = b""
        if method == "POST":
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if length > _MAX_BODY:
                self._reply(413, "application/json",
                            json.dumps({"error": "body too large"}))
                return
            body = self.rfile.read(length) if length else b""
        req = WebRequest(
            method=method, path=path,
            query=dict(parse_qsl(split.query)), body=body,
            headers={k.lower(): v for k, v in self.headers.items()},
        )
        extra: Optional[dict] = None
        try:
            result = handler(req)
            if len(result) == 4:
                code, ctype, payload, extra = result
            else:
                code, ctype, payload = result
        except Exception as exc:  # noqa: BLE001 - one bad handler must not kill the surface
            code, ctype, payload = 500, "application/json", json.dumps(
                {"error": repr(exc)[:300]}
            )
        self._reply(code, ctype, payload, extra)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        self._dispatch("POST")

    def do_DELETE(self) -> None:  # noqa: N802 - http.server API
        self._dispatch("DELETE")

    @staticmethod
    def _fire(cb, *args) -> None:
        # FileBody callbacks are observability hooks (read-path SLO
        # timers, the heat ledger); a broken one must not truncate the
        # stream it is supposed to time
        if cb is None:
            return
        try:
            cb(*args)
        except Exception:  # noqa: BLE001
            get_logger().warning("live: body callback failed",
                                 exc_info=True)

    def _reply(self, code: int, ctype: str,
               body: Union[str, bytes, FileBody],
               extra: Optional[dict] = None) -> None:
        try:
            if isinstance(body, FileBody):
                sent = 0
                ok = False
                f = body.fileobj
                try:
                    if f is None:
                        f = open(body.path, "rb")
                    if body.length is not None:
                        size = body.length
                    else:
                        size = max(
                            0,
                            os.fstat(f.fileno()).st_size - body.offset)
                    if body.offset:
                        f.seek(body.offset)
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(size))
                    for name, value in (extra or {}).items():
                        self.send_header(name, value)
                    self.end_headers()
                    self._fire(body.on_first_byte)
                    remaining = size
                    while remaining > 0:
                        chunk = f.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        sent += len(chunk)
                        remaining -= len(chunk)
                    ok = remaining == 0
                finally:
                    if f is not None:
                        f.close()
                    self._fire(body.on_complete, sent, ok)
                return
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for name, value in (extra or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            # impatient curl, or a handler racing stop()'s socket close
            pass
        except OSError:
            # NOT a client disconnect: disk trouble mid-stream, or a
            # FileBody path deleted before the handler pinned an fd —
            # the client got a truncated/empty response; say so.
            get_logger().warning(
                "live: reply for %s failed mid-stream", self.path,
                exc_info=True,
            )

    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        pass  # never spam the chain's console per scrape


class LiveServer:
    """Threaded HTTP server on a daemon thread. Port 0 binds an
    ephemeral port; `.port` is the bound one either way. `routes`
    defaults to the built-in observability endpoints; callers that need
    more (the serve daemon) pass `default_routes()` plus their own."""

    def __init__(self, port: int, host: Optional[str] = None,
                 routes: Optional[RouteRegistry] = None) -> None:
        self.host = host or os.environ.get("PC_LIVE_HOST", "127.0.0.1")
        self.routes = routes if routes is not None else default_routes()
        self._server = _Server((self.host, port), self.routes)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LiveServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="chain-live-http", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            # shutdown() blocks on the serve_forever loop acknowledging;
            # only meaningful (or safe) when the loop is actually running
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=2.0)
            self._thread = None
        else:
            self._server.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "LiveServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def write_status_file(path: str) -> str:
    """One atomic rewrite (utils/fsio): readers see the old document or the
    new one, never a torn half-write."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_write_json(path, build_status(), sort_keys=True)
    return path


class StatusFileWriter:
    """Periodic atomic status-file rewriter for headless runs (no port
    reachable). `stop()` writes one final snapshot so the file's last
    state reflects the run's end, not its second-to-last tick."""

    def __init__(self, path: str, interval_s: float = 2.0) -> None:
        self.path = path
        self.interval_s = max(0.2, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                write_status_file(self.path)
            except OSError:  # a transiently-full disk must not kill the run
                pass

    def start(self) -> "StatusFileWriter":
        if self._thread is None:
            write_status_file(self.path)  # visible immediately, not at t+interval
            self._thread = threading.Thread(
                target=self._loop, name="chain-status-file", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        try:
            write_status_file(self.path)
        except OSError:
            pass
