"""Engine Server: deployed-engine query serving (default port 8000).

Port of the per-request path of ``predictionio_tpu/server/engine_server.py``
(reference CreateServer.scala:105-663) on the stdlib
``ThreadingHTTPServer``:

- ``POST /queries.json`` -- deserialize the query via the algorithm's
  query class, ``serving.supplement``, score every algorithm,
  ``serving.serve``, JSON response. Bad queries get 400, failures 500,
  both as ``{"message": ...}``.
- ``GET /`` -- status JSON: engine info, serving stats and the torch
  device the models score on.

Request framing is checked before a body is read, as the JAX package's
parser (``predictionio_tpu/server/http.py``) checks it: a
``Content-Length`` that is not a non-negative integer, or conflicting
duplicates of it (RFC 9112 section 6.3), get 400; a ``Transfer-Encoding``
other than ``identity`` gets 501. Each such answer closes the
connection, so a keep-alive stream never desyncs. A connection whose
read stalls for ``read_timeout`` seconds (a partial request line or
headers, a short body, an idle keep-alive) is closed by the stdlib
handler. More than 100 header lines get the stdlib's own 431.

The micro-batcher, query cache, plugins, feedback loop, SLOs, reload and
multi-variant mounts are later slices.
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.workflow import prepare_deploy
from predictionio_tpu_torch.data.storage import EngineInstance, Storage, get_storage
from predictionio_tpu_torch.server import jsonx

logger = logging.getLogger(__name__)


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


def _query_from_json(query_class: type | None, data: dict[str, Any]) -> Any:
    """JSON -> query object (reference JsonExtractor.extract on
    algo.queryClass, CreateServer.scala:479-485)."""
    if query_class is None:
        return data
    if dataclasses.is_dataclass(query_class):
        names = {f.name for f in dataclasses.fields(query_class)}
        return query_class(**{k: v for k, v in data.items() if k in names})
    return query_class(**data)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


class EngineServer:
    """One deployed engine instance behind an HTTP front end.

    ``device`` is where the models score: CUDA unless ``"cpu"`` is asked
    for (utils/device.py). ``read_timeout``: seconds a connection may
    stall on a read before it is closed (the JAX ``HTTPApp``'s default)."""

    def __init__(
        self,
        engine: Engine,
        instance: EngineInstance,
        storage: Storage | None = None,
        host: str = "0.0.0.0",
        port: int = 8000,
        device: str | torch.device | None = None,
        read_timeout: float = 120.0,
    ):
        self.storage = storage or get_storage()
        self.host = host
        self.port = port
        self.read_timeout = read_timeout
        self.engine = engine
        self.instance = instance
        ctx = WorkflowContext(mode="Serving", batch=instance.batch, device=device)
        self.device = ctx.device
        (self.engine_params, self.algorithms, self.models,
         self.serving) = prepare_deploy(engine, instance, self.storage, ctx)
        self._lock = threading.Lock()
        self.start_time = time.time()
        self.request_count = 0
        self.serving_seconds = 0.0
        self.last_serving_sec = 0.0
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        logger.info(
            "engine instance %s loaded for serving on %s", instance.id, self.device
        )

    # -- query path --------------------------------------------------------
    def handle_query(self, body: dict[str, Any]) -> dict[str, Any]:
        t0 = time.perf_counter()
        query = _query_from_json(self.algorithms[0].query_class, body)
        supplemented = self.serving.supplement(query)
        predictions = [
            a.predict(m, supplemented) for a, m in zip(self.algorithms, self.models)
        ]
        response = _to_jsonable(self.serving.serve(query, predictions))
        dt = time.perf_counter() - t0
        with self._lock:
            self.request_count += 1
            self.serving_seconds += dt
            self.last_serving_sec = dt
        return response

    def status(self) -> dict[str, Any]:
        with self._lock:
            avg = (
                self.serving_seconds / self.request_count
                if self.request_count
                else 0.0
            )
            return {
                "status": "alive",
                "engineInstanceId": self.instance.id,
                "engineFactory": self.instance.engine_factory,
                "engineVariant": self.instance.engine_variant,
                "startTime": self.start_time,
                "requestCount": self.request_count,
                "avgServingSec": round(avg, 6),
                "lastServingSec": round(self.last_serving_sec, 6),
                "device": str(self.device),
                "deviceName": _device_name(self.device),
            }

    # -- lifecycle ---------------------------------------------------------
    def warmup(self) -> int:
        """Score each algorithm's ``warmup_query`` once before the port
        binds: the kernels build and the factor tables go up to the
        device here, not on the first request. A failure raises -- a
        server that cannot score does not start. Returns how many
        algorithms were warmed."""
        warmed = 0
        for a, m in zip(self.algorithms, self.models):
            q = a.warmup_query(m)
            if q is None:
                continue
            t0 = time.perf_counter()
            a.batch_predict(m, [(0, q)])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            logger.info(
                "warmup: %s scored in %.3fs", type(a).__name__,
                time.perf_counter() - t0,
            )
            warmed += 1
        return warmed

    def start(self, background: bool = True) -> int:
        """Bind and serve; returns the bound port (``port=0`` picks a
        free one). ``background=False`` blocks until :meth:`stop`."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), _handler(self))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        logger.info("Engine Server listening on %s:%d", self.host, self.port)
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="engine-server", daemon=True
            )
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def _handler(server: EngineServer) -> type[BaseHTTPRequestHandler]:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # StreamRequestHandler sets it on the socket; handle_one_request
        # closes a connection whose read (or write) times out
        timeout = server.read_timeout

        def setup(self):
            super().setup()
            # headers and body go out as two writes: without NODELAY,
            # Nagle holds the body for the client's delayed ACK (~40 ms)
            self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, payload: bytes, close: bool = False) -> None:
            self.send_response(status)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            if close:  # also sets close_connection
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(payload)

        def _error(self, status: int, message: str, close: bool = False) -> None:
            self._send(status, jsonx.dumps_bytes({"message": message}), close)

        def _body_length(self) -> int | None:
            """The body's length from the framing headers, or None once a
            framing error has been answered (and the connection marked to
            close: the unread body must not be parsed as a request)."""
            # every Transfer-Encoding header, not the first: a chunked one
            # after an identity one still frames the body
            for te in self.headers.get_all("Transfer-Encoding") or ():
                te = te.strip().lower()
                if te and te != "identity":
                    self._error(501, f"Transfer-Encoding {te!r} is not supported",
                                close=True)
                    return None
            values = {v.strip() for v in self.headers.get_all("Content-Length") or ()}
            if len(values) > 1:
                self._error(400, "conflicting Content-Length headers", close=True)
                return None
            try:  # an empty value counts as 0, as in the JAX parser
                length = int(values.pop() or 0) if values else 0
            except ValueError:
                self._error(400, "Content-Length is not an integer", close=True)
                return None
            if length < 0:
                self._error(400, "Content-Length is negative", close=True)
                return None
            return length

        def do_GET(self):
            if self.path.split("?", 1)[0] == "/":
                self._send(200, jsonx.dumps_bytes(server.status()))
            else:
                self._error(404, f"no route for GET {self.path}")

        def do_POST(self):
            length = self._body_length()
            if length is None:
                return
            raw = self.rfile.read(length) if length else b""
            if self.path.split("?", 1)[0] != "/queries.json":
                self._error(404, f"no route for POST {self.path}")
                return
            try:
                body = jsonx.loads(raw) if raw else None
            except (ValueError, UnicodeDecodeError) as e:
                self._error(400, f"request body is not JSON: {e}")
                return
            if not isinstance(body, dict):
                self._error(400, "request body must be a JSON object")
                return
            try:
                payload = jsonx.dumps_bytes(server.handle_query(body))
            except (TypeError, KeyError, ValueError) as e:
                self._error(400, f"Your query is not valid. {e}")
                return
            except Exception as e:
                logger.exception("serving failed")
                self._error(500, f"serving failed: {e}")
                return
            self._send(200, payload)

    return Handler

