"""Request framing of the port's engine server
(``predictionio_tpu_torch/server/engine_server.py`` on the port's
``server/http.py`` front end), on the CPU.

The port's copies of the JAX package's framing tests
(``tests/test_servers.py::TestHTTPParserFraming`` and the slowloris /
idle keep-alive tests of ``tests/test_http_frontend.py``), run against the
port's handler over raw sockets: unsupported or conflicting framing is
answered and the connection closed, so a keep-alive stream never
desyncs; a stalled read is cut off at ``read_timeout``. The framing
cases are also sent to the JAX package's ``HTTPApp`` and must get the
same status, headers and body there: a parse reject is answered with an
empty body (``Content-Length: 0``, no ``Content-Type``) by both. Every
socket has its own timeout, so no test can hang.
"""

from __future__ import annotations

import json
import socket
import time

import numpy as np
import pytest

from predictionio_tpu.server.http import HTTPApp, Response, Router
from predictionio_tpu_torch.core.workflow import save_instance
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.models import recommendation as trec
from predictionio_tpu_torch.server.engine_server import EngineServer

QUERY = b'{"user": "a", "num": 2}'


def _server(tmp_path, read_timeout: float = 120.0) -> EngineServer:
    """A started port engine server on a 2-user, 3-item CPU model."""
    storage = tstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    engine = trec.engine()
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 2}}]})
    model = trec.model_from_numpy(["a", "b"], ["x", "y", "z"],
                                  np.ones((2, 2), np.float32), np.eye(3, 2, dtype=np.float32))
    iid = save_instance(engine, ep, [model], engine_id="framing", storage=storage)
    server = EngineServer(engine, storage.get_metadata_engine_instances().get(iid),
                          storage=storage, host="127.0.0.1", port=0, device="cpu",
                          read_timeout=read_timeout)
    server.start(background=True)
    return server


@pytest.fixture()
def port(tmp_path):
    server = _server(tmp_path)
    yield server.port
    server.stop()
    server.storage.close()


@pytest.fixture()
def fast_timeout_port(tmp_path):
    server = _server(tmp_path, read_timeout=0.5)
    yield server.port
    server.stop()
    server.storage.close()


def _connect(port: int) -> socket.socket:
    return socket.create_connection(("127.0.0.1", port), timeout=10)


def _read_response(sock, buf: bytearray) -> tuple[int, dict, bytes]:
    """(status, lower-cased headers, body) of one response; bytes read
    past it (a pipelined neighbour's response) stay in ``buf``."""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError(f"closed mid-headers: {bytes(buf)!r}")
        buf += chunk
    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", 0))
    while len(rest) < n:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("closed mid-body")
        rest += chunk
    buf[:] = rest[n:]
    return int(lines[0].split()[1]), headers, rest[:n]


def _closed(sock, within: float = 5.0) -> bool:
    """The server closed the connection (EOF) within ``within`` seconds."""
    sock.settimeout(within)
    try:
        while True:
            if sock.recv(4096) == b"":
                return True
    except (TimeoutError, socket.timeout):
        return False
    except ConnectionResetError:
        return True


def _post(body: bytes = QUERY, extra: bytes = b"",
          length: bytes | None = None) -> bytes:
    head = b"POST /queries.json HTTP/1.1\r\nHost: x\r\n"
    if length is None:
        length = str(len(body)).encode()
    return head + b"Content-Length: " + length + b"\r\n" + extra + b"\r\n" + body


# (request bytes, status) of the framing cases: the port's answers
FRAMING = {
    "chunked": (b"POST /queries.json HTTP/1.1\r\nHost: x\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n", 501),
    "negative": (_post(b"hello", length=b"-5"), 400),
    "not_an_integer": (_post(b"hello", length=b"abc"), 400),
    "conflicting": (_post(b"hello", length=b"5", extra=b"Content-Length: 11\r\n"), 400),
    # the JAX parser keeps the last header: chunked after identity is chunked
    "identity_then_chunked": (b"POST /queries.json HTTP/1.1\r\nHost: x\r\n"
                              b"Transfer-Encoding: identity\r\n"
                              b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
                              501),
}


@pytest.fixture()
def jax_port():
    """A started JAX-package ``HTTPApp`` with one POST route."""
    router = Router()

    @router.route("POST", "/queries.json")
    def echo(request):
        return Response.json({"n": len(request.body)})

    app = HTTPApp(router, host="127.0.0.1", port=0)
    yield app.start(background=True)
    app.stop()


def _reject(port: int, request: bytes) -> tuple[int, dict, bytes]:
    sock = _connect(port)
    try:
        sock.sendall(request)
        return _read_response(sock, bytearray())
    finally:
        sock.close()


@pytest.mark.parametrize("case", sorted(FRAMING))
def test_bad_framing_is_answered_and_the_connection_closed(port, jax_port, case):
    request, status = FRAMING[case]
    sock = _connect(port)
    try:
        sock.sendall(request)
        got, headers, body = _read_response(sock, bytearray())
        assert got == status
        assert headers.get("connection") == "close"
        assert (headers, body) == _reject(jax_port, request)[1:]
        assert _closed(sock)
    finally:
        sock.close()


@pytest.mark.parametrize("case", sorted(FRAMING))
def test_bad_framing_status_matches_the_jax_parser(port, case):
    router = Router()

    @router.route("POST", "/queries.json")
    def echo(request):
        return Response.json({"n": len(request.body)})

    app = HTTPApp(router, host="127.0.0.1", port=0)
    jax_port = app.start(background=True)
    try:
        statuses = []
        for p in (port, jax_port):
            sock = _connect(p)
            try:
                sock.sendall(FRAMING[case][0])
                statuses.append(_read_response(sock, bytearray())[0])
            finally:
                sock.close()
    finally:
        app.stop()
    assert statuses[0] == statuses[1] == FRAMING[case][1]


def test_identical_duplicate_content_length_accepted(port):
    sock = _connect(port)
    try:
        body = QUERY
        n = str(len(body)).encode()
        sock.sendall(_post(body, length=n, extra=b"Content-Length: " + n + b"\r\n"))
        status, headers, got = _read_response(sock, bytearray())
        assert status == 200
        assert [x["item"] for x in json.loads(got)["itemScores"]] == ["x", "y"]
        assert headers.get("connection") != "close"
    finally:
        sock.close()


@pytest.mark.parametrize("extra", [b"Content-Length: \r\n", b"Transfer-Encoding: \r\n",
                                   b"Transfer-Encoding: identity\r\n"])
def test_empty_or_identity_framing_headers_are_no_framing(port, extra):
    """As in the JAX parser: an empty Content-Length is 0, an empty or
    ``identity`` Transfer-Encoding none."""
    sock = _connect(port)
    try:
        head = b"POST /queries.json HTTP/1.1\r\nHost: x\r\n" + extra
        if not extra.startswith(b"Content-Length"):
            head += b"Content-Length: " + str(len(QUERY)).encode() + b"\r\n"
            body = QUERY
        else:
            body = b""
        sock.sendall(head + b"\r\n" + body)
        status, headers, got = _read_response(sock, bytearray())
        if body:
            assert status == 200
        else:  # no body: the port's "must be a JSON object"
            assert status == 400 and headers.get("connection") != "close"
        sock.sendall(_post())  # the stream is still in step
        assert _read_response(sock, bytearray())[0] == 200
    finally:
        sock.close()


def test_too_many_header_lines_get_431(port):
    """The JAX parser's cap, which the port's front end copies: 256 lines."""
    sock = _connect(port)
    try:
        sock.sendall(b"POST /queries.json HTTP/1.1\r\n" + b"x: y\r\n" * 300)
        status, headers, _ = _read_response(sock, bytearray())
        assert status == 431
        assert headers.get("connection") == "close"
    finally:
        sock.close()


def test_slowloris_partial_request_times_out(fast_timeout_port):
    """Half a request line is cut off at read_timeout instead of holding
    its thread; the server goes on answering."""
    sock = _connect(fast_timeout_port)
    try:
        sock.sendall(b"POST /quer")  # never finishes the request line
        t0 = time.monotonic()
        assert _closed(sock, within=5.0)
        assert time.monotonic() - t0 < 4
    finally:
        sock.close()
    sock = _connect(fast_timeout_port)
    try:
        sock.sendall(_post())
        assert _read_response(sock, bytearray())[0] == 200
    finally:
        sock.close()


def test_partial_headers_and_short_body_time_out(fast_timeout_port):
    for partial in (b"POST /queries.json HTTP/1.1\r\nHost: x\r\nContent-Le",
                    _post(QUERY)[:-3]):
        sock = _connect(fast_timeout_port)
        try:
            sock.sendall(partial)
            t0 = time.monotonic()
            assert _closed(sock, within=5.0)
            assert time.monotonic() - t0 < 4
        finally:
            sock.close()


def test_idle_keep_alive_times_out(fast_timeout_port):
    sock = _connect(fast_timeout_port)
    try:
        sock.sendall(_post())
        status, headers, _ = _read_response(sock, bytearray())
        assert status == 200 and headers.get("connection") != "close"
        assert _closed(sock, within=5.0), "an idle keep-alive must be closed"
    finally:
        sock.close()


def test_pipelined_requests_answered_in_order(port):
    sock = _connect(port)
    try:
        one = _post(b'{"user": "a", "num": 1}')
        two = _post(b'{"user": "b", "num": 3}')
        sock.sendall(one + two)
        buf = bytearray()
        s1, _, b1 = _read_response(sock, buf)
        s2, _, b2 = _read_response(sock, buf)
        assert s1 == s2 == 200
        assert len(json.loads(b1)["itemScores"]) == 1
        assert len(json.loads(b2)["itemScores"]) == 3
    finally:
        sock.close()


def test_keep_alive_serves_after_a_good_request(port):
    sock = _connect(port)
    try:
        buf = bytearray()
        for _ in range(3):
            sock.sendall(_post())
            status, _, body = _read_response(sock, buf)
            assert status == 200
            assert [x["item"] for x in json.loads(body)["itemScores"]] == ["x", "y"]
    finally:
        sock.close()


def test_read_timeout_defaults_to_the_jax_apps(tmp_path):
    import inspect

    default = inspect.signature(EngineServer).parameters["read_timeout"].default
    assert default == inspect.signature(HTTPApp).parameters["read_timeout"].default == 120.0
