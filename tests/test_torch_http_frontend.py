"""The port's event-loop HTTP front end (``predictionio_tpu_torch/server/
http.py``): keep-alive reuse, pipelining, slowloris bounds, TLS, fault
points, and the fds-not-threads idle-connection economics.

The port's copies of every case of ``tests/test_http_frontend.py``, and
of ``tests/test_servers.py``'s ``TestHTTPParserFraming`` and
``TestHTTPFastPathPieces``, run against the port's ``HTTPApp``."""

from __future__ import annotations

import json
import socket
import ssl
import subprocess
import threading
import time
import urllib.request

import pytest

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.server.http import HTTPApp, Response, Router


def _echo_app(**kw) -> HTTPApp:
    router = Router()

    @router.route("GET", "/ping")
    def ping(request):
        return Response.json({"ok": True})

    @router.route("POST", "/echo")
    def echo(request):
        return Response.json({"got": request.body.decode()})

    return HTTPApp(router, host="127.0.0.1", port=0, **kw)


def _get(port: int, sock=None, path="/ping"):
    """One GET over a (possibly reused) raw socket; returns
    (status, body, sock) with the connection left open."""
    if sock is None:
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    sock.sendall(
        f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
    )
    return (*_read_response(sock), sock)


def _read_response(sock, buf: bytearray | None = None) -> tuple[int, bytes]:
    """Parse one response; over-read bytes (a pipelined neighbor's
    response) stay in ``buf`` for the next call."""
    if buf is None:
        buf = bytearray()
    sock.settimeout(10)
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError(f"closed mid-headers: {bytes(buf)!r}")
        buf += chunk
    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
    status = int(head.split()[1])
    clen = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            clen = int(line.split(b":")[1])
    while len(rest) < clen:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("closed mid-body")
        rest += chunk
    buf[:] = rest[clen:]
    return status, rest[:clen]


class TestKeepAliveAndPipelining:
    def test_keep_alive_reuse(self):
        app = _echo_app()
        port = app.start()
        try:
            status, body, sock = _get(port)
            assert status == 200 and json.loads(body) == {"ok": True}
            # same socket, three more requests — the server must not
            # have closed it between requests
            for _ in range(3):
                status, body, sock = _get(port, sock=sock)
                assert status == 200 and json.loads(body) == {"ok": True}
            sock.close()
        finally:
            app.stop()

    def test_pipelined_requests(self):
        """Two requests written back-to-back in one segment both get
        answered, in order, on the same connection (the worker drains
        the parser's buffered bytes before yielding the socket)."""
        app = _echo_app()
        port = app.start()
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            one = b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 1\r\n\r\na"
            two = b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 1\r\n\r\nb"
            sock.sendall(one + two)
            buf = bytearray()
            s1, b1 = _read_response(sock, buf)
            s2, b2 = _read_response(sock, buf)
            assert s1 == 200 and json.loads(b1) == {"got": "a"}
            assert s2 == 200 and json.loads(b2) == {"got": "b"}
            sock.close()
        finally:
            app.stop()

    def test_slowloris_partial_request_times_out(self):
        """A client that trickles half a request line is cut off at
        read_timeout instead of pinning a worker forever."""
        app = _echo_app(read_timeout=0.5)
        port = app.start()
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            sock.sendall(b"GET /pi")  # never finishes the request
            sock.settimeout(5)
            t0 = time.monotonic()
            assert sock.recv(1024) == b"", "server should close the conn"
            assert time.monotonic() - t0 < 4
            sock.close()
            # the server itself is fine
            status, _, s2 = _get(port)
            assert status == 200
            s2.close()
        finally:
            app.stop()

    def test_idle_keep_alive_times_out(self):
        """An idle keep-alive connection (request completed, nothing
        since) is an event-loop timer, and still gets reaped."""
        app = _echo_app(read_timeout=0.5)
        port = app.start()
        try:
            status, _, sock = _get(port)
            assert status == 200
            sock.settimeout(5)
            assert sock.recv(1024) == b"", "idle conn should be reaped"
            sock.close()
        finally:
            app.stop()


class TestFdsNotThreads:
    def test_idle_connections_do_not_hold_threads(self):
        """N idle keep-alive connections park in the selector; the
        process thread count stays bounded by the worker pool, not N."""
        n = 128
        app = _echo_app(handler_threads=8)
        port = app.start()
        socks = []
        try:
            for _ in range(n):
                status, _, sock = _get(port)
                assert status == 200
                socks.append(sock)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if threading.active_count() < 8 + 24:
                    break
                time.sleep(0.05)
            count = threading.active_count()
            assert count < n // 2, (
                f"{count} threads for {n} idle conns — still "
                "thread-per-connection?"
            )
            # parked connections are still live: reuse a sample
            for sock in socks[:: n // 8]:
                status, body, _ = _get(port, sock=sock)
                assert status == 200 and json.loads(body) == {"ok": True}
        finally:
            for sock in socks:
                sock.close()
            app.stop()


class TestTimerWheel:
    def test_call_later_fires_and_cancel_holds(self):
        app = _echo_app()
        app.start()
        try:
            fired = threading.Event()
            handle = app.call_later(0.05, fired.set)
            assert handle is not None
            assert fired.wait(timeout=5)

            never = threading.Event()
            handle2 = app.call_later(0.05, never.set)
            handle2.cancel()
            time.sleep(0.3)
            assert not never.is_set()
        finally:
            app.stop()

    def test_call_later_before_start_returns_none(self):
        app = _echo_app()
        assert app.call_later(0.01, lambda: None) is None


class TestFaultPoints:
    def test_http_accept_fault_is_transient(self):
        """An injected accept failure is swallowed like any transient
        accept error: the listener keeps accepting afterwards."""
        app = _echo_app()
        port = app.start()
        try:
            with faults.injected("http.accept:times=1") as plan:
                # kernel completes the handshake (backlog); the faulted
                # accept drops out and the still-readable listener picks
                # the connection up on the next loop pass
                status, _, sock = _get(port)
                assert status == 200
                sock.close()
            assert plan.fire_count("http.accept") == 1
        finally:
            app.stop()

    def test_http_read_fault_drops_connection_not_server(self):
        app = _echo_app()
        port = app.start()
        try:
            with faults.injected("http.read:times=1") as plan:
                sock = socket.create_connection(
                    ("127.0.0.1", port), timeout=10
                )
                sock.sendall(b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n")
                sock.settimeout(5)
                try:
                    assert sock.recv(1024) == b""
                except OSError:
                    pass  # reset is also an acceptable way to die
                sock.close()
            assert plan.fire_count("http.read") == 1
            status, _, s2 = _get(port)
            assert status == 200
            s2.close()
        finally:
            app.stop()


class TestTLSFrontend:
    def test_tls_keep_alive_and_lazy_handshake(self, tmp_path):
        """TLS conns handshake lazily in a worker (a silent TCP probe
        can't stall the loop) and keep-alive works through the wrap."""
        cert, key = str(tmp_path / "c.pem"), str(tmp_path / "k.pem")
        proc = subprocess.run(
            [
                "openssl", "req", "-x509", "-newkey", "rsa:2048",
                "-keyout", key, "-out", cert, "-days", "1", "-nodes",
                "-subj", "/CN=localhost",
            ],
            capture_output=True,
        )
        if proc.returncode != 0:
            pytest.skip("openssl unavailable")
        srv_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        srv_ctx.load_cert_chain(cert, key)
        app = _echo_app(ssl_context=srv_ctx)
        port = app.start()
        probe = None
        try:
            # a connection that never speaks TLS must not block others
            probe = socket.create_connection(("127.0.0.1", port), timeout=10)
            cli = ssl.create_default_context()
            cli.check_hostname = False
            cli.verify_mode = ssl.CERT_NONE
            raw = socket.create_connection(("127.0.0.1", port), timeout=10)
            tls = cli.wrap_socket(raw, server_hostname="localhost")
            for _ in range(2):  # keep-alive across the TLS session
                status, body, tls = _get(port, sock=tls)
                assert status == 200 and json.loads(body) == {"ok": True}
            tls.close()
        finally:
            if probe is not None:
                probe.close()
            app.stop()


def _get_with_headers(sock, path="/ping") -> tuple[int, dict, bytes]:
    """One GET; returns (status, header dict, body) — the drain tests
    need the Connection header, which _read_response drops."""
    sock.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    sock.settimeout(10)
    buf = bytearray()
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError(f"closed mid-headers: {bytes(buf)!r}")
        buf += chunk
    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(b":")
        headers[k.strip().lower().decode()] = v.strip().decode()
    clen = int(headers.get("content-length", 0))
    while len(rest) < clen:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("closed mid-body")
        rest += chunk
    return status, headers, rest[:clen]


class TestHealthAndReadiness:
    def test_healthz_carries_instance_identity(self):
        app = _echo_app()
        port = app.start()
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            status, _, body = _get_with_headers(sock, "/healthz")
            doc = json.loads(body)
            assert status == 200
            assert doc["instance"] == app.instance_id
            assert doc["pid"] == __import__("os").getpid()
            assert doc["draining"] is False
            sock.close()
        finally:
            app.stop()

    def test_readyz_gated_by_ready_check(self):
        reason = {"why": "warming up"}
        app = _echo_app(ready_check=lambda: reason["why"])
        port = app.start()
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            status, _, body = _get_with_headers(sock, "/readyz")
            assert status == 503
            assert json.loads(body)["reason"] == "warming up"
            reason["why"] = None
            status, _, body = _get_with_headers(sock, "/readyz")
            assert status == 200 and json.loads(body)["ready"] is True
            sock.close()
        finally:
            app.stop()


class TestGracefulDrain:
    def _gated_app(self):
        gate = threading.Event()
        router = Router()

        @router.route("GET", "/slow")
        def slow(request):
            gate.wait(10)
            return Response.json({"ok": True})

        @router.route("GET", "/ping")
        def ping(request):
            return Response.json({"ok": True})

        return HTTPApp(router, host="127.0.0.1", port=0), gate

    def test_inflight_request_completes_with_connection_close(self):
        """A request in flight when drain begins is served normally,
        but the response hands the connection back closed so the
        client's next request reconnects elsewhere."""
        app, gate = self._gated_app()
        port = app.start()
        result = {}

        def bg():
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            result["resp"] = _get_with_headers(sock, "/slow")
            sock.close()

        t = threading.Thread(target=bg)
        t.start()
        time.sleep(0.2)  # the slow request is parked in its handler
        drainer = threading.Thread(target=lambda: app.drain(timeout=10))
        drainer.start()
        time.sleep(0.1)
        gate.set()
        t.join(timeout=10)
        drainer.join(timeout=10)
        assert not drainer.is_alive()
        status, headers, body = result["resp"]
        assert status == 200 and json.loads(body) == {"ok": True}
        assert headers.get("connection") == "close"

    def test_past_deadline_requests_are_shed_503_close(self):
        app, gate = self._gated_app()
        port = app.start()
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            # park the conn with one served request first (keep-alive)
            status, _, _ = _get_with_headers(sock, "/ping")
            assert status == 200
            app.begin_drain(timeout=0)  # deadline passes immediately
            status, headers, body = _get_with_headers(sock, "/ping")
            assert status == 503
            assert headers.get("connection") == "close"
            assert b"draining" in body
            sock.close()
        finally:
            app.stop()

    def test_drain_deadline_bounds_the_wait(self):
        """A handler that never finishes can't hold drain past the
        deadline."""
        app, gate = self._gated_app()
        port = app.start()
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        sock.sendall(b"GET /slow HTTP/1.1\r\nHost: x\r\n\r\n")
        time.sleep(0.2)
        t0 = time.monotonic()
        app.drain(timeout=0.3)
        assert time.monotonic() - t0 < 5.0
        gate.set()
        sock.close()

    def test_new_connections_refused_after_drain_begins(self):
        app, gate = self._gated_app()
        port = app.start()
        try:
            app.begin_drain(timeout=5)
            time.sleep(0.1)  # call_soon(close_listener) lands
            with pytest.raises(OSError):
                socket.create_connection(("127.0.0.1", port), timeout=1)
        finally:
            gate.set()
            app.stop()

    def test_readyz_fails_while_draining_healthz_stays_ok(self):
        app, gate = self._gated_app()
        port = app.start()
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        # second conn opened BEFORE drain (the listener closes with it)
        sock2 = socket.create_connection(("127.0.0.1", port), timeout=10)
        status, _, _ = _get_with_headers(sock, "/readyz")
        assert status == 200
        app.begin_drain(timeout=5)
        status, _, body = _get_with_headers(sock, "/readyz")
        assert status == 503 and json.loads(body)["reason"] == "draining"
        # liveness is NOT readiness: the process is still healthy
        status, _, body = _get_with_headers(sock2, "/healthz")
        assert status == 200 and json.loads(body)["draining"] is True
        sock.close()
        sock2.close()
        app.drain(timeout=0)

    def test_shutdown_hooks_run_exactly_once(self):
        app, gate = self._gated_app()
        ran = []
        app.add_shutdown_hook(lambda: ran.append(1))
        app.start()
        gate.set()
        app.drain(timeout=1)
        app.drain(timeout=1)  # idempotent re-entry
        assert ran == [1]

    def test_drain_fault_point_aborts_before_state_change(self):
        """An injected http.drain fault must surface AND leave the app
        serving (the fault fires before any drain state flips)."""
        app, gate = self._gated_app()
        port = app.start()
        try:
            with faults.injected("http.drain"):
                with pytest.raises(faults.FaultError):
                    app.begin_drain(timeout=5)
            assert not app.draining
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            status, _, _ = _get_with_headers(sock, "/ping")
            assert status == 200  # still accepting and serving
            sock.close()
        finally:
            gate.set()
            app.stop()


class TestHTTPParserFraming:
    """The hand-rolled HTTP/1.1 parser must never desync a keep-alive
    stream: unsupported framings are rejected with Connection: close."""

    def _app(self):
        from predictionio_tpu_torch.server.http import HTTPApp, Response, Router

        router = Router()

        @router.route("POST", "/echo")
        def echo(request):
            return Response.json({"n": len(request.body)})

        return HTTPApp(router, host="127.0.0.1", port=0)

    def test_chunked_request_rejected(self):
        import socket

        app = self._app()
        port = app.start(background=True)
        try:
            s = socket.create_connection(("127.0.0.1", port))
            s.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n"
            )
            assert s.recv(65536).decode().startswith("HTTP/1.1 501")
        finally:
            app.stop()

    def test_negative_content_length_rejected(self):
        import socket

        app = self._app()
        port = app.start(background=True)
        try:
            s = socket.create_connection(("127.0.0.1", port))
            s.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: -5\r\n\r\nhello"
            )
            assert s.recv(65536).decode().startswith("HTTP/1.1 400")
        finally:
            app.stop()

    def test_endless_header_lines_capped(self):
        import socket

        app = self._app()
        port = app.start(background=True)
        try:
            s = socket.create_connection(("127.0.0.1", port))
            s.sendall(b"POST /echo HTTP/1.1\r\n" + b"x: y\r\n" * 300)
            assert s.recv(65536).decode().startswith("HTTP/1.1 431")
        finally:
            app.stop()

    def test_conflicting_duplicate_content_length_rejected(self):
        import socket

        app = self._app()
        port = app.start(background=True)
        try:
            s = socket.create_connection(("127.0.0.1", port))
            s.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: 5\r\nContent-Length: 11\r\n\r\nhello"
            )
            assert s.recv(65536).decode().startswith("HTTP/1.1 400")
        finally:
            app.stop()

    def test_identical_duplicate_content_length_accepted(self):
        import json
        import socket

        app = self._app()
        port = app.start(background=True)
        try:
            s = socket.create_connection(("127.0.0.1", port))
            s.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: 5\r\nContent-Length: 5\r\n\r\nhello"
            )
            raw = s.recv(65536).decode()
            assert raw.startswith("HTTP/1.1 200")
            assert json.loads(raw.split("\r\n\r\n", 1)[1]) == {"n": 5}
        finally:
            app.stop()

    def test_pipelined_request_after_reject_not_parsed(self):
        """A smuggled second request riding behind a rejected framing
        must never be dispatched: the 400 closes the connection and the
        trailing bytes die with it."""
        import socket

        app = self._app()
        port = app.start(background=True)
        try:
            s = socket.create_connection(("127.0.0.1", port))
            s.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: 5\r\nContent-Length: 11\r\n\r\n"
                b"hello"
                b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n"
            )
            raw = s.recv(65536).decode()
            assert raw.startswith("HTTP/1.1 400")
            assert "Connection: close" in raw
            # only the 400 ever comes back; the pipelined request is dead
            assert raw.count("HTTP/1.1") == 1
            s.settimeout(5)
            assert s.recv(65536) == b""  # server closed
        finally:
            app.stop()

    def test_slow_client_read_timeout_frees_connection(self):
        """A client that stalls mid-request is cut loose after
        read_timeout instead of pinning a worker thread forever."""
        import socket
        import time

        from predictionio_tpu_torch.server.http import HTTPApp, Response, Router

        router = Router()

        @router.route("POST", "/echo")
        def echo(request):
            return Response.json({"n": len(request.body)})

        app = HTTPApp(router, host="127.0.0.1", port=0, read_timeout=0.5)
        port = app.start(background=True)
        try:
            s = socket.create_connection(("127.0.0.1", port))
            # headers promise a body that never arrives
            s.sendall(b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 5\r\n\r\n")
            s.settimeout(10)
            start = time.monotonic()
            assert s.recv(65536) == b""  # server dropped us, no response
            assert time.monotonic() - start < 8
            # server is still healthy for well-behaved clients
            s2 = socket.create_connection(("127.0.0.1", port))
            s2.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n\r\nhi"
            )
            assert s2.recv(65536).decode().startswith("HTTP/1.1 200")
        finally:
            app.stop()


class TestHTTPFastPathPieces:
    def test_preencoded_bytes_sent_verbatim(self):
        """Response.json_bytes: the body bytes go out untouched — the
        no-re-encode contract the cache hit path relies on."""
        from predictionio_tpu_torch.server import jsonx
        from predictionio_tpu_torch.server.http import HTTPApp, Response, Router

        payload = jsonx.dumps_bytes({"x": [1, 2, 3], "s": "é"})
        router = Router()
        router.add("GET", "/pre", lambda req: Response.json_bytes(payload))
        app = HTTPApp(router, host="127.0.0.1", port=0)
        port = app.start(background=True)
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/pre", timeout=10
            ) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"].startswith(
                    "application/json"
                )
                assert resp.read() == payload
        finally:
            app.stop()

    def test_rfile_fallback_serves_keep_alive(self):
        """recv_buffer=False pins the stdlib rfile reader (the bench's
        http-floor 'before'); framing and keep-alive must be identical."""
        import http.client

        from predictionio_tpu_torch.server.http import HTTPApp, Response, Router

        router = Router()
        router.add(
            "POST", "/echo",
            lambda req: Response.json({"n": len(req.body)}),
        )
        app = HTTPApp(router, host="127.0.0.1", port=0, recv_buffer=False)
        port = app.start(background=True)
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            for i in range(3):  # same connection: keep-alive holds
                c.request(
                    "POST", "/echo", body=b"x" * (i + 1),
                    headers={"Content-Type": "application/json"},
                )
                r = c.getresponse()
                assert r.status == 200
                assert json.loads(r.read()) == {"n": i + 1}
            c.close()
        finally:
            app.stop()

    def test_conn_reader_matches_rfile_semantics(self):
        """_ConnReader.readline(limit)/read(n) must mirror the buffered
        rfile exactly — it IS the drop-in for the request parser."""
        import socket

        from predictionio_tpu_torch.server.http import _ConnReader

        a, b = socket.socketpair()
        try:
            reader = _ConnReader(a)
            b.sendall(b"hello\nworld")
            assert reader.readline(100) == b"hello\n"
            assert reader.read(5) == b"world"
            # a line longer than limit comes back as exactly limit bytes
            b.sendall(b"abcdefgh")
            b.close()
            assert reader.readline(4) == b"abcd"
            assert reader.readline(100) == b"efgh"  # EOF: remainder
            assert reader.readline(100) == b""
            assert reader.read(3) == b""
        finally:
            a.close()
