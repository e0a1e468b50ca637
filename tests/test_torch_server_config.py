"""server.conf / key-auth / SSL config of the port
(``predictionio_tpu_torch/common/server_config.py``; reference common
module: SSLConfiguration.scala, KeyAuthentication.scala,
conf/server.conf), and the engine server's guard on its control
endpoints (``/stop``, and ``/reload``, which the fleet supervisor's
retrain scheduler calls).

The port's copy of ``tests/test_server_config.py``: ``TestParsing``,
``TestKeyAuthentication``, ``TestSSL`` and
``TestEngineServerControlAuth``, with each parse also held to the JAX
package's. ``TestDashboardAuth`` waits for the dashboard (ROADMAP.md
queue 1, item 10c)."""

import ssl
import subprocess

import pytest

from predictionio_tpu.common import load_server_config as jax_load_server_config
from predictionio_tpu_torch.common import (
    KeyAuthentication,
    ServerConfig,
    load_server_config,
)

HOCON = """
# comment
org.apache.predictionio.server {
  key-auth-enforced = "true"
  accessKey = "sekrit"
  ssl-enforced = "false"
}
"""

FLAT = """
org.apache.predictionio.server.key-auth-enforced=true
org.apache.predictionio.server.accessKey=flatkey
"""


class TestParsing:
    def test_hocon_block(self):
        cfg = load_server_config(text=HOCON)
        assert cfg.key_auth_enforced is True
        assert cfg.access_key == "sekrit"
        assert cfg.ssl_enforced is False

    def test_flat_keys(self):
        cfg = load_server_config(text=FLAT)
        assert cfg.key_auth_enforced is True
        assert cfg.access_key == "flatkey"

    def test_missing_file_defaults(self, tmp_path):
        cfg = load_server_config(path=str(tmp_path / "nope.conf"))
        assert cfg.key_auth_enforced is False
        assert cfg.access_key == ""
        assert cfg.ssl_context() is None

    def test_file_roundtrip(self, tmp_path):
        p = tmp_path / "server.conf"
        p.write_text(HOCON)
        assert load_server_config(path=str(p)).access_key == "sekrit"

    @pytest.mark.parametrize("text", [HOCON, FLAT, "", "junk = 1\n"])
    def test_same_config_as_the_jax_package(self, text):
        ours, theirs = load_server_config(text=text), jax_load_server_config(text=text)
        assert vars(ours) == vars(theirs)


class TestKeyAuthentication:
    def test_not_enforced_allows_all(self):
        auth = KeyAuthentication(ServerConfig())
        assert auth.authorized({}) is True

    def test_enforced_requires_match(self):
        auth = KeyAuthentication(
            ServerConfig(key_auth_enforced=True, access_key="k1")
        )
        assert auth.authorized({"accessKey": "k1"}) is True
        assert auth.authorized({"accessKey": "nope"}) is False
        assert auth.authorized({}) is False


class TestSSL:
    def test_enforced_without_files_raises(self):
        with pytest.raises(ValueError):
            ServerConfig(ssl_enforced=True).ssl_context()

    def test_context_from_self_signed_pem(self, tmp_path):
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
        ctx = ServerConfig(
            ssl_enforced=True, ssl_certfile=cert, ssl_keyfile=key
        ).ssl_context()
        assert isinstance(ctx, ssl.SSLContext)
        assert ctx.minimum_version == ssl.TLSVersion.TLSv1_2


class TestEngineServerControlAuth:
    def test_enforced_empty_key_still_blocks(self):
        """key-auth-enforced=true with accessKey unset must not silently
        disable /stop auth (a request without the param is rejected)."""
        from predictionio_tpu_torch.server.engine_server import EngineServer
        from predictionio_tpu_torch.server.http import Request

        server = EngineServer.__new__(EngineServer)
        server.server_config = ServerConfig(key_auth_enforced=True, access_key="")
        server.server_key = None
        assert server._auth_control(Request("POST", "/stop", {}, {}, b"")) is False
        ok = Request("POST", "/stop", {"accessKey": ""}, {}, b"")
        assert server._auth_control(ok) is True

    @pytest.mark.parametrize("path", ["/stop", "/reload"])
    @pytest.mark.parametrize("conf,key,query,allowed", [
        (ServerConfig(), None, {}, True),
        (ServerConfig(key_auth_enforced=True, access_key="k1"), None, {}, False),
        (ServerConfig(key_auth_enforced=True, access_key="k1"), None,
         {"accessKey": "k1"}, True),
        (ServerConfig(), "sk", {}, False),
        (ServerConfig(), "sk", {"accessKey": "sk"}, True),
    ])
    def test_control_guard_equals_the_jax_servers(self, path, conf, key, query, allowed):
        """The guard of /stop and /reload: the server.conf key when it is
        enforced, else the server's own key, else open; the same answer
        as the JAX package's engine server."""
        from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
        from predictionio_tpu.server.http import Request as JaxRequest
        from predictionio_tpu_torch.server.engine_server import EngineServer
        from predictionio_tpu_torch.server.http import Request

        ours = EngineServer.__new__(EngineServer)
        theirs = JaxEngineServer.__new__(JaxEngineServer)
        for server in (ours, theirs):
            server.server_config = conf
            server.server_key = key
        assert ours._auth_control(Request("POST", path, dict(query), {}, b"")) is allowed
        assert theirs._auth_control(JaxRequest("POST", path, dict(query), {}, b"")) is allowed
