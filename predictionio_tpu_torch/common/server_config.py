"""server.conf parsing, key authentication, and SSL context construction.

Capability parity with the reference's shared HTTP-server config:

- **Key auth** — the dashboard and the engine server's ``/stop`` /
  ``/reload`` endpoints are guarded by a server-wide access key passed as
  the ``accessKey`` query param, enforced only when
  ``key-auth-enforced`` is true (KeyAuthentication.scala:34-61).
- **SSL** — servers can terminate TLS themselves
  (SSLConfiguration.scala:32-74). The reference loads a JKS keystore;
  the Python-native equivalent is a PEM cert/key pair loaded into an
  ``ssl.SSLContext`` (``ssl-certfile`` / ``ssl-keyfile`` replace
  ``ssl-keystore-resource`` / ``ssl-key-alias``).

The config file mirrors ``conf/server.conf``: a
``org.apache.predictionio.server`` block of ``key = "value"`` entries.
Both the reference's HOCON block style and flat
``org.apache.predictionio.server.key=value`` lines parse.
"""

from __future__ import annotations

import re
import ssl
from dataclasses import dataclass, field

CONFIG_PREFIX = "org.apache.predictionio.server"


def _parse_conf(text: str) -> dict[str, str]:
    """Parse the HOCON-subset server.conf into flat dotted keys."""
    out: dict[str, str] = {}
    prefix_stack: list[str] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        m = re.match(r"^([\w.\-]+)\s*\{$", line)
        if m:
            prefix_stack.append(m.group(1))
            continue
        if line == "}":
            if prefix_stack:
                prefix_stack.pop()
            continue
        m = re.match(r"^([\w.\-]+)\s*=\s*(.*)$", line)
        if m:
            key = ".".join(prefix_stack + [m.group(1)])
            value = m.group(2).strip().strip('"')
            out[key] = value
    return out


def _get_bool(conf: dict[str, str], key: str, default: bool = False) -> bool:
    return conf.get(key, str(default)).strip().lower() in ("true", "1", "yes")


@dataclass
class ServerConfig:
    """Server-wide auth + SSL settings shared by all HTTP servers."""

    key_auth_enforced: bool = False
    access_key: str = ""
    ssl_enforced: bool = False
    ssl_certfile: str | None = None
    ssl_keyfile: str | None = None
    ssl_keyfile_password: str | None = None
    extras: dict[str, str] = field(default_factory=dict)

    def ssl_context(self) -> ssl.SSLContext | None:
        """Server-side TLS context from the PEM pair (the JKS-keystore
        analog, SSLConfiguration.scala:41-62). None when SSL is off."""
        if not self.ssl_enforced:
            return None
        if not self.ssl_certfile or not self.ssl_keyfile:
            raise ValueError(
                "ssl-enforced is true but ssl-certfile/ssl-keyfile are not set"
            )
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.minimum_version = ssl.TLSVersion.TLSv1_2
        context.load_cert_chain(
            certfile=self.ssl_certfile,
            keyfile=self.ssl_keyfile,
            password=self.ssl_keyfile_password,
        )
        return context


def load_server_config(path: str | None = None, text: str | None = None) -> ServerConfig:
    """Load a server.conf; missing file/keys fall back to defaults
    (auth and SSL both off — the reference template's defaults)."""
    if text is None:
        if path is None:
            return ServerConfig()
        try:
            with open(path) as f:
                text = f.read()
        except FileNotFoundError:
            return ServerConfig()
    conf = _parse_conf(text)
    p = CONFIG_PREFIX
    known = {
        f"{p}.key-auth-enforced",
        f"{p}.accessKey",
        f"{p}.ssl-enforced",
        f"{p}.ssl-certfile",
        f"{p}.ssl-keyfile",
        f"{p}.ssl-keyfile-pass",
    }
    return ServerConfig(
        key_auth_enforced=_get_bool(conf, f"{p}.key-auth-enforced"),
        access_key=conf.get(f"{p}.accessKey", ""),
        ssl_enforced=_get_bool(conf, f"{p}.ssl-enforced"),
        ssl_certfile=conf.get(f"{p}.ssl-certfile"),
        ssl_keyfile=conf.get(f"{p}.ssl-keyfile"),
        ssl_keyfile_password=conf.get(f"{p}.ssl-keyfile-pass"),
        extras={k: v for k, v in conf.items() if k not in known},
    )


class KeyAuthentication:
    """Query-param server-key check (KeyAuthentication.scala:44-61):
    authorized when auth is not enforced or ``accessKey`` matches."""

    def __init__(self, config: ServerConfig):
        self.config = config

    def authorized(self, query: dict[str, str]) -> bool:
        if not self.config.key_auth_enforced:
            return True
        return query.get("accessKey") == self.config.access_key
