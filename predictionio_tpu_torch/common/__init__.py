"""Shared HTTP-server configuration: server-key auth and SSL.

Capability parity with the reference ``common/`` module
(common/.../configuration/SSLConfiguration.scala:32-74,
common/.../authentication/KeyAuthentication.scala:34-61).
"""

from predictionio_tpu_torch.common.server_config import (
    KeyAuthentication,
    ServerConfig,
    load_server_config,
)

__all__ = ["KeyAuthentication", "ServerConfig", "load_server_config"]
