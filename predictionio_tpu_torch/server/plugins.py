"""Server plugin interfaces and discovery.

Parity with the reference's ServiceLoader-based plugin systems:
- EventServerPlugin (inputblocker/inputsniffer): intercepts events at
  ingestion (data/.../api/EventServerPlugin.scala),
- EngineServerPlugin (outputblocker/outputsniffer): transforms or
  observes query responses (core/.../workflow/EngineServerPlugin.scala).

Java ServiceLoader discovery becomes dotted-name loading from the
``PIO_PLUGINS`` env var (comma-separated ``module:Class`` or
``module.Class``) plus programmatic registration.
"""

from __future__ import annotations

import importlib
import logging
import os
from typing import Any

logger = logging.getLogger(__name__)

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"
OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


class EventServerPlugin:
    """Override ``process`` (blockers may raise to reject, return a
    modified event dict to rewrite) and/or ``handle_rest``."""

    plugin_name = "plugin"
    plugin_description = ""
    plugin_type = INPUT_SNIFFER

    def start(self, context: dict[str, Any]) -> None: ...

    def process(self, event_json: dict[str, Any], context: dict[str, Any]):
        return event_json

    def handle_rest(self, path: str, params: dict[str, str]) -> Any:
        return {}


class EngineServerPlugin:
    plugin_name = "plugin"
    plugin_description = ""
    plugin_type = OUTPUT_SNIFFER

    def start(self, context: dict[str, Any]) -> None: ...

    def process(
        self,
        engine_variant: str,
        query: dict[str, Any],
        result: Any,
        context: dict[str, Any],
    ):
        return result

    def handle_rest(self, arguments: dict[str, Any]) -> Any:
        return {}


def load_plugins(base_class: type, env_var: str = "PIO_PLUGINS") -> list[Any]:
    """Instantiate plugins of the given kind named in ``env_var``."""
    plugins: list[Any] = []
    spec = os.environ.get(env_var, "")
    for entry in filter(None, (s.strip() for s in spec.split(","))):
        module_name, _, attr = entry.replace(":", ".").rpartition(".")
        try:
            cls = getattr(importlib.import_module(module_name), attr)
        except Exception:
            logger.exception("cannot load plugin %s", entry)
            continue
        if isinstance(cls, type) and issubclass(cls, base_class):
            plugins.append(cls())
        else:
            logger.warning("%s is not a %s; skipped", entry, base_class.__name__)
    return plugins
