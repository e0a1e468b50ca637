"""JSON encode/decode for the HTTP hot paths: orjson when available,
stdlib fallback, byte-identical output.

orjson's Rust encoder is ~5-10x the stdlib on the small dict payloads
the serving and ingest paths move, but the container image may not ship
it — so every hot-path caller goes through ``dumps_bytes``/``loads``
here and gets whichever backend exists. The fallback is pinned to
orjson's wire format (compact separators, UTF-8 not ``\\uXXXX`` escapes)
so switching backends can never change response bytes — the query cache
stores PRESERIALIZED responses keyed across processes/restarts, and a
byte-stable encoding keeps cached entries and fresh encodes
interchangeable (parity asserted in tests/test_servers.py).

Scope note: orjson rejects NaN/Infinity (encodes as ``null``) while the
stdlib emits bare ``NaN``; framework responses carry finite floats only
(scores pass ``float()`` and top-k masks sentinel values out), so the
difference is unreachable on these paths.
"""

from __future__ import annotations

import json as _json
from typing import Any

try:  # pragma: no cover - exercised only where orjson is installed
    import orjson as _orjson
except ImportError:
    _orjson = None

#: which encoder backs dumps_bytes/loads ("orjson" or "json")
backend = "orjson" if _orjson is not None else "json"


if _orjson is not None:  # pragma: no cover - container has no orjson

    def dumps_bytes(obj: Any) -> bytes:
        """Compact UTF-8 JSON bytes."""
        return _orjson.dumps(obj)

    def loads(data: bytes | str) -> Any:
        return _orjson.loads(data)

else:

    def dumps_bytes(obj: Any) -> bytes:
        """Compact UTF-8 JSON bytes (orjson wire format)."""
        return _json.dumps(
            obj, separators=(",", ":"), ensure_ascii=False
        ).encode("utf-8")

    def loads(data: bytes | str) -> Any:
        return _json.loads(data)
