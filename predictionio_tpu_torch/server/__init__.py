"""Serving: the engine server (``POST /queries.json``)."""
