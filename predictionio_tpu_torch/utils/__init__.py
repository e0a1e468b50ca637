"""Shared utilities (device selection)."""
