"""Offline tooling: scene inspection and validation (tools/inspector.py)."""
