"""Shared utilities (copies of the JAX package's event emitter, telemetry
and JSON-lines helpers)."""
