"""Serving telemetry: the metrics registry and per-request timings."""
