"""Readers of the per-layer metrics, one file a metric (or a metric's name up
to its first dot), each with ``read(ctx) -> float | None``."""
