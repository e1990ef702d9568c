"""Median wait of a served query from submit to admission into a group,
from the serving telemetry's wait spans. Layer: admission queue.

In mrf-penguin.serve-closed, moves ``queries_s``."""
from bench.readers import queue_wait_ms as read  # noqa: F401
