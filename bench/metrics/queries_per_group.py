"""Queries retired a group started, backfills counted in their group, from
the serving telemetry's query and init spans. Layer: admission queue.

In mrf-penguin.serve-closed, moves ``queries_s``."""
from bench.readers import queries_per_group as read  # noqa: F401
