"""Share of the chain lanes of the rounds run that belonged to a live
query, weighted by sweeps, from the serving telemetry's round spans. Layer:
engine and round runner.

In mrf-penguin.serve-closed, moves ``queries_s``."""
from bench.readers import lane_occupancy as read  # noqa: F401
