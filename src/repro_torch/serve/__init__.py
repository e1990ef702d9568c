"""Posterior query service: queries, plan cache, telemetry, the engine
and its batch CLI (Bayesian-network family)."""
