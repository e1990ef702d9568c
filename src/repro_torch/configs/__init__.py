"""Workload configs of the port (plain dataclasses, no framework)."""
