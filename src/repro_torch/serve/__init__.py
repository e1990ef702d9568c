"""Posterior query service: queries, plan cache, telemetry, the engine
(all three model families), its admission queue and scheduling policy
(``queue``, ``sched``), the wire service (``protocol``, ``worker``,
``server``, ``client``) and the CLI (batch, stream, serve and connect
modes)."""
