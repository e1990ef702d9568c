"""The served rounds' share of the H100's peak: the summed least time
(bench/roofline.py) of every half-step the fused kernel ran in the window,
by its launch counter's shapes, over the window's wall time. Layer: engine
and round runner. It bounds every kernel's share from above.

In mrf-penguin.serve-closed, moves ``queries_s``."""
from bench.readers import round_mfu as read  # noqa: F401
