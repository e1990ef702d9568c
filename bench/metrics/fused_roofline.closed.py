"""Share of the H100's roofline the fused sweep kernel reaches on the
served half-steps: their summed least time (bench/roofline.py, by the
launch counter's shapes) over fused_gibbs_group_kernel's device time, from
the profiler. Layer: fused kernel.

In mrf-penguin.serve-closed, moves ``queries_s``."""
from bench.readers import fused_roofline_served as read  # noqa: F401
