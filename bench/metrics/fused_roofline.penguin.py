"""Share of the H100's roofline the fused sweep kernel reaches: the
half-step's least time (bench/roofline.py) over the device time of one
launch of fused_gibbs_group_kernel, from the profiler. Layer: fused kernel.

In mrf-penguin.offline, moves ``msample_s.penguin``."""
from bench.readers import fused_roofline as read  # noqa: F401
