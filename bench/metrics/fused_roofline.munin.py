"""Share of the H100's roofline the fused sweep kernel reaches on the BN
colour updates: the summed least time of the traced updates' sample stage
(bench/roofline_bn.py: each lane's real cardinality, never the padded L)
over fused_gibbs_group_kernel's device time, from the profiler. Layer:
fused kernel.

In bn-munin-scale.offline, moves ``msample_s.penguin``."""
from bench.readers import fused_roofline_served as read  # noqa: F401
