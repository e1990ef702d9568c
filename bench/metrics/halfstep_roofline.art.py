"""Share of the H100's roofline a half-step reaches: its least time
(bench/roofline.py, from the cell's shapes) over the device time of every
operation in it, from the profiler. Layer: colour update.

In mrf-art.offline, moves ``msample_s.art``."""
from bench.readers import halfstep_roofline as read  # noqa: F401
