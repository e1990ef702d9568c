"""The whole step's share of the H100's peak: the summed least time of
every half-step of the window (bench/roofline.py) over the window's wall
time on the host clock. Layer: MCMC driver. It bounds every kernel's share
from above, whatever runs on the path.

In mrf-art.offline, moves ``msample_s.art``."""
from bench.readers import sweep_mfu as read  # noqa: F401
