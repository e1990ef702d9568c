"""The whole step's share of the H100's peak: the summed least time of
every colour update of the window (bench/roofline_bn.py, from the net's
real cardinalities and children) over the window's wall time on the host
clock. Layer: MCMC driver. It bounds every kernel's share from above,
whatever runs on the path.

In bn-munin-scale.offline, moves ``msample_s.penguin``."""
from bench.readers import sweep_mfu as read  # noqa: F401
