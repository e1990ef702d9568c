"""Device operations (kernels, copies, fills) a checkerboard half-step
launches, from the profiler's device events over the traced half-steps.
Layer: colour update.

In mrf-art.offline, moves ``msample_s.art``."""
from bench.readers import halfstep_launches as read  # noqa: F401
