"""Share of the traced window in which no operation ran on the device, from
the profiler. Layer: device.

In bn-munin-scale.offline, moves ``msample_s.penguin``."""
from bench.readers import device_idle as read  # noqa: F401
