"""Share of the traced window in which no operation ran on the device, from
the profiler. Layer: device.

In mrf-penguin.serve-closed, moves ``queries_s``."""
from bench.readers import device_idle as read  # noqa: F401
