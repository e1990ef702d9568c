"""Reading a torch.profiler capture: device busy time, idle gaps and what
the host did in them, and device time by operation.

The capture is reduced to plain events ``(name, on_device, start_ns,
duration_ns)`` first, so the arithmetic below runs on recorded fixtures
as well as on a live capture.  The traced window is the host span named
``WINDOW`` that the harness opens around the traced work.
"""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

WINDOW = "bench.traced_window"
TOP = 10


class Event(NamedTuple):
    name: str
    on_device: bool
    start_ns: int
    dur_ns: int

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns


class Summary(NamedTuple):
    window_s: float
    busy_s: float                 # union of device intervals in the window
    device_s: float               # sum of device durations in the window
    device_events: int
    by_name: dict                 # device op name -> (count, seconds)
    idle_by_host: dict            # host op name -> idle seconds


def events_of(prof) -> list[Event]:
    """Plain events of a finished ``torch.profiler.profile``.  GPU-side
    copies of host annotations (``record_function``) are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and e.is_user_annotation():
            continue
        out.append(Event(e.name(), dev, int(e.start_ns()),
                         int(e.duration_ns())))
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(host: list[Event], points: list[int]) -> list[str]:
    """For each of the ascending ``points``, the name of the host span with
    the latest start that is open there (the innermost, where spans nest),
    or ``WINDOW`` where none is: one pass over the spans sorted by start."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i].start_ns <= p:
            while stack and stack[-1].end_ns <= host[i].start_ns:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end_ns <= p:
            stack.pop()
        out.append(stack[-1].name if stack else WINDOW)
    return out


def summarize(events: list[Event]) -> Summary:
    windows = [e for e in events if not e.on_device and e.name == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"want one {WINDOW} span, found {len(windows)}")
    w0, w1 = windows[0].start_ns, windows[0].end_ns
    dev = [e for e in events
           if e.on_device and e.end_ns > w0 and e.start_ns < w1]
    clipped = [(max(e.start_ns, w0), min(e.end_ns, w1)) for e in dev]
    busy = _union(clipped)
    by_name: dict = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.dur_ns / 1e9
    host = sorted((e for e in events if not e.on_device and e.name != WINDOW
                   and e.end_ns > w0 and e.start_ns < w1),
                  key=lambda e: e.start_ns)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle: dict = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(host, [(a + b) // 2
                                                     for a, b in gaps])):
        idle[name] += (b - a) / 1e9
    return Summary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        device_s=sum(e.dur_ns for e in dev) / 1e9,
        device_events=len(dev),
        by_name={k: tuple(v) for k, v in by_name.items()},
        idle_by_host=dict(idle))


def breakdown(s: Summary) -> dict:
    """The ``breakdown`` of a traced run's line: the device operations that
    took most time, and idle time by what the host was doing."""
    ops = sorted(s.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    gaps = sorted(s.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], v[1]] for n, v in ops],
            "idle_gaps": [[n[:120], v] for n, v in gaps]}
