"""torch.profiler over a slice of a run, reduced to what the per-layer
metrics read: every device activity (kernels, copies, fills) and host event
of the slice, the slice's span, the device's busy time (the union of its
activities), device seconds by kernel name, and the idle gaps labelled by
what the host was doing.

The slice is marked by a ``portbench.slice`` range from the benchmark's own
files; its span is that range on the profiler's clock, which the device's
records share.  On the H100 the profiler has been seen to lose records now
and then, and whole windows late in a long process: a slice that recorded
no device activity is taken again, up to ``ATTEMPTS`` times.
"""
from __future__ import annotations

import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

SLICE = "portbench.slice"
ATTEMPTS = 3

Event = Tuple[str, int, int]  # (name, start ns, end ns)


class Trace:
    def __init__(self, device: List[Event], host: List[Event], start: int, end: int):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host
        self.start, self.end = start, end

    @property
    def span_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's activities inside the slice."""
        out: List[Tuple[int, int]] = []
        for _, s, e in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds(self, patterns: Iterable[str]) -> float:
        """Device seconds of the activities whose name matches a pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for name, s, e in self.device
                   if any(r.search(name) for r in rx)) / 1e9

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle seconds of the device inside the slice, summed by the
        innermost host event running at each gap's middle (``host idle``
        where none was), the ``k`` largest."""
        busy = self.busy_intervals()
        edges = [self.start] + [t for iv in busy for t in iv] + [self.end]
        host = sorted((ev for ev in self.host if ev[0] != SLICE), key=lambda e: e[1])
        by: Dict[str, int] = {}
        active: List[Event] = []
        nxt = 0
        for s, e in zip(edges[::2], edges[1::2]):  # gaps in time order
            if e <= s:
                continue
            mid = (s + e) // 2
            while nxt < len(host) and host[nxt][1] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [ev for ev in active if ev[2] >= mid]
            inner = min(active, key=lambda ev: ev[2] - ev[1], default=None)
            label = inner[0] if inner else "host idle"
            by[label] = by.get(label, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], ns / 1e9] for name, ns in top]


def _events(prof) -> Tuple[List[Event], List[Event], Optional[Tuple[int, int]]]:
    from torch.autograd import DeviceType

    device, host, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = int(e.start_ns())
        ev = (e.name(), s, s + int(e.duration_ns()))
        if e.device_type() == DeviceType.CUDA:
            # ranges of the host's annotations, mirrored on the device's timeline
            if not (e.is_user_annotation() or ev[0].startswith("portbench.")):
                device.append(ev)
        else:
            host.append(ev)
            if ev[0] == SLICE:
                span = (ev[1], ev[2])
    return device, host, span


def record(fn: Callable[[], None], sync: Callable[[], None]) -> Optional[Trace]:
    """``fn`` run under torch.profiler inside the slice range, ending in
    ``sync``; None where no attempt recorded a device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(ATTEMPTS):
        time.sleep(0.2 * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(SLICE):
                fn()
                sync()
        device, host, span = _events(prof)
        if device and span:
            return Trace(device, host, *span)
    return None
