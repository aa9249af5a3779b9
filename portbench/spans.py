"""The program's spans in a traced slice (``trace.Trace``), against the
device's idle time.

The port marks each training epoch's launches with a ``kgcn.train.replay``
range (``kgcn_tpu_torch/runtime/spans.py``), one an epoch, on the
profiler's host clock, which the device's records share.  Of the device's
idle gaps in the slice (the slice less the union of its activities) only
those in which the device waited for the host are read: the host began or
ended a call that hands the device work (a launch, a copy, a fill) inside
the gap.  The other gaps lie between work the device already held, between
a CUDA graph's nodes or between queued launches; under the profiler they
are mostly its own cost (on an H100, a druglike epoch's replays take 484
ms on the device untraced and 518 traced, by CUDA events).  The waiting is split by
overlap with the replay ranges: inside, the device waited on the epoch's
launches; outside, on the per-epoch host work (the data call, the
optimizer's table, the loads, the copy-out, the read-back).  A slice of a
program without the spans has nothing to split.
"""
from __future__ import annotations

import bisect
import re
from typing import List, Optional, Tuple

Interval = Tuple[int, int]

# host calls that hand the device work (names of the CUDA runtime and its lower API)
SUBMIT = re.compile(r"^cu\w*(Launch|Memcpy|Memset)")


def replay_name() -> Optional[str]:
    """The program's name of an epoch's replay range; None for a program
    without spans."""
    try:
        from kgcn_tpu_torch.runtime.spans import PREFIX
    except ImportError:
        return None
    return PREFIX + "train.replay"


def _overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """The time two sorted lists of disjoint intervals share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def waiting_gaps(trace) -> List[Interval]:
    """The device's idle gaps in the slice in which the host began or ended
    a call that hands the device work."""
    busy = trace.busy_intervals()
    edges = [trace.start] + [t for iv in busy for t in iv] + [trace.end]
    marks = sorted(t for n, s, e in trace.host if SUBMIT.match(n) for t in (s, e))
    out = []
    for s, e in zip(edges[::2], edges[1::2]):
        i = bisect.bisect_right(marks, s)
        if e > s and i < len(marks) and marks[i] < e:
            out.append((s, e))
    return out


def idle_split(trace) -> Optional[Tuple[int, int, int]]:
    """(the ns the device waited for the host inside the replay ranges, the
    ns it waited outside them, the number of ranges) in the slice; None
    where the slice holds no replay range.  An epoch's ranges follow one
    another, so they are disjoint."""
    name = replay_name()
    spans = sorted((max(s, trace.start), min(e, trace.end)) for n, s, e in trace.host
                   if n == name and e > trace.start and s < trace.end)
    if not spans:
        return None
    waiting = waiting_gaps(trace)
    inside = _overlap_ns(waiting, spans)
    return inside, sum(e - s for s, e in waiting) - inside, len(spans)
