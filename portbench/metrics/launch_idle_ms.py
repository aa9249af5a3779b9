"""Device idle milliseconds an epoch while it waits for the epoch's
launches: the gaps of the traced slice in which the host handed the device
work (``spans.waiting_gaps``), where they overlap the program's
``kgcn.train.replay`` ranges, over the number of those ranges (the slice's
epochs).  A graph's gaps between its nodes are left out: the device held
the work, and under the profiler they are mostly the tracer's.  None where
the program marks no replay.  One reader for every cell;
``launch_idle_ms.<family>`` names it for the cells whose rate it
``moves``."""
from portbench.spans import idle_split

UNIT = "ms"


def read(ctx):
    split = idle_split(ctx.trace) if ctx.trace is not None else None
    if split is None:
        return None
    inside, _, epochs = split
    return inside / 1e6 / epochs
