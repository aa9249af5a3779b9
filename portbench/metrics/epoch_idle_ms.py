"""Device idle milliseconds an epoch while it waits for the per-epoch host
work: the gaps of the traced slice in which the host handed the device work
(``spans.waiting_gaps``), outside every ``kgcn.train.replay`` range of the
program, over the number of those ranges (the slice's epochs).  That is the
data call, the optimizer's table, the loads, the copy-out, the read-back
and the glue between them, each as slow as the profiler makes it on the
host.  None where the program marks no replay.  One reader for every cell;
``epoch_idle_ms.<family>`` names it for the cells whose rate it
``moves``."""
from portbench.spans import idle_split

UNIT = "ms"


def read(ctx):
    split = idle_split(ctx.trace) if ctx.trace is not None else None
    if split is None:
        return None
    _, outside, epochs = split
    return outside / 1e6 / epochs
