"""Host milliseconds an epoch in the data layer's per-epoch call
(``ResidentBatcher.epoch_schedule``: the epoch's permutation and schedule;
``KGBatcher.epoch_scan_inputs``: the shuffle, the label slices and their
negatives), timed by the benchmark's span around the call, averaged over
the window's epochs.  One reader for every cell; ``data_host_ms.<family>``
names it for the cells whose rate it ``moves``."""
UNIT = "ms"


def read(ctx):
    if not ctx.data_host_s:
        return None
    return 1e3 * sum(ctx.data_host_s) / len(ctx.data_host_s)
