"""Device idle share of the traced slice: 1 − (the union of the device's
kernels, copies and fills) ÷ the slice's span, whole epochs of the
captured runner with their per-epoch host work between them.  One reader
for every cell; ``idle_share.<family>`` names it for the cells whose rate
it ``moves``."""
UNIT = "%"


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.span_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.span_s)
