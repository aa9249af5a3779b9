"""The link-prediction step's share of the card's peak: the least
operations of every step of the window (``step_flops``) at the peak of the
configuration's precision, over the window's seconds.

A GCN-DistMult step: in each of the two GraphConv layers and each relation
channel, the projection ``Z W_c`` over the smaller of the entities that
send and that receive along the channel, forward and both gradients (the
first layer's input is the embedding table, a parameter), and the
aggregation over the channel's edges forward and backward; the DistMult
scores of the slice's real rows (3·dim a score forward, 6·dim back, two
scores a row).  Element-wise work is not counted.
"""
from portbench.work import matmul_flops

UNIT = "%"
FAMILY = "kg"


def step_flops(graph: dict, step: dict) -> float:
    d = graph["dim"]
    flops = 0.0
    for ch in graph["channels"]:
        rows = min(ch["senders"], ch["receivers"])
        flops += 2 * (matmul_flops(rows, d, d, grads=2) + 2 * 2.0 * ch["edges"] * d)
    return flops + step["labels"] * 2 * 9.0 * d


def read(ctx):
    if ctx.config.get("family") != FAMILY or not ctx.peaks or not ctx.window_steps:
        return None
    dtype = "bfloat16" if ctx.config["program"].get("precision") == "bfloat16" else "float32"
    flops = sum(step_flops(ctx.graph, s) for s in ctx.window_steps)
    return 100.0 * flops / ctx.peaks[dtype] / ctx.window_s
