"""The stream scatter kernel's share of its roofline in the link-prediction
cells: the least time of each traced step's stream scatters (two layers,
each relation channel, the forward and the backward's transposed scatter;
``ops/stream_spmm.py`` → ``csrc/stream.cu``; ``least_seconds`` of
``work.scatter_call``: float32 rows in and out, the payload's weights,
sums in float32) over the device time of the kernel (``KERNELS``)."""
from portbench.work import least_seconds, scatter_call

UNIT = "%"
FAMILY = "kg"
_START = r"(?:^|void |\d|namespace\)::)"
KERNELS = (_START + r"stream_scatter_kernel",)
LAYERS = 2


def step_least_seconds(graph: dict, peak: dict) -> float:
    wb = 2 if graph["payload"] == "bfloat16" else 4
    total = 0.0
    for ch in graph["channels"]:
        for s, r in ((ch["senders"], ch["receivers"]), (ch["receivers"], ch["senders"])):
            call = scatter_call(ch["edges"], s, r, graph["dim"], weight_bytes=wb)
            total += least_seconds(call["flops"], call["bytes"], peak)
    return LAYERS * total


def read(ctx):
    if ctx.config.get("family") != FAMILY or ctx.trace is None or not ctx.peaks:
        return None
    device = ctx.trace.seconds(KERNELS)
    if device <= 0 or not ctx.traced_steps:
        return None
    return 100.0 * step_least_seconds(ctx.graph, ctx.peaks) * len(ctx.traced_steps) / device
