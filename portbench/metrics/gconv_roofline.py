"""The dense aggregation kernels' share of their roofline in the reaction
cells: the least time of each traced step's forward ``gconv`` calls
(``ops/gconv.py`` → ``csrc/gconv.cu``; ``least_seconds``: the projection
over the real atoms and the aggregation over the real bonds at the FP32
peak, or the real atoms' rows, the kernels and the bonds at the HBM rate,
whichever is longer) over the device time of the kernels that op launches
(``KERNELS``, their names in the profiler's records, demangled or
mangled)."""
from portbench.work import graph_conv_call, least_seconds

UNIT = "%"
FAMILY = "sparse"
_START = r"(?:^|void |\d|namespace\)::)"
KERNELS = (_START + r"(?:tc::)?(?:gconv_tc_\w+|sum_splits)",
           _START + r"(?:gemm_kernel|small_graph_kernel)")


def step_least_seconds(config: dict, step: dict, peak: dict) -> float:
    prog, data = config["program"], config["data"]
    bf16 = prog.get("precision") == "bfloat16"
    dims = [int(data["atom_features"]), *map(int, prog["out_dims"])]
    total = 0.0
    for i in range(len(dims) - 1):
        call = graph_conv_call(step["atoms"], step["edges"], dims[i], dims[i + 1],
                               channels=int(data["bond_channels"]), elem=2 if bf16 else 4)
        total += least_seconds(call["flops"], call["bytes"], peak,
                               "bfloat16" if bf16 else "float32")
    return total


def read(ctx):
    if ctx.config.get("family") != FAMILY or ctx.trace is None or not ctx.peaks:
        return None
    device = ctx.trace.seconds(KERNELS)
    if device <= 0 or not ctx.traced_steps:
        return None
    least = sum(step_least_seconds(ctx.config, s, ctx.peaks) for s in ctx.traced_steps)
    return 100.0 * least / device
