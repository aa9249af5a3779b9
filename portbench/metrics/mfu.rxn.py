"""The reaction step's share of the card's peak: the least operations of
every step of the window (``step_flops``, padding not counted) at the
peak of the configuration's precision, over the window's seconds.

A SparseGCN step: each GraphConv's projection ``X W_c`` over the real
atoms, forward and the kernel's gradient, and the input's gradient except
in the first layer (its input is data), with the aggregation over the real
bonds forward and backward; GraphDense likewise; the head ``h W`` over the
real graphs, forward and both gradients.  Element-wise work is not counted.
"""
from portbench.work import matmul_flops

UNIT = "%"
FAMILY = "sparse"


def step_flops(config: dict, step: dict) -> float:
    prog, data = config["program"], config["data"]
    C = int(data["bond_channels"])
    dims = [int(data["atom_features"]), *map(int, prog["out_dims"])]
    atoms, edges = step["atoms"], step["edges"]
    flops = 0.0
    for i in range(len(dims) - 1):
        flops += C * matmul_flops(atoms, dims[i], dims[i + 1], grads=1 if i == 0 else 2)
        flops += 2 * 2.0 * edges * dims[i + 1]
    d = int(prog["dense_dim"])
    flops += matmul_flops(atoms, dims[-1], d, grads=2)
    flops += matmul_flops(step["graphs"], d, int(prog["num_classes"]), grads=2)
    return flops


def read(ctx):
    if ctx.config.get("family") != FAMILY or not ctx.peaks or not ctx.window_steps:
        return None
    dtype = "bfloat16" if ctx.config["program"].get("precision") == "bfloat16" else "float32"
    flops = sum(step_flops(ctx.config, s) for s in ctx.window_steps)
    return 100.0 * flops / ctx.peaks[dtype] / ctx.window_s
