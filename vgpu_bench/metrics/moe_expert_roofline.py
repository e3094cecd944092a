"""The drop-free expert layer's grouped products' share of their roofline,
in %: the least time one layer's two products could take (the larger of
their bytes over HBM's peak and their FLOP over the bf16 peak,
``counts.<model>.kernel_cost``'s ``moe_experts``) over the mean device
time a layer of the kernels they launch. On the card each product is one
``torch._grouped_mm``, which runs CUTLASS's grouped GEMM: a kernel whose
name holds ``GroupProblemShape``, two launches a layer."""

from vgpu_bench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

#: what the name of the grouped GEMM's kernel holds in the trace
KERNEL = "GroupProblemShape"
#: its launches a layer: W1 and W3 side by side, then W2
LAUNCHES_PER_LAYER = 2


def read(run):
    cost = run.counts.kernel_cost(run.config).get("moe_experts")
    if run.trace is None or cost is None:
        return None
    count = seconds = 0
    for name, (k, s) in run.trace["ops"].items():
        if KERNEL in name:
            count += k
            seconds += s
    if count < LAUNCHES_PER_LAYER:
        return None
    flops, nbytes = cost
    bound = max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)
    return 100.0 * bound / (seconds / (count / LAUNCHES_PER_LAYER))
