"""K3's windowed launches' share of their roofline, in %: the least time
one launch could take (the larger of its bytes over HBM's peak and its
FLOP over the bf16 peak, ``counts.<model>.kernel_cost``'s
``flash_window``: the band's pairs, each input read once) over their mean
device time in the trace. A windowed absorb launches a kernel named
``flash_window_kernel``; nothing to read (a model without a window, or a
program without the kernel) gives no value."""

from vgpu_bench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

#: what the name of the windowed absorb's kernel holds in the trace
KERNEL = "flash_window_kernel"


def read(run):
    cost = run.counts.kernel_cost(run.config).get("flash_window")
    if run.trace is None or cost is None:
        return None
    count = seconds = 0
    for name, (k, s) in run.trace["ops"].items():
        if KERNEL in name:
            count += k
            seconds += s
    if not count:
        return None
    flops, nbytes = cost
    bound = max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)
    return 100.0 * bound / (seconds / count)
