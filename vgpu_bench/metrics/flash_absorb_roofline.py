"""K3's (``flash_absorb``) share of its roofline, in %: the least time one
launch could take (the larger of its bytes over HBM's peak and its FLOP
over the bf16 peak) over its mean device time in the trace, its launches'
share of the card's busy time (``trace.merge``) over their number. Every
route of K3 launches a kernel named ``flash_kernel``."""

from vgpu_bench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def read(run):
    cost = run.counts.kernel_cost(run.config).get("flash_absorb")
    if run.trace is None or cost is None:
        return None
    count = seconds = 0
    for name, (k, s) in run.trace["ops"].items():
        if "flash_kernel" in name:
            count += k
            seconds += s
    if not count:
        return None
    flops, nbytes = cost
    bound = max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)
    return 100.0 * bound / (seconds / count)
