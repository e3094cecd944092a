"""The whole step's share of the card's bf16 peak, in %: items x the
benchmark's own FLOP count per item, over the window."""

from vgpu_bench.counts import PEAK_BF16_FLOPS


def read(run):
    flops = run.items * run.counts.flops_per_item(run.config)
    return 100.0 * flops / run.window_s / PEAK_BF16_FLOPS
