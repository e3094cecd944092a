"""Operations and bytes of the benchmark's models, counted from shapes.

Each ``<model>.py`` gives ``flops_per_item(cfg)`` (2 FLOP per
multiply-add) and, for the port's own kernels on its path,
``kernel_cost(cfg)``: ``{kernel: (flops, bytes)}`` of one launch, each
input read once and each output written once.
"""

#: NVIDIA H100 SXM, dense, from its data sheet: bf16 tensor-core FLOP/s and
#: HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
