"""ResNet-V2-50's FLOP per image: every convolution and the head, 2 FLOP
per multiply-add (output elements x input channels x kernel area), as the
port's ``harness.count_flops`` counts them."""

from __future__ import annotations

STAGES = {50: (3, 4, 6, 3), 152: (3, 8, 36, 3)}


def flops_per_item(cfg) -> int:
    size = -(-cfg["image_size"] // 2)  # the root's stride 2
    total = 2 * size * size * 64 * cfg["channels"] * 7 * 7
    size = -(-size // 2)  # the max pool
    channels = 64
    for i, n in enumerate(STAGES[cfg["depth"]]):
        width = 64 * 2 ** i
        for j in range(n):
            stride = 2 if j == 0 and i > 0 else 1
            out = -(-size // stride)
            total += 2 * size * size * width * channels  # conv1, 1x1
            total += 2 * out * out * width * width * 9  # conv2, 3x3
            total += 2 * out * out * 4 * width * width  # conv3, 1x1
            if channels != 4 * width or stride != 1:
                total += 2 * out * out * 4 * width * channels  # proj
            size, channels = out, 4 * width
    return total + 2 * channels * cfg["num_classes"]


def kernel_cost(cfg) -> dict:
    return {}  # cuDNN's convolutions only: no kernel of the port
