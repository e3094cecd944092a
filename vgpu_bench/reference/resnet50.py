"""ResNet-V2-50 (pre-activation; He et al., "Identity Mappings in Deep
Residual Networks", arXiv:1603.05027) for inference, in plain fp32.

Bottleneck blocks of 3, 4, 6 and 3 at widths 64, 128, 256 and 512 (times
4 out); each block: BatchNorm, ReLU, then a 1x1, a 3x3 (the stage's
stride, on the first block of stages 2-4) and a 1x1 convolution with
BatchNorm and ReLU between; the shortcut is the input, or a strided 1x1
projection of the pre-activation where the shape changes. A 7x7 stride-2
root convolution (3 pixels of padding each side) and a 3x3 stride-2 max
pool ("SAME", as TensorFlow pads) open it; a last BatchNorm and ReLU, the
global mean and a dense head close it. BatchNorm in eval form: the running
statistics, epsilon 1e-5. Input NHWC, as the suite feeds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import rounded

STAGES = {50: (3, 4, 6, 3), 152: (3, 8, 36, 3)}
BN_EPS = 1e-5


def blocks(cfg):
    """(name, in channels, width, stride) of every bottleneck, in order."""
    channels = 64
    for i, n in enumerate(STAGES[cfg["depth"]]):
        for j in range(n):
            width = 64 * 2 ** i
            yield (f"stage{i + 1}_block{j + 1}", channels, width,
                   2 if j == 0 and i > 0 else 1)
            channels = 4 * width


def layout(cfg) -> dict:
    """{name: (shape, dtype, init)}: convolutions in the served dtype, the
    BatchNorms and the head in fp32; init ``("normal", std)`` with std
    1/sqrt(fan-in) for products, ``("around", base, std)`` otherwise."""
    conv = getattr(torch, cfg["dtype"])
    out = {}

    def conv_w(name, cout, cin, k):
        out[name] = ((cout, cin, k, k), conv,
                     ("normal", (cin * k * k) ** -0.5))

    def bn(name, c):
        out[f"{name}.weight"] = ((c,), torch.float32, ("around", 1.0, 0.1))
        out[f"{name}.bias"] = ((c,), torch.float32, ("around", 0.0, 0.1))
        out[f"{name}.running_mean"] = ((c,), torch.float32,
                                       ("around", 0.0, 0.1))
        out[f"{name}.running_var"] = ((c,), torch.float32, ("above", 1.0, 0.1))

    conv_w("conv_root.weight", 64, cfg["channels"], 7)
    channels = 64
    for name, cin, width, stride in blocks(cfg):
        bn(f"{name}.preact_bn", cin)
        if cin != 4 * width or stride != 1:
            conv_w(f"{name}.proj.weight", 4 * width, cin, 1)
        conv_w(f"{name}.conv1.weight", width, cin, 1)
        bn(f"{name}.bn1", width)
        conv_w(f"{name}.conv2.weight", width, width, 3)
        bn(f"{name}.bn2", width)
        conv_w(f"{name}.conv3.weight", 4 * width, width, 1)
        channels = 4 * width
    bn("final_bn", channels)
    classes = cfg["num_classes"]
    out["head.weight"] = ((classes, channels), torch.float32,
                          ("normal", channels ** -0.5))
    out["head.bias"] = ((classes,), torch.float32, ("around", 0.0, 0.1))
    return out


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) of TensorFlow's "SAME": the output is
    ceil(size / stride), the odd pixel goes after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def forward(w: dict, x: torch.Tensor, cfg, precision: str = "fp32"):
    """Logits [B, classes] in fp32 of images ``x`` [B, H, W, C] under the
    weights ``w`` (any dtype; read as fp32)."""
    w = {k: v.float() for k, v in w.items()}

    def conv(name, t, stride=1, pad=(0, 0)):
        k = w[name].shape[-1]
        if k > 1 and pad == (0, 0):
            ph = same_padding(t.shape[2], k, stride)
            pw = same_padding(t.shape[3], k, stride)
            t = F.pad(t, (pw[0], pw[1], ph[0], ph[1]))
        elif pad != (0, 0):
            t = F.pad(t, (pad[0], pad[1], pad[0], pad[1]))
        return F.conv2d(rounded(t, precision), rounded(w[name], precision),
                        stride=stride)

    def bn_relu(name, t):
        scale = w[f"{name}.weight"] / torch.sqrt(w[f"{name}.running_var"]
                                                 + BN_EPS)
        shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
        return F.relu(t * scale[:, None, None] + shift[:, None, None])

    t = x.float().permute(0, 3, 1, 2)
    t = conv("conv_root.weight", t, stride=2, pad=(3, 3))
    ph = same_padding(t.shape[2], 3, 2)
    pw = same_padding(t.shape[3], 3, 2)
    t = F.max_pool2d(F.pad(t, (pw[0], pw[1], ph[0], ph[1]),
                           value=float("-inf")), 3, stride=2)
    for name, cin, width, stride in blocks(cfg):
        pre = bn_relu(f"{name}.preact_bn", t)
        short = t if f"{name}.proj.weight" not in w else \
            conv(f"{name}.proj.weight", pre, stride=stride)
        y = bn_relu(f"{name}.bn1", conv(f"{name}.conv1.weight", pre))
        y = bn_relu(f"{name}.bn2", conv(f"{name}.conv2.weight", y,
                                        stride=stride))
        t = short + conv(f"{name}.conv3.weight", y)
    t = bn_relu("final_bn", t).mean(dim=(2, 3))
    return rounded(t, precision) @ rounded(w["head.weight"], precision).T \
        + w["head.bias"]
