"""ResNet-V2 (pre-activation) in PyTorch — benchmark cases 1.x/2.x.

Counterpart of ``k8s_device_plugin_tpu/workloads/resnet.py``, with the same
module names so Flax variables transfer by path (``convert.py``). Runs in
channels_last with convolutions in ``dtype`` (bf16 by default; cuDNN owns
them, as XLA did on the TPU), BatchNorm arithmetic in fp32 on ``dtype``
activations (as Flax computes it), and an fp32 classifier head. Inputs are
NHWC like the JAX model's; the NCHW view of an NHWC tensor is already
channels_last, so no copy is made.

Training follows Flax's ``nn.Conv(dtype=bf16)`` and ``nn.BatchNorm``:
the conv weights are kept in ``param_dtype`` (fp32 for training, so SGD's
small updates are not rounded away) and cast to the activations' dtype
for each conv; with the default ``param_dtype=dtype`` (inference) the cast
is a no-op. :class:`BatchNorm` updates its running variance with the
biased batch variance, as Flax does (``nn.BatchNorm2d`` takes the
unbiased one).

Flax's ``padding="SAME"`` pads ``total // 2`` before and the rest after,
so a stride-2 window on an even input pads 0 before and 1 after, where
PyTorch's symmetric ``padding=1`` would shift the output by one pixel.
:func:`_same_pad` computes Flax's split; an asymmetric split goes through
``F.pad`` (with -inf for the max-pool).

:meth:`ResNetV2.forward` carries (sum, pre-activation) from block to
block, so that each BatchNorm goes with its ReLU, and each residual add
with the next BatchNorm and ReLU (``bn_relu.py``). In eval on bf16 CUDA
activations each of those is one pass of ``csrc/bn_relu.cu``; in training,
and on any other dtype or device, they are the modules' own ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import bn_relu as fused

DEPTHS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

#: Flax BatchNorm's default epsilon
BN_EPS = 1e-5


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of one spatial dim under Flax "SAME"."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> tuple[torch.Tensor, int]:
    """Apply "SAME" padding: returns (x, symmetric padding left for the op
    to apply itself). Only an asymmetric split costs a copy."""
    ph = _same_pad(x.shape[2], kernel, stride)
    pw = _same_pad(x.shape[3], kernel, stride)
    if ph[0] == ph[1] == pw[0] == pw[1]:
        return x, ph[0]
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), 0


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype, whatever the weight's
    and the bias's (Flax's ``dtype`` beside its ``param_dtype``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


def _cast(bias, dtype):
    return None if bias is None else bias.to(dtype)


class SameConv2d(Conv2d):
    """:class:`Conv2d` with Flax's "SAME" padding, worked out per input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
                        self.stride, pad)


class BatchNorm(nn.BatchNorm2d):
    """Flax's ``nn.BatchNorm(momentum=0.9)``: in training it normalizes
    with the batch statistics and moves the running ones a tenth of the
    way to the batch mean and the BIASED batch variance; in eval it is
    ``nn.BatchNorm2d``.

    When the batch is split over the ranks of ``group`` (set by
    ``harness.shard_model``), the statistics are those of the whole batch,
    as in JAX's sharded step, which is the global program: the
    per-channel sums of x and x² (in fp32, or fp64 for fp64 inputs) are
    summed over ``group`` through a differentiable all-reduce, and the
    variance is E[x²] - E[x]², Flax's fast variance. (``nn.SyncBatchNorm``
    runs on CUDA tensors only.)"""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=0.1)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._global_batch_norm(x)
        # the batch statistics come back as mean and 1 / sqrt(var + eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        self._update_running(mean, invstd.pow(-2) - self.eps)
        return y

    @torch.no_grad()
    def _update_running(self, mean, var) -> None:
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        from .collectives import all_reduce_sum
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        count = x.numel() // x.shape[1] \
            * torch.distributed.get_world_size(self.group)
        sums = all_reduce_sum(torch.stack([x32.sum((0, 2, 3)),
                                           (x32 * x32).sum((0, 2, 3))]),
                              self.group) / count
        mean = sums[0]
        var = torch.clamp_min(sums[1] - mean * mean, 0.0)
        self._update_running(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight.to(x32.dtype)
        y = (x32 - mean[:, None, None]) * scale[:, None, None] \
            + self.bias.to(x32.dtype)[:, None, None]
        return y.to(x.dtype)


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck (BN-ReLU-Conv x3 + projection)."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 param_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.preact_bn = BatchNorm(in_channels)
        self.proj = None
        if in_channels != filters * 4 or stride != 1:
            self.proj = Conv2d(in_channels, filters * 4, 1, stride=stride,
                               bias=False, dtype=param_dtype)
        self.conv1 = Conv2d(in_channels, filters, 1, bias=False,
                            dtype=param_dtype)
        self.bn1 = BatchNorm(filters)
        self.conv2 = SameConv2d(filters, filters, 3, stride=stride,
                                bias=False, dtype=param_dtype)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv2d(filters, filters * 4, 1, bias=False,
                            dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut, residual = self.branches(
            x, fused.bn_relu_reference(x, self.preact_bn),
            fused.bn_relu_reference)
        return shortcut + residual

    def branches(self, x, preact, bn_relu):
        """(shortcut, residual) from the block's input ``x`` and its
        pre-activation ``relu(preact_bn(x))``, which the caller made, with
        ``bn_relu(y, bn)`` for bn1 and bn2 and their ReLUs: the block's
        output is their sum."""
        shortcut = x if self.proj is None else self.proj(preact)
        y = bn_relu(self.conv1(preact), self.bn1)
        y = bn_relu(self.conv2(y), self.bn2)
        return shortcut, self.conv3(y)


class ResNetV2(nn.Module):
    """Convs compute in ``dtype`` on weights kept in ``param_dtype``
    (default ``dtype``; fp32 to train)."""

    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.conv_root = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                                dtype=param_dtype)
        channels = 64
        self.block_names = []
        for i, n_blocks in enumerate(DEPTHS[depth]):
            for j in range(n_blocks):
                stride = 2 if j == 0 and i > 0 else 1
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, BottleneckV2(
                    channels, 64 * 2 ** i, stride, param_dtype=param_dtype))
                self.block_names.append(name)
                channels = 64 * 2 ** i * 4
        self.final_bn = BatchNorm(channels)
        # classifier head in fp32, as the JAX model's Dense(dtype=float32)
        self.head = nn.Linear(channels, num_classes)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, 3] (NHWC) -> logits [B, num_classes] fp32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.conv_root(x)
        x, pad = _pad_same(x, 3, 2, value=float("-inf"))
        x = F.max_pool2d(x, 3, stride=2, padding=pad)
        # block k's add goes with block k+1's preact BatchNorm and ReLU
        # (the last with final_bn's), and its sum is kept only where block
        # k+1's shortcut is the identity
        blocks = [getattr(self, name) for name in self.block_names]
        preact = fused.bn_relu(x, blocks[0].preact_bn)
        for block, after in zip(blocks, blocks[1:] + [None]):
            shortcut, residual = block.branches(x, preact, fused.bn_relu)
            x, preact = fused.add_bn_relu(
                shortcut, residual,
                self.final_bn if after is None else after.preact_bn,
                keep_sum=after is not None and after.proj is None)
        x = preact.mean(dim=(2, 3))
        return self.head(x.float())


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16,
             param_dtype=None) -> ResNetV2:
    return ResNetV2(depth=50, num_classes=num_classes, dtype=dtype,
                    param_dtype=param_dtype)


def resnet152(num_classes: int = 1000, dtype=torch.bfloat16,
              param_dtype=None) -> ResNetV2:
    return ResNetV2(depth=152, num_classes=num_classes, dtype=dtype,
                    param_dtype=param_dtype)
