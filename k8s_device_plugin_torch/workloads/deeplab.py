"""DeepLab-v3 semantic segmentation in PyTorch — benchmark case 4.x (batch
2 inference @ 512; the runner trains batch 1 at the same size).

Counterpart of ``k8s_device_plugin_tpu/workloads/deeplab.py``, with its
module names, so Flax variables transfer by path
(``convert.flax_to_state_dict``). Built on the port's ResNet-V2 pieces
(``resnet.BottleneckV2``, ``BatchNorm``, Flax's SAME padding): a 7 x 7/2
root conv with padding 3, a SAME 3 x 3/2 max pool, the bottleneck stages
(the last at stride 1 and, as in the JAX model, without dilation: output
stride 16), the ASPP head, an fp32 1 x 1 classifier and a bilinear resize
back to the input's size. Inputs are NHWC; the output is [B, H, W,
classes] like the JAX model's, so ``harness.seg_cross_entropy`` takes it
as it is.

``jax.image.resize(..., "bilinear")`` samples input pixel (i + 0.5) / s -
0.5 with a triangle kernel and renormalizes its weights where taps fall
outside the input; upsampling, that is ``F.interpolate(mode="bilinear",
align_corners=False)``, which clamps the sample to the edge pixel, where
the renormalized kernel also gives the edge pixel alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BottleneckV2, Conv2d, _pad_same

#: (filters, blocks, stride) per stage: output stride 16, the last stage
#: keeps its resolution
BACKBONE_BLOCKS = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 1))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling on NCHW features: a 1 x 1 branch,
    3 x 3 branches at ``rates`` (SAME: each pads by its dilation on each
    side), and an image-level pooling branch, concatenated in that order
    and merged by a 1 x 1 conv and a ReLU."""

    def __init__(self, in_channels: int, features: int = 256,
                 rates: tuple = (6, 12, 18),
                 param_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.rates = rates
        self.aspp_1x1 = Conv2d(in_channels, features, 1, dtype=param_dtype)
        for r in rates:
            self.add_module(f"aspp_r{r}", Conv2d(
                in_channels, features, 3, padding=r, dilation=r,
                dtype=param_dtype))
        self.aspp_pool = Conv2d(in_channels, features, 1, dtype=param_dtype)
        self.aspp_merge = Conv2d(features * (len(rates) + 2), features, 1,
                                 dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.aspp_1x1(x)]
        branches += [getattr(self, f"aspp_r{r}")(x) for r in self.rates]
        pooled = self.aspp_pool(x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return F.relu(self.aspp_merge(torch.cat(branches, dim=1)))


class DeepLabV3(nn.Module):
    """Convs compute in ``dtype`` on weights kept in ``param_dtype``
    (default ``dtype``; fp32 to train); the classifier and the resize in
    fp32."""

    def __init__(self, num_classes: int = 21,
                 backbone_blocks: tuple = BACKBONE_BLOCKS,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.conv_root = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                                dtype=param_dtype)
        channels = 64
        self.block_names = []
        for i, (filters, n_blocks, stride) in enumerate(backbone_blocks):
            for j in range(n_blocks):
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, BottleneckV2(
                    channels, filters, stride if j == 0 else 1,
                    param_dtype=param_dtype))
                self.block_names.append(name)
                channels = filters * 4
        self.aspp = ASPP(channels, param_dtype=param_dtype)
        self.classifier = Conv2d(256, num_classes, 1)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, 3] (NHWC) -> logits [B, H, W, num_classes] fp32."""
        size = x.shape[1:3]
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.conv_root(x)
        x, pad = _pad_same(x, 3, 2, value=float("-inf"))
        x = F.max_pool2d(x, 3, stride=2, padding=pad)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.classifier(self.aspp(x).float())
        return resize_bilinear(x, size).permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of NCHW ``x`` to ``size`` (H,
    W), upsampling (see the module docstring)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)
