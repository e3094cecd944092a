"""VGG-16 in PyTorch — benchmark case 3.x (batch 20 inference / 2 training,
224 x 224).

Counterpart of ``k8s_device_plugin_tpu/workloads/vgg.py``, with the Flax
module names (``conv1`` … ``conv13``, ``fc1``, ``fc2``, ``head``), so Flax
variables transfer by path (``convert.flax_to_state_dict``). The convs
(SAME 3 x 3, cuDNN, channels_last) and ``fc1``/``fc2`` compute in ``dtype``
on weights kept in ``param_dtype`` (fp32 to train), the ``head`` in fp32,
as the JAX model. Inputs are NHWC.

Flax flattens the NHWC activation before ``fc1``, so ``fc1``'s rows run in
(h, w, c) order; the port flattens the channels-last view, which is in the
same order, and so takes ``fc1`` as it is.

Dropout (rate 0.5 after ``fc1`` and after ``fc2``) runs only when the
forward is given a generator, ``model(x, dropout_generator=g)``: each
keep-mask is drawn from it (on its device, then moved to x's) and applied
as ``where(keep, x / (1 - rate), 0)``, Flax's ``nn.Dropout``. PyTorch's
``F.dropout`` draws from the global generator instead.
``harness.make_train_fn(has_dropout=True)`` passes one re-seeded with 0
every step, as the JAX step re-seeds its dropout key; without one
(inference, or a train step with dropout off) no unit is dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d

CFG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M")
DROPOUT_RATE = 0.5


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype, whatever the weight's
    (Flax's ``Dense(dtype=...)`` beside its ``param_dtype``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: keep each unit with probability 1 - rate
    (drawn from ``generator``) and scale it by 1 / (1 - rate); the identity
    without a generator."""
    if generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device).to(x.device) >= rate
    return torch.where(keep, x / (1 - rate), 0)


class VGG16(nn.Module):
    """VGG-16 for ``image_size`` x ``image_size`` inputs (``fc1``'s width
    follows from it, as Flax infers it from the input)."""

    def __init__(self, num_classes: int = 1000, image_size: int = 224,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        channels, side, n_convs = 3, image_size, 0
        for item in CFG16:
            if item == "M":
                side //= 2
                continue
            n_convs += 1
            self.add_module(f"conv{n_convs}", Conv2d(
                channels, item, 3, padding=1, dtype=param_dtype))
            channels = item
        self.fc1 = Linear(channels * side * side, 4096, dtype=param_dtype)
        self.fc2 = Linear(4096, 4096, dtype=param_dtype)
        self.head = Linear(4096, num_classes)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor,
                dropout_generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """x: [B, H, W, 3] (NHWC) -> logits [B, num_classes] fp32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        n_convs = 0
        for item in CFG16:
            if item == "M":
                x = F.max_pool2d(x, 2, stride=2)
            else:
                n_convs += 1
                x = F.relu(getattr(self, f"conv{n_convs}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c)
        x = dropout(F.relu(self.fc1(x)), DROPOUT_RATE, dropout_generator)
        x = dropout(F.relu(self.fc2(x)), DROPOUT_RATE, dropout_generator)
        return self.head(x.float())
