"""LSTM sequence classifier in PyTorch — benchmark case 5.x (batch 100
inference, 1024 hidden x 300-dim embeddings; ``docs/benchmark.md:30-31``).

Counterpart of ``k8s_device_plugin_tpu/workloads/lstm.py`` in its
``PallasLSTMCell`` layout: one parameter set (``cell.wx`` [F, 4H],
``cell.wh`` [H, 4H], ``cell.b`` [4H], in ``dtype``) drives the fused cell
(:func:`pallas_ops.lstm_cell`) over a Python loop on time, and an fp32
``head`` reads the last hidden state. The stock ``OptimizedLSTMCell``
layout is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from .pallas_ops import lstm_cell


class LSTMCell(nn.Module):
    """Parameters of the fused cell, in the Flax layout."""

    def __init__(self, features: int, hidden: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = hidden
        self.wx = nn.Parameter(torch.empty(features, 4 * hidden, dtype=dtype))
        self.wh = nn.Parameter(torch.empty(hidden, 4 * hidden, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(4 * hidden, dtype=dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's initializers for the cell: xavier-uniform ``wx``,
        orthogonal ``wh``, zero ``b``."""
        # drawn in fp32: QR, which orthogonal_ needs, has no bf16 kernel
        for p, init in ((self.wx, nn.init.xavier_uniform_),
                        (self.wh, nn.init.orthogonal_)):
            p.copy_(init(torch.empty(p.shape), generator=generator))
        self.b.zero_()

    def forward(self, h, c, x):
        return lstm_cell(x, h, c, self.wx, self.wh, self.b)


class LSTMClassifier(nn.Module):
    def __init__(self, features: int, hidden: int = 1024,
                 num_classes: int = 2, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.cell = LSTMCell(features, hidden, dtype=dtype)
        self.head = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [batch, time, features] -> logits [batch, num_classes] fp32."""
        # time-major once, so every step's slice is contiguous
        xs = x.to(self.dtype).transpose(0, 1).contiguous()
        h = torch.zeros(x.shape[0], self.cell.hidden, dtype=self.dtype,
                        device=x.device)
        c = h
        for x_t in xs:
            h, c = self.cell(h, c, x_t)
        return self.head(h.float())
