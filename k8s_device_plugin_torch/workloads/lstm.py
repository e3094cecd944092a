"""LSTM sequence classifier in PyTorch — benchmark case 5.x (batch 100
inference, 1024 hidden x 300-dim embeddings; ``docs/benchmark.md:30-31``).

Counterpart of ``k8s_device_plugin_tpu/workloads/lstm.py``, in both of its
layouts, over a Python loop on time:

* ``use_pallas=True`` (the JAX ``PallasLSTMCell``, the port's default):
  one parameter set (``cell.wx`` [F, 4H], ``cell.wh`` [H, 4H], ``cell.b``
  [4H], in ``dtype``) drives the fused cell (:func:`pallas_ops.lstm_cell`,
  K2 on the card), and the fp32 ``head`` reads the last hidden state.
  Where :func:`pallas_ops.sequence_route` allows (a bf16 forward on the
  card that autograd does not record, B <= 128), the whole sequence is
  one launch of K2's persistent route (:func:`pallas_ops.sequence_launch`,
  the launch of :func:`pallas_ops.lstm_sequence`) in place of the loop;
* ``use_pallas=False`` (Flax's stock ``nn.OptimizedLSTMCell`` under
  ``nn.RNN``): input kernels ``ii``/``if``/``ig``/``io`` [F, H] without
  bias and hidden kernels ``hi``/``hf``/``hg``/``ho`` [H, H] with bias,
  kept in fp32 (Flax's ``param_dtype``) under the module name Flax gives
  the cell, ``OptimizedLSTMCell_0``; gates i, f, g, o computed in
  ``dtype``, the carry in fp32 as Flax's ``initialize_carry`` makes it,
  and the head reads ``y[:, -1]``, the last step's output.

The JAX runner takes the fused layout on a TPU and the stock one elsewhere
(``use_pallas=on_tpu``); the port's runner takes the fused layout on the
card and the stock one on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from .pallas_ops import lstm_cell, sequence_launch, sequence_route


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


#: Flax's gate order, and the names of one kernel per gate
GATES = ("i", "f", "g", "o")
#: the Flax module name of the stock cell inside ``LSTMClassifier``
STOCK_CELL = "OptimizedLSTMCell_0"


class _Dense(nn.Module):
    """One Flax ``DenseParams``: ``weight`` [out, in] (the Flax kernel,
    transposed) and, with ``bias``, ``bias`` [out]; fp32."""

    def __init__(self, features: int, hidden: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hidden, features))
        self.bias = nn.Parameter(torch.zeros(hidden)) if bias else None


class StockLSTMCell(nn.Module):
    """Flax's ``nn.OptimizedLSTMCell``: the four input kernels and the four
    hidden kernels (with their biases) are joined per call into one
    product each, as Flax joins them."""

    def __init__(self, features: int, hidden: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        for gate in GATES:
            self.add_module(f"i{gate}", _Dense(features, hidden, False))
            self.add_module(f"h{gate}", _Dense(hidden, hidden, True))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's initializers for the cell: lecun-normal input kernels
        (normal over sqrt(fan-in), as ``harness.init_model``), orthogonal
        hidden kernels, zero biases."""
        for gate in GATES:
            wi = getattr(self, f"i{gate}").weight
            wi.normal_(0.0, wi.shape[1] ** -0.5, generator=generator)
            hidden = getattr(self, f"h{gate}")
            nn.init.orthogonal_(hidden.weight, generator=generator)
            hidden.bias.zero_()

    def kernels(self):
        """(wi [F, 4H], wh [H, 4H], bh [4H]) in the cell's dtype, the
        gates in order i, f, g, o."""
        def cat(prefix, attr):
            return torch.cat([getattr(getattr(self, prefix + g), attr)
                              for g in GATES]).to(self.dtype)
        return cat("i", "weight").T, cat("h", "weight").T, cat("h", "bias")

    def forward(self, c, h, x, kernels):
        """One step on the carry (c, h), fp32, and x [B, F]: the gates in
        ``dtype``, the new carry in fp32 (Flax's dtype promotion)."""
        wi, wh, bh = kernels
        i, f, g, o = (h.to(self.dtype) @ wh + bh
                      + x.to(self.dtype) @ wi).chunk(4, dim=-1)
        i, f, g, o = i.sigmoid(), f.sigmoid(), g.tanh(), o.sigmoid()
        c = f * c + i * g
        return c, o * c.tanh()


class LSTMClassifier(nn.Module):
    """The classifier in the fused layout (``use_pallas``, the default) or
    the stock one; see the module docstring."""

    def __init__(self, features: int, hidden: int = 1024,
                 num_classes: int = 2, dtype: torch.dtype = torch.bfloat16,
                 use_pallas: bool = True):
        super().__init__()
        self.dtype, self.hidden, self.use_pallas = dtype, hidden, use_pallas
        if use_pallas:
            self.cell = LSTMCell(features, hidden, dtype=dtype)
        else:
            self.add_module(STOCK_CELL,
                            StockLSTMCell(features, hidden, dtype=dtype))
        self.head = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [batch, time, features] -> logits [batch, num_classes] fp32."""
        # time-major; the loops copy it once so that every step's slice
        # is contiguous, the sequence route lays it out for itself
        xs = x.to(self.dtype).transpose(0, 1)
        if not self.use_pallas:
            cell = getattr(self, STOCK_CELL)
            kernels = cell.kernels()
            c = h = torch.zeros(x.shape[0], self.hidden, device=x.device)
            for x_t in xs.contiguous():
                c, h = cell(c, h, x_t, kernels)
            return self.head(h.float())
        h = torch.zeros(x.shape[0], self.hidden, dtype=self.dtype,
                        device=x.device)
        c = h
        args = (xs, h, c, self.cell.wx, self.cell.wh, self.cell.b)
        if sequence_route(*args):  # one launch for all T steps
            h, _ = sequence_launch(*args)
        else:
            for x_t in xs.contiguous():
                h, c = self.cell(h, c, x_t)
        return self.head(h.float())
