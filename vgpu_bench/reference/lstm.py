"""The LSTM sequence classifier (Hochreiter and Schmidhuber, 1997) for
inference, in plain fp32, in the fused layout: one input kernel ``cell.wx``
[F, 4H], one hidden kernel ``cell.wh`` [H, 4H] and one bias ``cell.b``
[4H], the gates in order input, forget, cell, output. From zero state,
every step: gates = x_t wx + h wh + b; c = sigmoid(f) c + sigmoid(i)
tanh(g); h = sigmoid(o) tanh(c). A dense head reads the last h.
"""

from __future__ import annotations

import torch

from . import rounded


def layout(cfg) -> dict:
    """{name: (shape, dtype, init)}: the cell in the served dtype, the head
    in fp32 (see ``reference/resnet50.py`` for the inits)."""
    dtype = getattr(torch, cfg["dtype"])
    f, h, classes = cfg["features"], cfg["hidden"], cfg["num_classes"]
    return {
        "cell.wx": ((f, 4 * h), dtype, ("normal", f ** -0.5)),
        "cell.wh": ((h, 4 * h), dtype, ("normal", h ** -0.5)),
        "cell.b": ((4 * h,), dtype, ("around", 0.0, 0.1)),
        "head.weight": ((classes, h), torch.float32, ("normal", h ** -0.5)),
        "head.bias": ((classes,), torch.float32, ("around", 0.0, 0.1)),
    }


def forward(w: dict, x: torch.Tensor, cfg, precision: str = "fp32"):
    """Logits [B, classes] in fp32 of sequences ``x`` [B, T, F]."""
    w = {k: v.float() for k, v in w.items()}
    wx, wh = rounded(w["cell.wx"], precision), rounded(w["cell.wh"],
                                                       precision)
    x = x.float()
    h = c = torch.zeros(x.shape[0], cfg["hidden"], device=x.device)
    for t in range(x.shape[1]):
        gates = rounded(x[:, t], precision) @ wx \
            + rounded(h, precision) @ wh + w["cell.b"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return rounded(h, precision) @ rounded(w["head.weight"], precision).T \
        + w["head.bias"]
