"""The LSTM's FLOP per sequence and K2's (``lstm_cell``) cost per launch."""

from __future__ import annotations

import torch


def flops_per_item(cfg) -> int:
    """2 x 4H x (F + H) per step, and the head."""
    f, h = cfg["features"], cfg["hidden"]
    return cfg["time_steps"] * 2 * 4 * h * (f + h) \
        + 2 * h * cfg["num_classes"]


def kernel_cost(cfg) -> dict:
    """One step of the fused cell: reads x [B, F], h and c [B, H], wx
    [F, 4H], wh [H, 4H] and b [4H] once, writes h and c [B, H] once."""
    b, f, h = cfg["batch"], cfg["features"], cfg["hidden"]
    size = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
    elements = b * f + 2 * b * h + f * 4 * h + h * 4 * h + 4 * h + 2 * b * h
    return {"lstm_cell": (2 * b * 4 * h * (f + h), elements * size)}
