"""The fused LSTM cell: a hand-written CUDA kernel and its plain version.

Counterpart of ``k8s_device_plugin_tpu/workloads/pallas_ops.py``. On a CUDA
tensor :func:`lstm_cell` launches ``csrc/lstm_cell.cu`` (see its header for
what bounds it and how it is laid out); on a CPU tensor it runs
:func:`lstm_cell_reference`, the same math in plain PyTorch. Unlike the TPU
kernel it has no alignment rule: the kernel masks ragged B, F and H, so
ai-benchmark case 5.1 (B=100, F=300, H=1024) runs through it.

Layout follows the JAX package: x [B, F], h/c [B, H], wx [F, 4H],
wh [H, 4H], b [4H], gates in [i|f|g|o] order.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dtype, x, h, c, wx, wh, b, h_out, c_out, rows, features, hidden, stream
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def lstm_cell_reference(x, h, c, wx, wh, b):
    """The unfused math in fp32, cast back to the h/c dtypes."""
    gates = (x.float() @ wx.float() + h.float() @ wh.float() + b.float())
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def lstm_cell(x, h, c, wx, wh, b):
    """One fused LSTM step; returns (h', c')."""
    if x.device.type == "cpu":
        return lstm_cell_reference(x, h, c, wx, wh, b)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell: no kernel for device {x.device}")
    batch, features = x.shape
    hidden = h.shape[-1]
    shapes = {"x": (x, (batch, features)), "h": (h, (batch, hidden)),
              "c": (c, (batch, hidden)), "wx": (wx, (features, 4 * hidden)),
              "wh": (wh, (hidden, 4 * hidden)), "b": (b, (4 * hidden,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm_cell: {name} has shape {tuple(t.shape)},"
                             f" expected {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"lstm_cell: {name} is {t.dtype} on {t.device};"
                             f" every input must be {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell: {name} is not contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"lstm_cell: no kernel for {x.dtype}")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    lib = _build.load("lstm_cell", _ARGTYPES)
    err = lib.vtpu_lstm_cell(
        _DTYPES[x.dtype], x.data_ptr(), h.data_ptr(), c.data_ptr(),
        wx.data_ptr(), wh.data_ptr(), b.data_ptr(), h_out.data_ptr(),
        c_out.data_ptr(), batch, features, hidden,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "lstm_cell")
    lstm_cell.launches += 1
    return h_out, c_out


#: kernel launches since the last reset (CPU calls do not count)
lstm_cell.launches = 0
