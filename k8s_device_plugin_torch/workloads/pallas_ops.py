"""The fused LSTM cell: a hand-written CUDA kernel and its plain version.

Counterpart of ``k8s_device_plugin_tpu/workloads/pallas_ops.py``. On a CUDA
tensor :func:`lstm_cell` launches ``csrc/lstm_cell.cu`` by the route
:func:`cell_route` picks (see the kernel's header for what bounds it and
how each route is laid out); on a CPU tensor it runs
:func:`lstm_cell_reference`, the same math in plain PyTorch. Unlike the TPU
kernel it has no alignment rule: the kernel masks ragged B, F and H, so
ai-benchmark case 5.1 (B=100, F=300, H=1024) runs through it.

Layout follows the JAX package: x [B, F], h/c [B, H], wx [F, 4H],
wh [H, 4H], b [4H], gates in [i|f|g|o] order.

:func:`lstm_sequence` runs the cell over a whole sequence xs [T, B, F]:
on the card, where :func:`sequence_route` allows (bf16, autograd not
recording, B <= 128, F % 4 == 0, H % 16 == 0, the grid resident), as one
persistent launch of the kernel's sequence entry (weights held on chip
for all T steps, a grid barrier a step), counted in
``_build.launches["lstm_sequence"]``; on the CPU as a loop of
:func:`lstm_cell_reference`. The classifier takes it in place of its loop
of :func:`lstm_cell` where the route holds.

Gradients: where autograd records, :func:`lstm_cell` runs as a
``torch.autograd.Function`` whose backward recomputes
:func:`lstm_cell_reference` from the saved inputs and differentiates it,
on both devices. Where it records nothing (the runner's infer path) the
forward runs without the Function: on an H100's host, going through it
on each of case 5.1's 64 steps cost 19-37% of the items/s
(``PERF.md`` §6). The JAX package has no backward kernel either: at the
case-5 shapes its ``lstm_cell`` takes the jnp path, which JAX
differentiates.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: kernel routes by name: fp32 on FMA; bf16 with element-wise loads; bf16
#: through the cp.async ring and wgmma (see the kernel's header)
ROUTES = {"fma": 0, "elementwise": 1, "ring": 2}
# route, x, h, c, wx, wh, b, h_out, c_out, rows, features, hidden
LSTM_CELL = _build.Kernel(
    "lstm_cell", "vtpu_lstm_cell",
    [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3)


def cell_route(x, h, wx, wh) -> str:
    """The kernel route for these inputs: fp32 on FMA; bf16 through the
    ring where its 8- and 16-byte copies fit (F % 4 == 0, H % 16 == 0,
    x 8-byte and h, wx, wh 16-byte aligned), else element-wise loads."""
    if x.dtype == torch.float32:
        return "fma"
    features, hidden = x.shape[-1], h.shape[-1]
    fits = (features % 4 == 0 and hidden % 16 == 0 and x.data_ptr() % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (h, wx, wh)))
    return "ring" if fits else "elementwise"


def lstm_cell_reference(x, h, c, wx, wh, b):
    """The unfused math in fp32, cast back to the h/c dtypes."""
    gates = (x.float() @ wx.float() + h.float() @ wh.float() + b.float())
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


class _Cell(torch.autograd.Function):
    """The cell with a recompute backward: the forward is the kernel (CUDA)
    or the plain cell (CPU); the backward differentiates the plain cell on
    the saved inputs."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return _cell(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, dh, dc):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            grads = iter(torch.autograd.grad(
                lstm_cell_reference(*inputs),
                [t for t in inputs if t.requires_grad], (dh, dc)))
        return tuple(next(grads) if need else None for need in needs)


def lstm_cell(x, h, c, wx, wh, b):
    """One fused LSTM step; returns (h', c'). Differentiable in every
    input (see the module docstring)."""
    args = (x, h, c, wx, wh, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Cell.apply(*args)
    return _cell(*args)


def _cell(x, h, c, wx, wh, b):
    """The cell's forward: the plain cell on a CPU tensor; on a CUDA one,
    check the inputs and launch the kernel by :func:`cell_route`."""
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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lstm_cell: no kernel for {x.dtype}")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    route = cell_route(x, h, wx, wh)
    LSTM_CELL(x, ROUTES[route], x.data_ptr(), h.data_ptr(), c.data_ptr(),
              wx.data_ptr(), wh.data_ptr(), b.data_ptr(), h_out.data_ptr(),
              c_out.data_ptr(), batch, features, hidden,
              label=f"lstm_cell ({route})")
    return h_out, c_out


# xs, its row stride, h0, c0, wx, wh, b, hbuf, c_out, bar, steps, rows,
# features, hidden
LSTM_SEQUENCE = _build.Kernel(
    "lstm_cell", "vtpu_lstm_sequence",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 4)
#: the most rows of the batch the sequence route holds: two m64 slabs
SEQUENCE_ROWS = 128
#: one zeroed barrier word per (device, stream), kept for every launch
_BARRIERS: dict = {}


def sequence_fits(device_type: str, dtype, recording: bool, batch: int,
                  features: int, hidden: int) -> bool:
    """The shape rule of the sequence route: bf16 on a CUDA device, no
    autograd recording (the recompute backward needs every step's inputs),
    1 <= B <= 128, F % 4 == 0 and H % 16 == 0 (a block pair owns 16
    hidden columns). Whether its grid is resident on the card is
    :func:`sequence_route`'s further question."""
    return (device_type == "cuda" and dtype == torch.bfloat16
            and not recording and 0 < batch <= SEQUENCE_ROWS
            and features > 0 and features % 4 == 0
            and hidden > 0 and hidden % 16 == 0)


@functools.lru_cache(maxsize=None)
def _resident(device: int, batch: int, features: int, hidden: int) -> bool:
    """Whether the sequence route's whole grid fits on card ``device`` at
    once (``vtpu_lstm_sequence_resident``): asked once per shape."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.query("lstm_cell", "vtpu_lstm_sequence_resident",
                     [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
                     batch, features, hidden, ctypes.byref(out))
    return bool(out.value)


def sequence_route(xs, h0, c0, wx, wh, b) -> bool:
    """True where :func:`lstm_sequence` runs these inputs as one launch:
    :func:`sequence_fits`, h0, wx and wh 16-byte aligned, and the grid
    resident on the card. Otherwise the caller loops :func:`lstm_cell`,
    step by step."""
    args = (xs, h0, c0, wx, wh, b)
    recording = torch.is_grad_enabled() and any(t.requires_grad
                                                for t in args)
    if xs.dim() != 3 or not sequence_fits(
            xs.device.type, xs.dtype, recording, xs.shape[1], xs.shape[2],
            h0.shape[-1]):
        return False
    if any(t.data_ptr() % 16 for t in (h0, wx, wh)):
        return False
    return _resident(xs.device.index, *xs.shape[1:], h0.shape[-1])


def _padded(xs):
    """(xs, row stride): xs [T, B, F] as the sequence route reads it
    through TMA, rows a multiple of 8 elements (16 bytes) apart and
    16-byte aligned; a copy into such a layout (its pad columns never
    read) unless xs has it already."""
    steps, batch, features = xs.shape
    ld = -(-features // 8) * 8
    if (xs.stride() == (batch * ld, ld, 1) and xs.data_ptr() % 16 == 0):
        return xs, ld
    out = torch.empty(steps, batch, ld, dtype=xs.dtype,
                      device=xs.device)[..., :features]
    out.copy_(xs)
    return out, ld


def lstm_sequence(xs, h0, c0, wx, wh, b):
    """The cell over a whole sequence, xs [T, B, F] (any strides) from
    (h0, c0) [B, H]; returns (h_T, c_T). On a CPU tensor a loop of
    :func:`lstm_cell_reference`; on a CUDA one, one launch of the kernel's
    sequence route (``csrc/lstm_cell.cu``, ``seq``), which
    :func:`sequence_route` must allow: else it raises. Not
    differentiable: a training forward loops :func:`lstm_cell`."""
    if xs.device.type == "cpu":
        h, c = h0, c0
        for x_t in xs:
            h, c = lstm_cell_reference(x_t, h, c, wx, wh, b)
        return h, c
    steps, batch, features = xs.shape
    hidden = h0.shape[-1]
    shapes = {"h0": (h0, (batch, hidden)), "c0": (c0, (batch, hidden)),
              "wx": (wx, (features, 4 * hidden)),
              "wh": (wh, (hidden, 4 * hidden)), "b": (b, (4 * hidden,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != xs.dtype \
                or t.device != xs.device or not t.is_contiguous():
            raise ValueError(f"lstm_sequence: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected a "
                             f"contiguous {xs.dtype} {shape} on {xs.device}")
    if not sequence_route(xs, h0, c0, wx, wh, b):
        raise ValueError(
            f"lstm_sequence: no sequence route for {xs.dtype} "
            f"[{steps}, {batch}, {features}] x {hidden} on {xs.device}; "
            "loop lstm_cell")
    return sequence_launch(xs, h0, c0, wx, wh, b)


def sequence_launch(xs, h0, c0, wx, wh, b):
    """:func:`lstm_sequence`'s launch on the card without its checks: for
    a caller whose tensors have the cell's shapes and for which
    :func:`sequence_route` has said yes (the classifier)."""
    steps, batch, features = xs.shape
    hidden = h0.shape[-1]
    if steps == 0:
        return h0, c0
    stream = torch.cuda.current_stream(xs.device)
    bar = _BARRIERS.get((xs.device, stream.cuda_stream))
    if bar is None:
        bar = _BARRIERS[xs.device, stream.cuda_stream] = torch.zeros(
            1, dtype=torch.int32, device=xs.device)
    xs, ld = _padded(xs)
    hbuf = torch.empty(2, batch, hidden, dtype=xs.dtype, device=xs.device)
    c_out = torch.empty_like(c0)
    LSTM_SEQUENCE(xs, xs.data_ptr(), ld, h0.data_ptr(), c0.data_ptr(),
                  wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
                  hbuf.data_ptr(), c_out.data_ptr(), bar.data_ptr(), steps,
                  batch, features, hidden)
    return hbuf[steps % 2], c_out
