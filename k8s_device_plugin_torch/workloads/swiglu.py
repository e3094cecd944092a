"""LFM2-MoE's SwiGLU and gate in one pass: a hand-written CUDA kernel (K6)
and its plain version.

:func:`swiglu_gate` takes ``h13`` [..., 2F], the product of a layer's
input with W1 and W3 side by side (W1's half first), and an optional gate
``g`` with one value a row, and gives ``a = silu(h1) * h3 * g`` [..., F],
the input of the layer's W2. On bf16 CUDA tensors it launches
``csrc/swiglu.cu``, one pass over memory where ATen makes three (the SiLU
and two multiplies over strided halves and a broadcast gate), and raises
on what that kernel does not take (F % 8 != 0, a non-contiguous or
misaligned ``h13``, a gate of another dtype, device or length). On CPU
tensors and dtypes other than bf16 it takes :func:`swiglu_gate_reference`,
the same chain in ATen's ops. The kernel rounds to bf16 where those ops
round, so the two agree to the last bit.

There is no TPU counterpart: LFM2 has no JAX version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

# h13, g (nullable), a, rows, hidden
SWIGLU_GATE = _build.Kernel(
    "swiglu", "vtpu_swiglu_gate",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int])


def swiglu_gate_reference(h13: torch.Tensor,
                          g: torch.Tensor | None = None) -> torch.Tensor:
    """``silu(h1) * h3`` (``* g`` per row when given) in ATen's ops, in
    that order and in ``h13``'s dtype."""
    h1, h3 = h13.chunk(2, dim=-1)
    a = F.silu(h1) * h3
    return a if g is None else a * g[..., None]


def _checked(h13: torch.Tensor, g: torch.Tensor | None) -> tuple[int, int]:
    """(rows, hidden) of a bf16 CUDA ``h13`` that the kernel takes; raises
    otherwise."""
    width = h13.shape[-1]
    if width % 16:
        raise ValueError(f"swiglu_gate: a row of {width} is not two halves "
                         f"of a multiple of 8; the kernel reads 8 at a "
                         f"time")
    if not h13.is_contiguous() or h13.data_ptr() % 16:
        raise ValueError("swiglu_gate: h13 must be contiguous and 16-byte "
                         "aligned")
    rows = h13.numel() // width
    if g is not None and (g.dtype != h13.dtype or g.device != h13.device
                          or g.shape != h13.shape[:-1]
                          or not g.is_contiguous()):
        raise ValueError(f"swiglu_gate: the gate must be a contiguous "
                         f"{h13.dtype} {list(h13.shape[:-1])} tensor on "
                         f"{h13.device}")
    return rows, width // 2


def swiglu_gate(h13: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
    """``silu(h1) * h3`` (``* g`` per row) in one kernel pass on bf16 CUDA
    tensors, else :func:`swiglu_gate_reference` (see the module
    docstring)."""
    if not h13.is_cuda or h13.dtype != torch.bfloat16:
        return swiglu_gate_reference(h13, g)
    rows, hidden = _checked(h13, g)
    a = h13.new_empty((*h13.shape[:-1], hidden))
    SWIGLU_GATE(h13, h13.data_ptr(), None if g is None else g.data_ptr(),
                a.data_ptr(), rows, hidden)
    return a
