"""Eval BatchNorm + ReLU in one pass, alone or after the residual add: a
hand-written CUDA kernel and its plain version.

:func:`bn_relu` is ``relu(bn(x))`` and :func:`add_bn_relu` is
``s = a + b, relu(bn(s))``, with ``bn`` a BatchNorm module in eval form
(its running statistics, weight, bias and eps). On bf16 CUDA activations
with ``bn`` in eval they launch ``csrc/bn_relu.cu``, which makes one pass
over memory where ATen makes two or three, and raise on what that kernel
does not take (a layout other than channels-last, C % 8 != 0, a
misaligned input, the BatchNorm's vectors other than fp32 [C] on the same
card). On CPU tensors, dtypes other than bf16 and a BatchNorm in training
they take :func:`bn_relu_reference` and :func:`add_bn_relu_reference`,
the same functions in the modules' own ops, ``F.relu(bn(x))`` and the
add. The kernel rounds where those ops round (the sum to bf16, then
BatchNorm in fp32 rounded to bf16), so the two agree to the last bit but
for the sign of a zero.

There is no TPU counterpart: XLA fused these ops into the convolutions'
neighbours by itself.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

# x, y, mean, var, weight, bias, eps, rows, channels
BN_RELU = _build.Kernel(
    "bn_relu", "vtpu_bn_relu",
    [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int])
# a, b, s (nullable), y, then as above from mean on
ADD_BN_RELU = _build.Kernel(
    "bn_relu", "vtpu_add_bn_relu",
    [ctypes.c_void_p] * 8 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int])


def bn_relu_reference(x: torch.Tensor, bn) -> torch.Tensor:
    """``F.relu(bn(x))``: the module's own ops, in training as in eval."""
    return F.relu(bn(x))


def add_bn_relu_reference(a: torch.Tensor, b: torch.Tensor, bn,
                          keep_sum: bool = True):
    """``(a + b, F.relu(bn(a + b)))``; the sum is None unless kept."""
    s = a + b
    return (s if keep_sum else None), bn_relu_reference(s, bn)


def _kernel_takes(x: torch.Tensor, bn) -> bool:
    """Whether ``x`` and ``bn`` are the kernel's to take: bf16 on a card,
    the BatchNorm in eval (the kernel has no statistics update)."""
    return x.is_cuda and x.dtype == torch.bfloat16 and not bn.training


def _checked(what: str, bn, x: torch.Tensor, *others: torch.Tensor) -> list:
    """Raise unless ``x`` and ``others`` are channels-last bf16 CUDA
    activations of one shape with C % 8 == 0, 16-byte aligned, and
    ``bn``'s four vectors are fp32 [C] on the same card; returns the
    arguments that follow the activations': mean, var, weight, bias, eps,
    rows and channels."""
    for t in (x, *others):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: no kernel for {t.dtype}, only bf16")
        if t.dim() != 4 or not t.is_contiguous(
                memory_format=torch.channels_last):
            raise ValueError(f"{what}: the input must be a channels-last "
                             f"contiguous [N, C, H, W] tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: the input is not 16-byte aligned")
    for t in others:
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{what}: inputs of shape {tuple(t.shape)} on "
                             f"{t.device} and {tuple(x.shape)} on {x.device}")
    channels = x.shape[1]
    if channels % 8:
        raise ValueError(f"{what}: {channels} channels; the kernel reads 8 "
                         f"at a time")
    if not x.is_cuda:
        raise ValueError(f"{what}: no kernel for device {x.device}")
    card = x.get_device()
    args = []
    for v in (bn.running_mean, bn.running_var, bn.weight, bn.bias):
        if v is None or v.dtype != torch.float32 or v.get_device() != card \
                or v.numel() != channels or not v.is_contiguous():
            raise ValueError(f"{what}: the BatchNorm's running statistics, "
                             f"weight and bias must be fp32 [{channels}] on "
                             f"{x.device}")
        args.append(v.data_ptr())
    return [*args, bn.eps, x.numel() // channels, channels]


def bn_relu(x: torch.Tensor, bn) -> torch.Tensor:
    """``relu(bn(x))`` in one kernel pass, or :func:`bn_relu_reference`
    where the kernel is not the one to run (see the module docstring)."""
    if not _kernel_takes(x, bn):
        return bn_relu_reference(x, bn)
    args = _checked("bn_relu", bn, x)
    y = torch.empty_like(x)
    BN_RELU(x, x.data_ptr(), y.data_ptr(), *args)
    return y


def add_bn_relu(a: torch.Tensor, b: torch.Tensor, bn,
                keep_sum: bool = True):
    """``(a + b, relu(bn(a + b)))`` in one kernel pass, or
    :func:`add_bn_relu_reference` where the kernel is not the one to run;
    the sum is written only when kept, else None is returned in its
    place."""
    if not _kernel_takes(a, bn):
        return add_bn_relu_reference(a, b, bn, keep_sum)
    args = _checked("add_bn_relu", bn, a, b)
    s = torch.empty_like(a) if keep_sum else None
    y = torch.empty_like(a)
    ADD_BN_RELU(a, a.data_ptr(), b.data_ptr(),
                None if s is None else s.data_ptr(), y.data_ptr(), *args)
    return s, y
