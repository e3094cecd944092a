"""Eval BatchNorm + ReLU in one pass, alone or after the residual add: a
hand-written CUDA kernel and its plain version.

:func:`bn_relu` is ``relu(bn(x))`` and :func:`add_bn_relu` is
``s = a + b, relu(bn(s))``, with ``bn`` a BatchNorm module in eval form
(its running statistics, weight, bias and eps). On channels-last bf16
CUDA activations with C % 8 == 0 they launch ``csrc/bn_relu.cu``, which
makes one pass over memory where ATen makes two or three; they raise on
any other input. :func:`bn_relu_reference` and
:func:`add_bn_relu_reference` are the same functions in the modules' own
ops, ``F.relu(bn(x))`` and the add: the ResNet's loop
(``resnet.ResNetV2``) takes them in training and on inputs other than
bf16 on CUDA. The kernel rounds where those ops round (the sum to bf16, then
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

# x, y, mean, var, weight, bias, eps, rows, channels, stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p])
# a, b, s (nullable), y, then as above
_ADD_ARGTYPES = [ctypes.c_void_p] * 2 + _ARGTYPES


def bn_relu_reference(x: torch.Tensor, bn) -> torch.Tensor:
    """``F.relu(bn(x))``: the module's own ops, in training as in eval."""
    return F.relu(bn(x))


def add_bn_relu_reference(a: torch.Tensor, b: torch.Tensor, bn,
                          keep_sum: bool = True):
    """``(a + b, F.relu(bn(a + b)))``; the sum is None unless kept."""
    s = a + b
    return (s if keep_sum else None), bn_relu_reference(s, bn)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bn_relu", _ARGTYPES)
    if lib.vtpu_add_bn_relu.argtypes is None:
        lib.vtpu_add_bn_relu.argtypes = _ADD_ARGTYPES
        lib.vtpu_add_bn_relu.restype = ctypes.c_int
    return lib


def _checked(what: str, bn, x: torch.Tensor, *others: torch.Tensor) -> list:
    """Raise unless ``x`` and ``others`` are channels-last bf16 CUDA
    activations of one shape with C % 8 == 0, 16-byte aligned, and
    ``bn``'s four vectors are fp32 [C] on the same card; returns the
    pointer arguments that follow the activations': mean, var, weight,
    bias, eps, rows, channels and the current stream."""
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
    return [*args, bn.eps, x.numel() // channels, channels,
            torch._C._cuda_getCurrentRawStream(card)]


def bn_relu(x: torch.Tensor, bn) -> torch.Tensor:
    """``relu(bn(x))`` in one kernel pass (see the module docstring)."""
    args = _checked("bn_relu", bn, x)
    y = torch.empty_like(x)
    lib = _lib()
    err = lib.vtpu_bn_relu(x.data_ptr(), y.data_ptr(), *args)
    _build.check(lib, err, "bn_relu")
    bn_relu.launches += 1
    return y


def add_bn_relu(a: torch.Tensor, b: torch.Tensor, bn,
                keep_sum: bool = True):
    """``(a + b, relu(bn(a + b)))`` in one kernel pass; the sum is written
    only when kept, else None is returned in its place."""
    args = _checked("add_bn_relu", bn, a, b)
    s = torch.empty_like(a) if keep_sum else None
    y = torch.empty_like(a)
    lib = _lib()
    err = lib.vtpu_add_bn_relu(a.data_ptr(), b.data_ptr(),
                               None if s is None else s.data_ptr(),
                               y.data_ptr(), *args)
    _build.check(lib, err, "add_bn_relu")
    add_bn_relu.launches += 1
    return s, y


#: kernel launches since the last reset (the plain versions do not count)
bn_relu.launches = 0
add_bn_relu.launches = 0
