"""Weights and inputs made from ``--seed``, on the device, in few calls.

The tenants and the reference call the same functions with the same seed
and get the same bits: the port's model is filled from :func:`make`, the
reference reads the same tensors in fp32. Every stream is derived from the
seed and a label, so any whole number is a valid seed. ``torch`` is
imported where it is used: the supervisor imports this module and starts
its tenants before it loads ``torch`` itself.
"""

from __future__ import annotations

import hashlib
import importlib
import math


def derive(seed: int, *labels) -> int:
    """A 63-bit seed for the stream ``labels`` of run ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + labels).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *labels):
    import torch
    return torch.Generator(device=device).manual_seed(derive(seed, *labels))


def reference(cfg):
    """The plain reference module of ``cfg``'s model."""
    return importlib.import_module(f"vgpu_bench.reference.{cfg['model']}")


def make(cfg, seed: int, device) -> dict:
    """The model's weights by name, each in its served dtype: one normal
    draw for all of them, cut in name order and scaled by its init."""
    import torch
    layout = reference(cfg).layout(cfg)
    names = sorted(layout)
    sizes = [math.prod(layout[n][0]) for n in names]
    z = torch.randn(sum(sizes), generator=generator(device, seed, "weights"),
                    device=device)
    out = {}
    for name, part in zip(names, torch.split(z, sizes)):
        shape, dtype, init = layout[name]
        if init[0] == "normal":
            value = part * init[1]
        elif init[0] == "around":
            value = init[1] + part * init[2]
        elif init[0] == "above":
            value = init[1] + part.abs() * init[2]
        else:
            raise ValueError(f"{name}: no init {init[0]!r}")
        out[name] = value.view(shape).to(dtype)
    return out


def inputs(cfg, seed: int, tenant: int, index: int, device):
    """Input batch ``index`` of ``tenant``'s pool: standard normal, in the
    served dtype, at the configuration's ``input_shape``."""
    import torch
    x = torch.randn(cfg["input_shape"],
                    generator=generator(device, seed, "input", tenant, index),
                    device=device)
    return x.to(getattr(torch, cfg["dtype"]))
