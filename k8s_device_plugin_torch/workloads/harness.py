"""Model set-up, inference, training and timing helpers for the port's
workloads.

Counterpart of the single-device part of
``k8s_device_plugin_tpu/workloads/harness.py`` (``init_model``,
``make_infer_fn``, ``cross_entropy``, ``seg_cross_entropy``,
``make_train_fn``, ``init_train_state``, ``timed_warmup``, ``time_fn``),
with ``torch.cuda.synchronize`` where JAX waits with ``block_until_ready``.
The JAX train state's ``params`` and ``batch_stats`` live in the module,
its ``opt_state`` in a ``torch.optim`` optimizer. Meshes and the compile
cache are not ported yet.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F
from torch import nn


def synchronize(device: torch.device | str) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def init_model(model: nn.Module, seed: int = 0,
               device: str = "cuda") -> nn.Module:
    """Random weights from ``seed``, with Flax's default initializers:
    lecun-normal conv and dense kernels, zero biases, identity BatchNorm
    (the module defaults). A module with initializers of its own defines
    ``init_weights(generator)``, which is called in its place. Returns the
    model on ``device`` in eval mode."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif hasattr(m, "init_weights"):
            m.init_weights(g)
    return model.to(device).eval()


def make_infer_fn(model: nn.Module):
    """(batch) -> logits, without autograd bookkeeping."""
    def infer(batch):
        with torch.inference_mode():
            return model(batch)
    return infer


def cross_entropy(logits, labels):
    """Mean negative log-likelihood in fp32 of ``labels`` [...] under
    class-last ``logits`` [..., C]: [B, C] for a classifier, [B, T, V] for
    the LM's next token."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


#: the segmentation loss over channels-last [B, H, W, C] logits: the same
#: class-last mean (``F.cross_entropy`` would want the classes at dim 1)
seg_cross_entropy = cross_entropy


def sgd(model: nn.Module, lr: float = 1e-3,
        momentum: float = 0.9) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum)``: without dampening or Nesterov both
    momentum buffers start at the first gradient and the updates agree;
    ``momentum=0`` is plain ``p - lr * g``."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                           dampening=0.0, nesterov=False)


def init_train_state(model: nn.Module) -> dict:
    """Put ``model`` (weights from :func:`init_model` or a state_dict) in
    train mode and start the step counter: ``{"step": 0}``."""
    model.train()
    return {"step": 0}


def make_train_fn(model: nn.Module, optimizer: torch.optim.Optimizer,
                  loss_fn=cross_entropy):
    """(state, batch, labels) -> (state, loss): one step of ``optimizer``
    on ``loss_fn(model(batch), labels)``; BatchNorm statistics update in
    the forward, as the JAX step's mutable ``batch_stats``."""
    def train_step(state, batch, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(batch), labels)
        loss.backward()
        optimizer.step()
        return {"step": state["step"] + 1}, loss.detach()
    return train_step


def count_flops(model: nn.Module, batch: torch.Tensor) -> int:
    """Forward FLOPs for ``batch``, counted from the model's own conv and
    linear layers at 2 FLOPs per multiply-add (one forward pass runs)."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        if isinstance(mod, nn.Conv2d):
            macs = mod.in_channels // mod.groups * mod.kernel_size[0] \
                * mod.kernel_size[1]
        else:
            macs = mod.in_features
        total += 2 * out.numel() * macs

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        make_infer_fn(model)(batch)
    finally:
        for h in handles:
            h.remove()
    return total


def timed_warmup(call, device) -> tuple[float, float]:
    """(compile_s, warm_step_s): the first call pays lazy set-up (CUDA
    context, cuDNN algorithm search, kernel builds) plus one execution,
    the second is pure execution; the difference is the cold-start cost."""
    t0 = time.perf_counter()
    call()
    synchronize(device)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    call()
    synchronize(device)
    warm = time.perf_counter() - t0
    return max(0.0, first - warm), warm


def time_fn(fn, *args, device, iters: int = 10, warmup: int = 2) -> float:
    """Simple wall timing; returns seconds per iteration."""
    for _ in range(warmup):
        fn(*args)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    synchronize(device)
    return (time.perf_counter() - t0) / iters
