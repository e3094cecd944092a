"""Faults planted under a rehearsal's timed path (``tenant.py``'s
``wrap``): each must turn ``correct`` false."""

import torch


def altered_answer(infer):
    """Every call answers its first row with the second row's logits."""
    def call(x):
        y = infer(x).clone()
        y[0] = y[1]
        return y
    return call


def half_batch(infer):
    """Every call computes half of its batch and repeats it for the rest."""
    def call(x):
        y = infer(x[: x.shape[0] // 2])
        return torch.cat([y, y])[: x.shape[0]]
    return call


def raises(infer):
    """Every other call after the warm-up fails, as a call whose
    allocation the shim refuses."""
    count = 0

    def call(x):
        nonlocal count
        count += 1
        if count > 20 and count % 2:
            raise RuntimeError("CUDA error: out of memory (planted)")
        return infer(x)
    return call
