"""Pipeline parallelism: the ``pp`` sharding axis.

Counterpart of ``k8s_device_plugin_tpu/workloads/pipeline.py``: a GPipe
schedule of microbatches over stages that live on a ``pp`` mesh axis (rank
s of the axis holds stage s, its block ``[1, ...]`` of the stacked
``w_in`` [S, D, F] and ``w_out`` [S, F, D], ``harness.shard_params``). The
schedule runs M + S - 1 steps; at each, every stage applies itself to the
activation it holds and hands the result one stage down. The bubble is
steps whose inputs are ignored and whose outputs are masked out, as JAX
expresses it in one static ``lax.scan``.

JAX differentiates the scan as one global program. Here every rank runs
its own program and back-propagates its own share of the loss, so every
rank must run the same collectives in the same order, backward too: the
masks are ``torch.where`` on tensors, never Python branches on the stage,
so each rank's graph holds every hand-off and the sum that replicates the
outputs, and their backward collectives run on every rank (with zero
cotangents where a mask drops a value). The hand-off is
``collectives.ring_shift``: the wrap from the last stage to stage 0 is
never read (stage 0 takes its microbatch instead), so its cotangent is 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import collectives


class Stages(nn.Module):
    """The stacked residual-MLP stage weights: ``w_in`` [S, D, F] and
    ``w_out`` [S, F, D] (a rank of the pipeline holds its stage's
    ``[1, ...]`` block)."""

    def __init__(self, n_stages: int, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_in = nn.Parameter(torch.empty(n_stages, dim, hidden,
                                             dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(n_stages, hidden, dim,
                                              dtype=dtype))


@torch.no_grad()
def init_stage_params(generator: torch.Generator, n_stages: int, dim: int,
                      hidden: int, dtype=torch.float32,
                      device: str | torch.device = "cuda") -> Stages:
    """Stage weights with JAX's scales: ``w_in`` normal / sqrt(dim),
    ``w_out`` normal / sqrt(hidden), drawn in fp32 on the CPU from
    ``generator``."""
    stages = Stages(n_stages, dim, hidden, dtype)
    stages.w_in.copy_(torch.randn(stages.w_in.shape, generator=generator)
                      / math.sqrt(dim))
    stages.w_out.copy_(torch.randn(stages.w_out.shape, generator=generator)
                       / math.sqrt(hidden))
    return stages.to(device)


def stage_fn(w_in, w_out, x):
    """One stage: a residual MLP, x + gelu(x W_in) W_out, in fp32 (the
    tanh gelu, ``jax.nn.gelu``'s default), the residual in x's dtype."""
    h = F.gelu(x.float() @ w_in.float(), approximate="tanh")
    return x + (h @ w_out.float()).to(x.dtype)


def pipeline_forward(params: Stages, x_mb, mesh):
    """x_mb: this rank's [M, B/dp, D] block of the microbatches (the token
    dim B split over ``dp`` when the mesh has it), ``params`` this rank's
    stage of the ``pp`` axis. Returns the pipeline's outputs [M, B/dp, D]
    on every stage (the last stage's, summed over ``pp``)."""
    group = mesh.get_group("pp")
    n_stages = mesh.size(mesh.mesh_dim_names.index("pp"))
    stage = mesh.get_local_rank("pp")
    w_in, w_out = params.w_in[0], params.w_out[0]
    n_mb = x_mb.shape[0]
    steps = n_mb + n_stages - 1
    first = torch.tensor(stage == 0, device=x_mb.device)
    act = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(n_mb)]
    for t in range(steps):
        # stage 0 feeds itself microbatch t (clamped: the steps past M are
        # bubble), the others the activation they received
        y = stage_fn(w_in, w_out, torch.where(first, x_mb[min(t, n_mb - 1)],
                                              act))
        # the last stage finishes microbatch t - (S - 1) at step t
        idx = min(max(t - (n_stages - 1), 0), n_mb - 1)
        valid = stage == n_stages - 1 and t >= n_stages - 1
        outs[idx] = torch.where(torch.tensor(valid, device=y.device), y,
                                outs[idx])
        if t < steps - 1:  # the last hand-off has no reader
            act = collectives.ring_shift(y, group)
    last = torch.tensor(stage == n_stages - 1, device=x_mb.device)
    out = torch.stack(outs)
    return collectives.all_reduce_sum(
        torch.where(last, out, torch.zeros_like(out)), group)


def pipeline_reference(params: Stages, x_mb):
    """The oracle: the stages one after another on one device, ``params``
    the whole stack."""
    y = x_mb
    for w_in, w_out in zip(params.w_in, params.w_out):
        y = stage_fn(w_in, w_out, y)
    return y


def dp_block(x_mb, mesh):
    """This rank's block of the token dim of ``x_mb`` [M, B, ...] over
    ``dp``, or all of it when the mesh has no ``dp`` axis."""
    if "dp" not in mesh.mesh_dim_names:
        return x_mb
    dp = mesh.size(mesh.mesh_dim_names.index("dp"))
    if x_mb.shape[1] % dp:
        raise ValueError(f"{x_mb.shape[1]} tokens do not split over dp {dp}")
    b = x_mb.shape[1] // dp
    i = mesh.get_local_rank("dp")
    return x_mb[:, i * b:(i + 1) * b]


def pipeline_loss(params: Stages, x_mb, targets, mesh):
    """The MSE of the pipelined outputs against ``targets``, both the whole
    [M, B, D] on every rank. Every stage holds the same outputs after the
    sum over ``pp``, so each rank takes 1/pp of its dp block's share of the
    global mean: with the whole share on every stage, the sum's backward
    would hand the last stage pp times its cotangent. Backward
    differentiates this rank's share; ``harness.sum_replica_grads`` then
    sums the stage's gradient over dp."""
    out = pipeline_forward(params, dp_block(x_mb, mesh), mesh)
    pp = mesh.size(mesh.mesh_dim_names.index("pp"))
    err = out.float() - dp_block(targets, mesh).float()
    share = (err ** 2).sum() / (targets.numel() * pp)
    return collectives.reduce_loss(share)
