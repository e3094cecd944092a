"""Switch mixture-of-experts: the expert-parallel layer and the MoE
decoder.

Counterpart of ``k8s_device_plugin_tpu/workloads/moe.py``: Switch top-1
routing with a static capacity (:func:`_route`), the expert FFN stacks,
the layer with every expert local (:func:`moe_layer_dense`, also the
serving path's drop-free expert apply in ``decode.py``), its per-shard
oracle (:func:`moe_reference`), the expert-parallel layer
(:func:`moe_layer`, :func:`moe_forward`, :func:`moe_loss`) and the
long-context MoE decoder (:func:`moe_lm_forward`, :func:`moe_lm_loss`):
``attention.lm_forward`` with its ``ffn`` hook swapped for the experts, so
both LMs share one decoder loop and every attention path (dense, the flash
absorb, the ring and Ulysses over a mesh).

The parameters keep the JAX names and layouts (``gate`` [D, E], ``w_in``
[E, D, F], ``w_out`` [E, F, D]), so carrying weights across is a rename
(``convert.moe_params_to_state_dict``). Capacity is a per-shard semantic:
on one device the forward takes ``shard_shape=(dp, sp)`` and routes each
block of batch and sequence on its own, as the JAX oracle does; over a
mesh each rank routes its own block. The dispatch, the expert FFNs and the
combine are plain products in fp32, as JAX casts them, outside any kernel.

Over a mesh every rank holds its block of the tokens and its slice
``[E / n, ...]`` of the expert stacks (``harness.shard_params``; the gate
is whole on every rank), and each rank back-propagates its share of the
loss (``collectives.reduce_loss``): ``harness.sum_replica_grads`` then sums
the gate's gradient over the world and the experts' over the axes they are
not split on.

The drop-free top-k sigmoid layer (:class:`SigmoidMoE`, LFM2-MoE's
experts; no JAX counterpart) routes every token to its k experts
(:func:`route_sigmoid_topk`) and applies them with no capacity
(:func:`expert_apply`): the token-expert pairs sorted by expert, each
expert's SwiGLU on exactly its pairs, the gates folded into the second
product's input, and each token's k results summed. On bf16 CUDA tensors
each product is one ``torch._grouped_mm`` over all experts, and the gated
SwiGLU between them one hand-written pass (``swiglu.swiglu_gate``);
elsewhere a loop of plain products, one expert at a time.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import _build
from . import collectives
from .attention import LMLayer, lm_forward, seq_shard
from .harness import cross_entropy
from .swiglu import swiglu_gate


class MoE(nn.Module):
    """One Switch layer's weights: ``gate`` [D, E] and the expert stacks
    ``w_in`` [E, D, F], ``w_out`` [E, F, D]."""

    def __init__(self, dim: int, hidden: int, n_experts: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate = nn.Parameter(torch.empty(dim, n_experts, dtype=dtype))
        self.w_in = nn.Parameter(torch.empty(n_experts, dim, hidden,
                                             dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(n_experts, hidden, dim,
                                              dtype=dtype))


def _init(module: nn.Module, generator: torch.Generator, dim: int,
          hidden: int) -> None:
    """Every weight normal / sqrt(dim), ``w_out`` normal / sqrt(hidden)
    (the JAX scales), drawn in fp32 on the CPU from ``generator``."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            scale = hidden ** -0.5 if name.endswith("w_out") else dim ** -0.5
            p.copy_(torch.randn(p.shape, generator=generator) * scale)


def init_moe_params(generator: torch.Generator, dim: int, hidden: int,
                    n_experts: int, dtype=torch.float32,
                    device: str | torch.device = "cuda") -> MoE:
    """A Switch layer with random weights (see :func:`_init`)."""
    module = MoE(dim, hidden, n_experts, dtype)
    _init(module, generator, dim, hidden)
    return module.to(device)


def _route(x, gate_w, n_experts: int, capacity: int):
    """Switch top-1 routing with static capacity on tokens x [..., N, D]
    (leading dims are shards, each routed on its own).

    Returns (dispatch [..., N, E, C] 0/1, combine = dispatch * the chosen
    expert's probability, aux [...]). ``dispatch[n, e, c] = 1`` iff token n
    is the c-th token (in token order) routed to expert e and c <
    capacity; a token past its expert's capacity is dropped (an all-zero
    row, as ``jax.nn.one_hot`` gives for an index out of range, where
    ``F.one_hot`` would raise). The logits are in x's dtype, the softmax
    in fp32; ``argmax`` takes the first maximum, as ``jnp.argmax``."""
    probs = torch.softmax((x @ gate_w).float(), dim=-1)       # [..., N, E]
    idx = probs.argmax(dim=-1)                                # [..., N]
    gate = probs.gather(-1, idx[..., None])[..., 0]
    onehot = F.one_hot(idx, n_experts).float()
    # 0-based position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=-2) * onehot - onehot
    keep = onehot * (pos < capacity)
    slots = torch.arange(capacity, dtype=pos.dtype, device=pos.device)
    dispatch = keep[..., None] * (pos[..., None] == slots)    # [..., N, E, C]
    combine = dispatch * gate[..., None, None]
    # Switch aux loss: E * <fraction routed to e> . <mean prob of e>
    frac = onehot.mean(dim=-2)
    mean_prob = probs.mean(dim=-2)
    aux = n_experts * (frac * mean_prob).sum(dim=-1)
    return dispatch, combine, aux


def _expert_ffn(xs, w_in, w_out):
    """[..., E, S, D] tokens through each expert's tanh-gelu FFN."""
    h = F.gelu(torch.einsum("...esd,edf->...esf", xs, w_in),
               approximate="tanh")
    return torch.einsum("...esf,efd->...esd", h, w_out)


def moe_layer_dense(x, params: MoE, capacity_factor: float = 1.25):
    """One MoE layer with every expert local. x: [N, D], or [S, N, D] for
    S shards routed each on its own (capacity per shard); returns (the
    expert mixture in x's dtype, without the residual; aux, one per
    shard)."""
    n_experts = params.w_in.shape[0]
    capacity = max(1, math.ceil(x.shape[-2] * capacity_factor / n_experts))
    dispatch, combine, aux = _route(x, params.gate, n_experts, capacity)
    xs = torch.einsum("...nec,...nd->...ecd", dispatch, x.float())
    ys = _expert_ffn(xs, params.w_in.float(), params.w_out.float())
    out = torch.einsum("...nec,...ecd->...nd", combine, ys)
    return out.to(x.dtype), aux


def moe_reference(x_shards, params: MoE, capacity_factor: float = 1.25):
    """Dense oracle of the sharded layer: x_shards [S, N, D], the token
    shards as a mesh would split them. Returns (out [S, N, D], mean aux)."""
    out, aux = moe_layer_dense(x_shards, params, capacity_factor)
    return out, aux.mean()


def _to_owners(xs, group):
    """[E, C, D] -> [E / n, n C, D]: expert e's slots to rank e // (E / n)
    of ``group``, the slots received from rank j at ``j C`` (JAX's tiled
    ``all_to_all``, split_axis 0, concat_axis 1)."""
    n = dist.get_world_size(group)
    e, c, d = xs.shape
    xs = collectives.all_to_all(xs.reshape(n, e // n, c, d), group)
    return xs.transpose(0, 1).reshape(e // n, n * c, d)


def _from_owners(ys, group):
    """[E / n, n C, D] -> [E, C, D], the inverse of :func:`_to_owners`:
    the slots of rank j's tokens go back to rank j."""
    n = dist.get_world_size(group)
    e_loc, nc, d = ys.shape
    ys = ys.reshape(e_loc, n, nc // n, d).transpose(0, 1)
    return collectives.all_to_all(ys, group).reshape(n * e_loc, nc // n, d)


def moe_layer(x, params: MoE, group, capacity_factor: float = 1.25):
    """One expert-parallel Switch layer over the ranks of ``group``. x:
    this rank's tokens [N, D]; ``params``: the gate whole, ``w_in`` and
    ``w_out`` this rank's [E / n, ...] slice of the experts. Routes the
    rank's tokens over all E experts with the capacity of its own
    ``ceil(N cf / E)`` slots an expert, sends each expert's slots to its
    owner, runs the owners' FFNs and sends the results back. Returns (the
    expert mixture [N, D] in x's dtype, without the residual; this rank's
    aux)."""
    n_experts = params.w_in.shape[0] * dist.get_world_size(group)
    capacity = max(1, math.ceil(x.shape[0] * capacity_factor / n_experts))
    dispatch, combine, aux = _route(x, params.gate, n_experts, capacity)
    xs = _to_owners(torch.einsum("nec,nd->ecd", dispatch, x.float()), group)
    ys = _expert_ffn(xs, params.w_in.float(), params.w_out.float())
    out = torch.einsum("nec,ecd->nd", combine, _from_owners(ys, group))
    return out.to(x.dtype), aux


def _world_mean(x, mesh):
    """The mean of every rank's ``x`` over the mesh, on every rank (JAX's
    ``pmean`` over each axis); its backward hands each rank the cotangent
    of its own share."""
    for axis in mesh.mesh_dim_names:
        x = collectives.reduce_loss(x / mesh.size(mesh.mesh_dim_names.index(
            axis)), mesh.get_group(axis))
    return x


def ep_shard(x, mesh):
    """This rank's block of ``x`` [S, ...] whose dim S splits over the
    (dp, ep) mesh (JAX's ``P((dp, ep))``: dp-major)."""
    ep = mesh.size(mesh.mesh_dim_names.index("ep"))
    i = mesh.get_local_rank("dp") * ep + mesh.get_local_rank("ep")
    blocks = mesh.size()
    if x.shape[0] % blocks:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{blocks} ranks")
    step = x.shape[0] // blocks
    return x[i * step:(i + 1) * step]


def moe_forward(x, params: MoE, mesh, capacity_factor: float = 1.25):
    """The sharded MoE over a (dp, ep) mesh: x is this rank's block [1, N,
    D] of the [dp ep, N, D] shards (:func:`ep_shard`), ``params`` the gate
    and this rank's experts (``harness.shard_params``). Returns (this
    rank's [1, N, D] block of the outputs, the mean aux over the mesh)."""
    if x.shape[0] != 1:
        raise ValueError(f"moe_forward: one shard a rank, got {x.shape[0]}")
    out, aux = moe_layer(x[0], params, mesh.get_group("ep"),
                         capacity_factor)
    return out[None], _world_mean(aux, mesh)


def moe_loss(params: MoE, x, targets, mesh, capacity_factor: float = 1.25,
             aux_weight: float = 0.01):
    """The ep dry run's training objective: the MSE of ``out + x`` against
    ``targets`` (both the whole [dp ep, N, D] on every rank) plus
    ``aux_weight`` times the mean aux. Each rank computes its block's share
    of the global mean, so its backward differentiates that share
    (``harness.sum_replica_grads`` then gives the gradient of the mean)."""
    xb, tb = ep_shard(x, mesh), ep_shard(targets, mesh)
    out, aux = moe_forward(xb, params, mesh, capacity_factor)
    share = ((out.float() + xb.float() - tb.float()) ** 2).sum() / x.numel()
    return collectives.reduce_loss(share) + aux_weight * aux


# --------------------------------------------- long-context MoE mini-LM

class MoELMLayer(LMLayer):
    """A decoder block whose feed-forward is a Switch layer: ``qkv``,
    ``proj`` and ``moe`` (no ``mlp_in``/``mlp_out``)."""

    def __init__(self, dim: int, heads: int, hidden: int, n_experts: int,
                 dtype: torch.dtype):
        super().__init__(dim, heads, heads, dtype, mlp=False)
        self.moe = MoE(dim, hidden, n_experts, dtype)


class MoELM(nn.Module):
    """The MoE decoder's parameters (``embed``, ``layers``); its forward is
    :func:`moe_lm_forward`."""

    def __init__(self, vocab: int, dim: int, heads: int, layers: int,
                 n_experts: int, hidden: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = 4 * dim if hidden is None else hidden
        self.heads = heads
        self.embed = nn.Parameter(torch.empty(vocab, dim, dtype=dtype))
        self.layers = nn.ModuleList(
            MoELMLayer(dim, heads, hidden, n_experts, dtype)
            for _ in range(layers))

    def forward(self, tokens, **kwargs):
        return moe_lm_forward(self, tokens, **kwargs)


def init_moe_lm_params(generator: torch.Generator, vocab: int, dim: int,
                       heads: int, layers: int, n_experts: int,
                       hidden: int | None = None, dtype=torch.float32,
                       device: str | torch.device = "cuda") -> MoELM:
    """The MoE decoder with random weights: every weight normal /
    sqrt(dim) but ``w_out``, normal / sqrt(hidden) (hidden defaults to 4
    dim), drawn in fp32 on the CPU from ``generator``, then cast to
    ``dtype`` and moved to ``device``."""
    model = MoELM(vocab, dim, heads, layers, n_experts, hidden, dtype)
    _init(model, generator, dim, model.layers[0].moe.w_in.shape[-1])
    return model.to(device)


def moe_lm_forward(params: MoELM, tokens, mesh=None,
                   capacity_factor: float = 1.25, seq_mode: str = "ring",
                   shard_shape: tuple[int, int] | None = None,
                   use_flash: bool = False):
    """(logits [B, T, V], mean of the layers' aux losses) for ``tokens``
    [B, T].

    Without a mesh each layer routes the (dp, sp) blocks of
    ``shard_shape`` (batch split dp ways, sequence sp ways; default one
    block) on their own, in the JAX oracle's order, and ``use_flash`` runs
    each layer's attention as one whole-sequence flash absorb (no
    chunking, as JAX passes none); ``seq_mode`` changes nothing.

    With a (dp, sp) ``mesh`` ``tokens`` is this rank's [B/dp, T/sp] block
    and the logits are its block (``attention.lm_forward``): attention runs
    over sp by ``seq_mode`` (through the flash absorb with ``use_flash``),
    and each layer's experts ride the same axis: the rank's tokens through
    :func:`moe_layer` over the sp group, the experts its [E / sp, ...]
    slice (JAX's ``_moe_ffn_local``). The aux is the mean over the mesh."""
    aux_acc = []
    if mesh is not None:
        group = mesh.get_group("sp")

        def moe_ffn(h, lyr):
            bb, tt, dd = h.shape
            out, aux = moe_layer(h.reshape(bb * tt, dd), lyr.moe, group,
                                 capacity_factor)
            aux_acc.append(_world_mean(aux, mesh))
            return out.reshape(bb, tt, dd)
    else:
        dp, sp = shard_shape if shard_shape is not None else (1, 1)

        def moe_ffn(h, lyr):
            bb, tt, dd = h.shape
            shards = h.reshape(dp, bb // dp, sp, tt // sp, dd) \
                .transpose(1, 2) \
                .reshape(dp * sp, (bb // dp) * (tt // sp), dd)
            out, aux = moe_reference(shards, lyr.moe, capacity_factor)
            aux_acc.append(aux)
            return out.reshape(dp, sp, bb // dp, tt // sp, dd) \
                .transpose(1, 2).reshape(bb, tt, dd)

    logits = lm_forward(params, tokens, mesh, use_flash=use_flash,
                        seq_mode=seq_mode, ffn=moe_ffn)
    return logits, sum(aux_acc) / len(aux_acc)


def moe_lm_loss(params: MoELM, tokens, mesh=None,
                capacity_factor: float = 1.25, aux_weight: float = 0.01,
                seq_mode: str = "ring",
                shard_shape: tuple[int, int] | None = None,
                use_flash: bool = False):
    """Next-token cross entropy in fp32 over ``tokens`` [B, T + 1] plus
    ``aux_weight`` times the load-balance aux; differentiable through the
    flash absorb's recompute backward when ``use_flash`` is on (each
    backward then rebuilds a whole-sequence [B, H, T, T] fp32 score block
    without a mesh).

    With a ``mesh``, ``tokens`` are the whole batch on every rank, as
    ``attention.lm_loss`` takes them: each rank runs its [B/dp, T/sp]
    block and returns the global loss, the sum of the ranks' shares, so
    its backward differentiates its share (``harness.sum_replica_grads``
    then sums the gradients: the attention weights and the gate over the
    world, the experts over dp)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if mesh is None:
        logits, aux = moe_lm_forward(params, inputs, None, capacity_factor,
                                     seq_mode, shard_shape, use_flash)
        return cross_entropy(logits, targets) + aux_weight * aux
    logits, aux = moe_lm_forward(params, seq_shard(inputs, mesh), mesh,
                                 capacity_factor, seq_mode,
                                 use_flash=use_flash)
    share = cross_entropy(logits, seq_shard(targets, mesh)) \
        * (logits.shape[0] * logits.shape[1] / targets.numel())
    return collectives.reduce_loss(share) + aux_weight * aux


# ------------------------------------- drop-free top-k sigmoid experts

class SigmoidMoE(nn.Module):
    """A drop-free top-k expert layer's weights: the ``router`` [D, E], the
    selection-only ``expert_bias`` [E] (fp32), and the experts' SwiGLU
    stacks ``w13`` [E, D, 2F] (W1 and W3 side by side) and ``w2`` [E, F,
    D]. The forward takes tokens [..., D] to the layer's output (without
    the residual) in the experts' dtype: the router reads the tokens as
    they come (LFM2 hands it the fp32 norm), the experts in their dtype."""

    def __init__(self, dim: int, hidden: int, n_experts: int, top_k: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.top_k = top_k
        self.router = nn.Parameter(torch.empty(dim, n_experts, dtype=dtype))
        self.expert_bias = nn.Parameter(torch.empty(n_experts,
                                                    dtype=torch.float32))
        self.w13 = nn.Parameter(torch.empty(n_experts, dim, 2 * hidden,
                                            dtype=dtype))
        self.w2 = nn.Parameter(torch.empty(n_experts, hidden, dim,
                                           dtype=dtype))

    def forward(self, h):
        flat = h.reshape(-1, h.shape[-1])
        sel, gates = route_sigmoid_topk(flat, self.router, self.expert_bias,
                                        self.top_k)
        return expert_apply(flat.to(self.w13.dtype), sel, gates, self.w13,
                            self.w2).view(h.shape)


#: added to the selected scores' sum before the gates divide by it
GATE_EPS = 1e-6
#: the gates' factor, LFM2-8B-A1B's published ``routed_scaling_factor``
ROUTED_SCALING = 1.0


def route_sigmoid_topk(h, router, expert_bias, top_k: int):
    """(selected experts [N, k] long, gates [N, k] fp32) of tokens h [N,
    D]: scores s = sigmoid(h W_router) in fp32 (the product too), the k
    experts of largest s + ``expert_bias`` (the bias selects and never
    weighs), and g_e = s_e / (sum of the selected s + 1e-6) x
    :data:`ROUTED_SCALING`."""
    s = torch.sigmoid(h.float() @ router.float())
    _, sel = torch.topk(s + expert_bias.float(), top_k, dim=-1)
    g = s.gather(-1, sel)
    return sel, g / (g.sum(-1, keepdim=True) + GATE_EPS) * ROUTED_SCALING


def expert_apply(h, sel, gates, w13, w2):
    """sum over j of gates[n, j] SwiGLU_{sel[n, j]}(h[n]) for tokens h [N,
    D], in h's dtype: every pair computed, none dropped, and no expert
    computes a token not routed to it. The pairs are sorted by expert
    (stably, so in token order within one); on bf16 CUDA tensors each of
    the two products is one ``torch._grouped_mm`` over the sorted pairs
    (counted in ``_build.launches["expert_apply"]``) with the gated
    SwiGLU between them one pass of K6 (``swiglu.swiglu_gate``),
    elsewhere a loop of plain products over the experts with
    ``swiglu_gate``'s plain version between them. The per-expert pair
    counts of the last call stay on the device as
    ``expert_apply.last_counts`` (:func:`largest_expert_load` reads
    them)."""
    n, k = sel.shape
    n_experts = w2.shape[0]
    experts, order = torch.sort(sel.reshape(-1), stable=True)
    # each expert's end among the sorted pairs: found on the device, so
    # the host never waits for the routing
    ends = torch.searchsorted(experts, torch.arange(
        1, n_experts + 1, device=sel.device), out_int32=True)
    xs = h.index_select(0, order // k)
    g = gates.reshape(-1)[order].to(h.dtype)
    if h.is_cuda and h.dtype == torch.bfloat16:
        h13 = torch._grouped_mm(xs, w13, offs=ends)
        a = swiglu_gate(h13, g)
        ys = torch._grouped_mm(a, w2, offs=ends)
        _build.launches["expert_apply"] += 1
    else:
        ys = torch.empty_like(xs)
        start = 0
        for e, end in enumerate(ends.tolist()):
            if end > start:
                rows = slice(start, end)
                ys[rows] = swiglu_gate(xs[rows] @ w13[e], g[rows]) @ w2[e]
                start = end
    expert_apply.last_counts = torch.diff(ends, prepend=ends.new_zeros(1))
    # back to token order: pair p was sorted to row place[p]
    place = torch.empty_like(order)
    place[order] = torch.arange(len(order), device=order.device)
    return ys.index_select(0, place).view(n, k, -1).sum(dim=1)


expert_apply.last_counts = None


def largest_expert_load() -> int | None:
    """The most pairs any one expert took in the last :func:`expert_apply`
    (its load imbalance; reading it waits for the device)."""
    counts = expert_apply.last_counts
    return None if counts is None else int(counts.max())
