"""Sequence-parallel attention (ring and Ulysses) and the long-context
mini causal LM.

Counterpart of ``k8s_device_plugin_tpu/workloads/attention.py``. The
parameters keep the JAX names and the JAX [in, out] layout (``embed`` [V, D];
``layers.{i}.qkv`` [D, 3D], or ``wq`` [D, D] and ``wkv`` [D, 2 Hkv Dh] for
grouped-query attention; ``proj``, ``mlp_in``, ``mlp_out``), so carrying
weights across is a rename (``convert.lm_params_to_state_dict``).
:func:`lm_forward` routes attention through the flash absorb
(``flash.flash_attention``: the CUDA kernel on a card, its plain version on
the CPU) with ``use_flash``, or through the dense
:func:`reference_attention`; :func:`lm_loss` is the training objective,
differentiable through both.

With a mesh of axes ``(dp, sp)`` every rank holds the ``[B/dp, T/sp]``
block of the tokens, and attention runs sequence-parallel over ``sp``:
:func:`ring_attention` rotates the K/V blocks round the ring
(``collectives.ring_shift``) and absorbs each with the streaming softmax,
through the flash absorb with ``use_flash``; :func:`ulysses_attention`
re-splits heads against sequence with two all-to-alls. JAX runs the same
global program under ``shard_map``; the rank's block of the sequence is
what its ``shard_map`` body sees. Everything else in the LM is per token.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import collectives
from .flash import (NEG_INF, _absorb_reference, flash_absorb,
                    flash_attention, flash_finalize)
from .harness import cross_entropy


def ring_attention(q, k, v, group, causal: bool = True,
                   use_flash: bool = False):
    """Exact attention over the sequence blocks of the ranks of ``group``
    (the ``sp`` axis), ring-rotated. q [B, T_loc, H, D] and k, v [B, T_loc,
    Hkv, D] are this rank's blocks; returns its block of the output.

    The K/V pair visits every rank in n - 1 rotations; the last visiting
    block is absorbed without a rotation whose result nobody would read.
    The block that rank r holds at step s came from rank (r - s) mod n,
    and its index against r gives the mask: whole below the diagonal (kind
    0), causal on it (1), nothing above it (2, a pass-through of the
    state). GQA rotates the Hkv-head blocks and expands them to the H
    query heads at each absorb. With ``use_flash`` each absorb is
    ``flash.flash_absorb`` (the kernel on a card, differentiated by its
    recompute backward); else the plain absorb, differentiated by
    autograd."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    heads = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    m = torch.full(q.shape[:1] + q.shape[2:3] + q.shape[1:2], NEG_INF,
                   dtype=torch.float32, device=q.device)      # [B, H, Tq]
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        if step:
            kv = collectives.ring_shift(kv, group)
        kv_idx = (rank - step) % n
        kind = (0 if kv_idx < rank else 1 if kv_idx == rank else 2) \
            if causal else 0
        k_cur, v_cur = expand_kv(kv[0], heads), expand_kv(kv[1], heads)
        if use_flash:
            m, l, o = flash_absorb(q, k_cur, v_cur, kind, m, l, o)
        else:
            m, l, o = _absorb_reference(q, k_cur, v_cur, kind, m, l, o,
                                        scale)
    return flash_finalize(m, l, o, q.dtype)


def _seq_to_heads(x, group):
    """[B, T/n, H, D] -> [B, T, H/n, D]: head chunk j to rank j, the
    sequence blocks joined in rank order (JAX's tiled ``all_to_all``,
    split_axis 2, concat_axis 1)."""
    n = dist.get_world_size(group)
    b, t_loc, h, d = x.shape
    x = x.reshape(b, t_loc, n, h // n, d).permute(2, 0, 1, 3, 4)
    x = collectives.all_to_all(x, group)        # [n (seq block), B, ...]
    return x.permute(1, 0, 2, 3, 4).reshape(b, n * t_loc, h // n, d)


def _heads_to_seq(x, group):
    """[B, T, H/n, D] -> [B, T/n, H, D], the inverse of
    :func:`_seq_to_heads`."""
    n = dist.get_world_size(group)
    b, t, h_loc, d = x.shape
    x = x.reshape(b, n, t // n, h_loc, d).permute(1, 0, 2, 3, 4)
    x = collectives.all_to_all(x, group)        # [n (head chunk), B, ...]
    return x.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h_loc, d)


def ulysses_attention(q, k, v, group, causal: bool = True,
                      use_flash: bool = False):
    """All-to-all sequence parallelism: the sequence-split [B, T/n, H, D]
    blocks become head-split [B, T, H/n, D] ones, every rank attends over
    the whole sequence for its heads (dense, or through the flash absorb
    with ``use_flash``), and a second all-to-all restores the sequence
    split. Needs H divisible by the ``group``'s size; k and v carry all H
    heads (``lm_forward`` expands GQA's before)."""
    n = dist.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible by "
                         f"the sp axis ({n}); use ring_attention otherwise")
    qh, kh, vh = (_seq_to_heads(t, group) for t in (q, k, v))
    if use_flash:
        o = flash_attention(qh, kh, vh, causal=causal)
    else:
        o = reference_attention(qh, kh, vh, causal=causal)
    return _heads_to_seq(o, group)


def reference_attention(q, k, v, causal: bool = True):
    """Dense single-device attention: the correctness oracle. q, k, v:
    [B, T, H, D]; computes in fp32 and returns q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class LMLayer(nn.Module):
    """One decoder block's weights: the fused ``qkv`` (MHA) or ``wq`` and
    ``wkv`` (GQA), then ``proj``, ``mlp_in``, ``mlp_out``, all [in, out].
    Without ``mlp`` the block has no ``mlp_in``/``mlp_out`` (its feed-forward
    is the caller's ``ffn``, as the MoE LM's experts)."""

    def __init__(self, dim: int, heads: int, kv_heads: int,
                 dtype: torch.dtype, mlp: bool = True):
        super().__init__()
        head_dim = dim // heads

        def weight(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype))
        if kv_heads == heads:
            self.qkv = weight(dim, 3 * dim)
            self.wq = self.wkv = None
        else:
            self.qkv = None
            self.wq = weight(dim, dim)
            self.wkv = weight(dim, 2 * kv_heads * head_dim)
        self.proj = weight(dim, dim)
        self.mlp_in = weight(dim, 4 * dim) if mlp else None
        self.mlp_out = weight(4 * dim, dim) if mlp else None


class LM(nn.Module):
    """The decoder's parameters; :func:`lm_forward` is its forward."""

    def __init__(self, vocab: int, dim: int, heads: int, layers: int,
                 dtype: torch.dtype = torch.float32,
                 kv_heads: int | None = None):
        super().__init__()
        kv_heads = heads if kv_heads is None else kv_heads
        if heads % kv_heads:
            raise ValueError(f"heads ({heads}) must be divisible by "
                             f"kv_heads ({kv_heads})")
        self.heads = heads
        self.embed = nn.Parameter(torch.empty(vocab, dim, dtype=dtype))
        self.layers = nn.ModuleList(
            LMLayer(dim, heads, kv_heads, dtype) for _ in range(layers))

    def forward(self, tokens, **kwargs):
        return lm_forward(self, tokens, **kwargs)


@torch.no_grad()
def init_lm_params(generator: torch.Generator, vocab: int, dim: int,
                   heads: int, layers: int, dtype=torch.float32,
                   kv_heads: int | None = None,
                   device: str | torch.device = "cuda") -> LM:
    """The LM with random weights: every weight normal / sqrt(dim), drawn
    in fp32 on the CPU from ``generator`` (so a seed gives the same weights
    on any device), then cast to ``dtype`` and moved to ``device``.
    ``kv_heads < heads`` selects the GQA layout."""
    model = LM(vocab, dim, heads, layers, dtype, kv_heads)
    scale = 1.0 / math.sqrt(dim)
    for p in model.parameters():
        p.copy_(torch.randn(p.shape, generator=generator) * scale)
    return model.to(device)


def layer_qkv(lyr: LMLayer, h, heads: int):
    """Per-layer projections -> (q [.., H, Dh], k, v [.., Hkv, Dh]), for
    both the fused MHA and the GQA layout."""
    *lead, dim = h.shape
    head_dim = dim // heads
    if lyr.qkv is not None:
        qkv = (h @ lyr.qkv).reshape(*lead, 3, heads, head_dim)
        return qkv.unbind(-3)
    q = (h @ lyr.wq).reshape(*lead, heads, head_dim)
    kv_heads = lyr.wkv.shape[1] // (2 * head_dim)
    k, v = (h @ lyr.wkv).reshape(*lead, 2, kv_heads, head_dim).unbind(-3)
    return q, k, v


def expand_kv(x, heads: int):
    """Repeat Hkv K/V heads up to the H query heads: query head k*g + i
    reads kv head k (``jnp.repeat``, so ``repeat_interleave``)."""
    kv_heads = x.shape[-2]
    if kv_heads == heads:
        return x
    return x.repeat_interleave(heads // kv_heads, dim=-2)


def rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding on [..., T, H, Dh] (Dh even) at token
    ``positions`` [T]."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return apply_rope(x, cos, sin)


def rope_tables(positions, head_dim: int, theta: float = 10000.0):
    """(cos, sin) [T, 1, Dh/2] in fp32, from positions alone."""
    if head_dim % 2:
        raise ValueError(f"rope needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.float()[:, None] * freqs[None]
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_rope(x, cos, sin):
    """Rotates the two concatenated halves of the head dim (not
    interleaved pairs), in fp32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def kv_heads_of(params: LM, heads: int) -> int:
    """The K/V head count the weights carry (== heads for fused MHA)."""
    lyr = params.layers[0]
    if lyr.wkv is None:
        return heads
    head_dim = params.embed.shape[1] // heads
    return lyr.wkv.shape[1] // (2 * head_dim)


def _norm(x):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return y.to(x.dtype)


def _mlp(h, lyr: LMLayer):
    # jax.nn.gelu's default is the tanh form
    return F.gelu(h @ lyr.mlp_in, approximate="tanh") @ lyr.mlp_out


def lm_forward(params: LM, tokens, mesh=None, causal: bool = True,
               use_flash: bool = False, flash_seq_block: int | None = None,
               seq_mode: str = "ring", ffn=None, use_rope: bool = False):
    """Token logits [B, T, V] for ``tokens`` [B, T].

    ``use_flash`` runs attention as whole-sequence flash absorbs (one per
    layer; ``flash_seq_block`` chunks them), else dense. ``ffn(h, layer)
    -> residual_out`` swaps the feed-forward (default: the tanh-gelu MLP
    on ``mlp_in``/``mlp_out``).

    With a ``mesh`` of axes (dp, sp), ``tokens`` is this rank's [B/dp,
    T/sp] block and the logits are its block: attention runs over ``sp``
    by ``seq_mode``, ``"ring"`` (:func:`ring_attention`; GQA's K/V rotate
    at Hkv heads) or ``"ulysses"`` (:func:`ulysses_attention`), through
    the flash absorb with ``use_flash``. RoPE takes the block's global
    positions, ``sp_rank * T/sp + arange(T/sp)``, as JAX rotates the whole
    sequence before it is split."""
    heads = params.heads
    x = params.embed[tokens]
    b, t, dim = x.shape
    start = 0
    ring = mesh is not None and seq_mode == "ring"
    if mesh is not None:
        seq_fn = {"ring": ring_attention, "ulysses": ulysses_attention}[
            seq_mode]
        group = mesh.get_group("sp")
        start = mesh.get_local_rank("sp") * t

        def attend(q, k, v):
            return seq_fn(q, k, v, group, causal=causal, use_flash=use_flash)
    elif use_flash:
        def attend(q, k, v):
            return flash_attention(q, k, v, causal=causal,
                                   seq_block=flash_seq_block)
    else:
        def attend(q, k, v):
            return reference_attention(q, k, v, causal=causal)
    ffn = _mlp if ffn is None else ffn
    if use_rope:  # trig tables once, reused by every layer's q and k
        cos, sin = rope_tables(torch.arange(start, start + t,
                                            device=x.device), dim // heads)
    for lyr in params.layers:
        h = _norm(x)
        q, k, v = layer_qkv(lyr, h, heads)
        if use_rope:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if not ring:
            k, v = expand_kv(k, heads), expand_kv(v, heads)
        att = attend(q, k, v).reshape(b, t, dim)
        x = x + att @ lyr.proj
        x = x + ffn(_norm(x), lyr)
    return _norm(x) @ params.embed.T


def seq_shard(tokens, mesh):
    """This rank's [B/dp, T/sp] block of ``tokens`` [B, T] on a (dp, sp)
    mesh (both must divide)."""
    b, t = tokens.shape
    dp, sp = mesh.mesh.shape
    if b % dp or t % sp:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split over a "
                         f"({dp}, {sp}) mesh")
    i, j = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    return tokens[i * (b // dp):(i + 1) * (b // dp),
                  j * (t // sp):(j + 1) * (t // sp)]


def lm_loss(params: LM, tokens, mesh=None, use_flash: bool = False,
            flash_seq_block: int | None = 1024, seq_mode: str = "ring",
            use_rope: bool = False):
    """Next-token cross entropy in fp32, the mean over every position of
    ``tokens`` [B, T + 1]. Differentiable through the flash absorb's
    recompute backward when ``use_flash`` is on; the default
    ``flash_seq_block`` keeps each backward score block at [1024, 1024]
    (``flash.flash_attention``).

    With a ``mesh``, ``tokens`` are the whole batch on every rank: the
    next-token shift is taken on them, then each rank runs its [B/dp, T/sp]
    block (so T must split over sp) and returns the global mean, the sum
    of the ranks' shares (``collectives.reduce_loss``). Backward then
    differentiates this rank's share: sum the weights' gradients over the
    world (``collectives.sum_grads``) for the gradient of the mean."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if mesh is None:
        logits = lm_forward(params, inputs, use_flash=use_flash,
                            flash_seq_block=flash_seq_block,
                            use_rope=use_rope)
        return cross_entropy(logits, targets)
    logits = lm_forward(params, seq_shard(inputs, mesh), mesh,
                        use_flash=use_flash, seq_mode=seq_mode,
                        use_rope=use_rope)
    share = cross_entropy(logits, seq_shard(targets, mesh)) \
        * (logits.shape[0] * logits.shape[1] / targets.numel())
    return collectives.reduce_loss(share)
