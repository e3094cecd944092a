"""The long-context mini causal LM, single device.

Counterpart of the single-device part of
``k8s_device_plugin_tpu/workloads/attention.py``. The parameters keep the
JAX names and the JAX [in, out] layout (``embed`` [V, D];
``layers.{i}.qkv`` [D, 3D], or ``wq`` [D, D] and ``wkv`` [D, 2 Hkv Dh] for
grouped-query attention; ``proj``, ``mlp_in``, ``mlp_out``), so carrying
weights across is a rename (``convert.lm_params_to_state_dict``).
:func:`lm_forward` routes attention through the flash absorb
(``flash.flash_attention``: the CUDA kernel on a card, its plain version on
the CPU) with ``use_flash``, or through the dense
:func:`reference_attention`; :func:`lm_loss` is the training objective,
differentiable through both. Sequence parallelism (a mesh, ring or
Ulysses) is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .flash import NEG_INF, flash_attention
from .harness import cross_entropy


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
               seq_mode: str | None = None, ffn=None,
               use_rope: bool = False):
    """Token logits [B, T, V] for ``tokens`` [B, T].

    ``use_flash`` runs attention as whole-sequence flash absorbs (one per
    layer; ``flash_seq_block`` chunks them), else dense. ``ffn(h, layer)
    -> residual_out`` swaps the feed-forward (default: the tanh-gelu MLP
    on ``mlp_in``/``mlp_out``). A mesh or a ``seq_mode`` (sequence
    parallelism) is not ported yet."""
    if mesh is not None or seq_mode is not None:
        raise NotImplementedError("lm_forward: a mesh / seq_mode (sequence "
                                  "parallelism) is not yet ported")
    heads = params.heads
    x = params.embed[tokens]
    b, t, dim = x.shape
    if use_flash:
        def attend(q, k, v):
            return flash_attention(q, k, v, causal=causal,
                                   seq_block=flash_seq_block)
    else:
        def attend(q, k, v):
            return reference_attention(q, k, v, causal=causal)
    ffn = _mlp if ffn is None else ffn
    if use_rope:  # trig tables once, reused by every layer's q and k
        cos, sin = rope_tables(torch.arange(t, device=x.device),
                               dim // heads)
    for lyr in params.layers:
        h = _norm(x)
        q, k, v = layer_qkv(lyr, h, heads)
        if use_rope:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        k, v = expand_kv(k, heads), expand_kv(v, heads)
        att = attend(q, k, v).reshape(b, t, dim)
        x = x + att @ lyr.proj
        x = x + ffn(_norm(x), lyr)
    return _norm(x) @ params.embed.T


def lm_loss(params: LM, tokens, use_flash: bool = False,
            flash_seq_block: int | None = 1024, use_rope: bool = False):
    """Next-token cross entropy in fp32, the mean over every position of
    ``tokens`` [B, T + 1]. Differentiable through the flash absorb's
    recompute backward when ``use_flash`` is on; the default
    ``flash_seq_block`` keeps each backward score block at [1024, 1024]
    (``flash.flash_attention``)."""
    logits = lm_forward(params, tokens[:, :-1], use_flash=use_flash,
                        flash_seq_block=flash_seq_block, use_rope=use_rope)
    return cross_entropy(logits, tokens[:, 1:])
