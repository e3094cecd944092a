"""LFM2-MoE (LiquidAI's ``lfm2_moe``; LFM2-8B-A1B at its published widths)
for prefill: a hybrid of gated short convolutions and grouped-query
attention over a stack of drop-free top-k sigmoid expert layers. No JAX
counterpart.

The layer equations, over the residual stream x [B, T, D]:

- every layer: ``h = x + Op(RMSNorm_op(x))``, then ``x = h +
  FFN(RMSNorm_ffn(h))``; RMSNorm(x) = w * x / sqrt(mean(x^2) + eps),
  computed in fp32;
- Op of a ``conv`` layer, the gated short convolution
  (:func:`short_conv`): [B, C, X] = split(u W_in, 3) with no bias, v = B *
  X, z_t = c_0 v_{t-2} + c_1 v_{t-1} + c_2 v_t per channel (L = 3 taps;
  zeros before t = 0), y = (C * z) W_out; it runs in the [B, T, D] layout
  as shifted multiply-adds along T, with no transposed copy for a
  ``conv1d``;
- Op of a ``full_attention`` layer (:func:`attention`): q, k and v
  projections (one fused product) to H, Hkv and Hkv heads of Dh, a
  per-head RMSNorm of q and of k (each its own Dh weights), RoPE (theta
  1e6, the two halves rotated, ``attention.apply_rope``) at positions
  0..T-1, causal softmax(q k^T / sqrt(Dh)) v with query head h reading KV
  head h // (H / Hkv) (``attention.expand_kv``), and the output
  projection. The softmax is one whole-sequence absorb a layer through
  ``flash.flash_attention``: K3 on a card (the ``wgmma`` route at Dh 64),
  the plain absorb on the CPU;
- FFN of the first ``dense_layers`` layers: SwiGLU W2 (silu(W1 u) * W3 u)
  at ``ffn_hidden``, the SwiGLU one pass of K6 on a card
  (``swiglu.swiglu_gate``, as between the experts' products); of the
  rest, ``moe.SigmoidMoE``: sigmoid scores over ``experts``, the top
  ``top_k`` of score + expert bias, gates the selected scores over their
  sum (+ 1e-6), times 1.0, every token reaching its experts (grouped
  products on a card);
- the logits: RMSNorm_final(x_T) E^T at the last position only, in fp32,
  the head E [V, D] tied to the embedding table (``Lfm2MoeConfig``'s
  default; the published config states no ``tie_word_embeddings``).

Departures from the published model: the weights keep the port's [in,
out] layout (W1 and W3 side by side as ``w13``; the taps as ``kernel`` [L,
D], ``conv1d``'s [D, 1, L] transposed); the residual stream x stays in
fp32 while every norm hands its Op or FFN the weights' dtype; and the
router reads the fp32 norm (its product and selection in fp32) while the
experts read it in the weights' dtype. ``forward`` takes
embeddings [B, T, D] (a float tensor, as a serving engine's
``inputs_embeds``) or token ids [B, T] (looked up in the tied table).

Counters for the card (a CPU call counts nothing): ``_build.launches``
under ``short_conv``, ``expert_apply``, ``flash_absorb`` and
``swiglu_gate``, 18, 22, 6 and 24 a forward of LFM2-8B-A1B;
``moe.largest_expert_load()`` gives the last MoE layer's most loaded
expert.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from .attention import apply_rope, expand_kv, rope_tables
from .flash import flash_attention
from .moe import SigmoidMoE
from .swiglu import swiglu_gate


@dataclass(frozen=True)
class LFM2Config:
    """The sizes of an LFM2-MoE stack; the defaults are LFM2-8B-A1B's
    (https://huggingface.co/LiquidAI/LFM2-8B-A1B, ``config.json``)."""
    dim: int = 2048
    layer_types: tuple = (
        "conv", "conv", "full_attention", "conv", "conv", "conv",
        "full_attention", "conv", "conv", "conv", "full_attention", "conv",
        "conv", "conv", "full_attention", "conv", "conv", "conv",
        "full_attention", "conv", "conv", "full_attention", "conv", "conv")
    dense_layers: int = 2
    ffn_hidden: int = 7168
    expert_hidden: int = 1792
    experts: int = 32
    top_k: int = 4
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 64
    vocab: int = 65536
    conv_taps: int = 3
    rope_theta: float = 1e6
    eps: float = 1e-5


LFM2_8B_A1B = LFM2Config()


def rms_norm(x, weight, eps: float):
    """w * x / sqrt(mean(x^2) + eps) over the last dim, computed in fp32,
    in the weight's dtype."""
    return F.rms_norm(x.float(), x.shape[-1:], weight.float(),
                      eps).to(weight.dtype)


class ShortConv(nn.Module):
    """The gated short convolution's weights: ``in_proj`` [D, 3D],
    ``kernel`` [L, D], ``out_proj`` [D, D]."""

    def __init__(self, dim: int, taps: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj = nn.Parameter(torch.empty(dim, 3 * dim, dtype=dtype))
        self.kernel = nn.Parameter(torch.empty(taps, dim, dtype=dtype))
        self.out_proj = nn.Parameter(torch.empty(dim, dim, dtype=dtype))


def short_conv(u, conv: ShortConv):
    """(C * z) W_out with z the causal depthwise convolution of v = B * X
    along T (see the module docstring); u [B, T, D]."""
    b, c, x = (u @ conv.in_proj).chunk(3, dim=-1)
    v = b * x
    taps = conv.kernel.shape[0]
    z = v * conv.kernel[taps - 1]
    for shift in range(1, min(taps, v.shape[1])):
        z[:, shift:].addcmul_(v[:, :-shift], conv.kernel[taps - 1 - shift])
    if u.is_cuda:
        _build.launches["short_conv"] += 1
    return (c * z) @ conv.out_proj


class Attention(nn.Module):
    """Grouped-query attention's weights: the fused ``wqkv`` [D, (H + 2
    Hkv) Dh], the per-head norms ``q_norm`` and ``k_norm`` [Dh], and
    ``wo`` [H Dh, D]."""

    def __init__(self, cfg: LFM2Config, dtype: torch.dtype):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = (cfg.heads, cfg.kv_heads,
                                                    cfg.head_dim)
        width = (cfg.heads + 2 * cfg.kv_heads) * cfg.head_dim
        self.wqkv = nn.Parameter(torch.empty(cfg.dim, width, dtype=dtype))
        self.q_norm = nn.Parameter(torch.empty(cfg.head_dim, dtype=dtype))
        self.k_norm = nn.Parameter(torch.empty(cfg.head_dim, dtype=dtype))
        self.wo = nn.Parameter(torch.empty(cfg.heads * cfg.head_dim, cfg.dim,
                                           dtype=dtype))


def attention(u, attn: Attention, cos, sin, eps: float):
    """Causal GQA with QK-norm and RoPE over u [B, T, D] (see the module
    docstring); ``cos``, ``sin`` from ``attention.rope_tables``."""
    b, t, _ = u.shape
    heads, kv, hd = attn.heads, attn.kv_heads, attn.head_dim
    q, k, v = (u @ attn.wqkv).split([heads * hd, kv * hd, kv * hd], dim=-1)
    q = apply_rope(rms_norm(q.view(b, t, heads, hd), attn.q_norm, eps),
                   cos, sin)
    k = apply_rope(rms_norm(k.view(b, t, kv, hd), attn.k_norm, eps),
                   cos, sin)
    o = flash_attention(q, expand_kv(k, heads),
                        expand_kv(v.view(b, t, kv, hd), heads))
    return o.reshape(b, t, heads * hd) @ attn.wo


class SwiGLU(nn.Module):
    """A dense SwiGLU's weights: ``w13`` [D, 2F] (W1 and W3 side by side)
    and ``w2`` [F, D]."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.w13 = nn.Parameter(torch.empty(dim, 2 * hidden, dtype=dtype))
        self.w2 = nn.Parameter(torch.empty(hidden, dim, dtype=dtype))

    def forward(self, u):
        return swiglu_gate(u @ self.w13) @ self.w2


class LFM2Layer(nn.Module):
    """One layer: ``op_norm`` and its Op (``conv`` or ``attn``), then
    ``ffn_norm`` and its FFN (``ffn``, dense, or ``moe``)."""

    def __init__(self, cfg: LFM2Config, kind: str, dense: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.eps = cfg.eps
        self.op_norm = nn.Parameter(torch.empty(cfg.dim, dtype=dtype))
        self.ffn_norm = nn.Parameter(torch.empty(cfg.dim, dtype=dtype))
        if kind == "conv":
            self.conv = ShortConv(cfg.dim, cfg.conv_taps, dtype)
        elif kind == "full_attention":
            self.attn = Attention(cfg, dtype)
        else:
            raise ValueError(f"no layer type {kind!r}")
        if dense:
            self.ffn = SwiGLU(cfg.dim, cfg.ffn_hidden, dtype)
        else:
            self.moe = SigmoidMoE(cfg.dim, cfg.expert_hidden, cfg.experts,
                                  cfg.top_k, dtype)

    def forward(self, x, cos, sin):
        u = rms_norm(x, self.op_norm, self.eps)
        if hasattr(self, "conv"):
            h = x + short_conv(u, self.conv)
        else:
            h = x + attention(u, self.attn, cos, sin, self.eps)
        if hasattr(self, "ffn"):
            return h + self.ffn(rms_norm(h, self.ffn_norm, self.eps))
        return h + self.moe(F.rms_norm(h, h.shape[-1:],
                                       self.ffn_norm.float(), self.eps))


class LFM2MoE(nn.Module):
    """The model: ``embed`` [V, D] (also the head), ``layers`` and
    ``final_norm``. ``forward(x)`` gives the last position's logits [B, V]
    in fp32 of embeddings x [B, T, D] or token ids [B, T]."""

    def __init__(self, cfg: LFM2Config = LFM2_8B_A1B,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.dim,
                                              dtype=dtype))
        self.layers = nn.ModuleList(
            LFM2Layer(cfg, kind, i < cfg.dense_layers, dtype)
            for i, kind in enumerate(cfg.layer_types))
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, dtype=dtype))

    def forward(self, x):
        cfg = self.cfg
        x = (self.embed[x] if not x.is_floating_point() else x).float()
        cos, sin = rope_tables(torch.arange(x.shape[1], device=x.device),
                               cfg.head_dim, cfg.rope_theta)
        for lyr in self.layers:
            x = lyr(x, cos, sin)
        last = rms_norm(x[:, -1], self.final_norm, cfg.eps)
        return (last @ self.embed.T).float()
