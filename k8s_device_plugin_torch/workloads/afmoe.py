"""AFMoE (Arcee's ``afmoe``; Trinity-Mini at its published widths) for
prefill: grouped-query attention with sliding-window and full layers,
gated attention output, sandwich norms, and drop-free top-k sigmoid
expert layers with a shared expert. No JAX counterpart.

The layer equations, over the residual stream x [B, T, D] (fp32):

- every layer: ``h = x + RMSNorm_post_attn(Attn(RMSNorm_in(x)))``, then
  ``x = h + RMSNorm_post_mlp(FFN(RMSNorm_pre_mlp(h)))``; RMSNorm(x) = w * x
  / sqrt(mean(x^2) + eps), computed in fp32 (the two post-norms stay in
  fp32 for the residual add, the two pre-norms hand their Op the weights'
  dtype);
- Attn (:func:`attention`): u's q, k, v and gate projections (one fused
  product ``wqkvg``) to H, Hkv, Hkv heads of Dh and H Dh gate values, a
  per-head RMSNorm of q and of k, RoPE (theta ``rope_theta``, the two
  halves of the full head dim rotated, ``attention.apply_rope``) at
  positions 0..T-1 on the ``sliding_attention`` layers only (the
  ``full_attention`` layers are NoPE), softmax(q k^T / sqrt(Dh)) v with
  query head h reading KV head h // (H / Hkv), causal, and on the sliding
  layers within the window: key j is visible to query i iff i - window <
  j <= i. The attention output is gated per element, ``o * sigmoid(g)``
  (:func:`output_gate`), before the output projection. Each layer's
  softmax is one whole-sequence absorb through ``flash.flash_attention``:
  K3 on a card (at Dh 128 its ``wgmma`` route; a sliding layer's launch
  skips the key tiles before its band and is counted apart, under
  ``flash_window``), the plain absorb on the CPU;
- FFN of the first ``dense_layers`` layers: SwiGLU W2 (silu(W1 u) * W3 u)
  at ``ffn_hidden`` (``lfm2.SwiGLU``, K6 on a card); of the rest,
  ``moe.SigmoidMoE``: s = sigmoid(u W_router) in fp32 over all
  ``experts``, the ``top_k`` of s + expert bias (the bias selects and
  never weighs), gates s_e / (sum of the selected s + ``gate_eps``) x
  ``route_scale``, the held experts' SwiGLUs on the pairs routed to them
  (grouped products on a card), plus a shared SwiGLU of
  ``shared_hidden`` that every token takes;
- the input: embeddings [B, T, D] times sqrt(D) (``mup``), the muP input
  scale;
- the logits: RMSNorm_final(x_T) W_head at the last position only, in
  fp32 (the head untied, [D, V]).

A configuration may hold a range ``held`` = (first, count) of each expert
layer's experts: one rank of an expert-parallel deployment, run without
its exchange. It routes over all ``experts`` and computes what its own
experts give the tokens routed to them; the share that the other ranks'
experts would add is left out, and that partial result goes on to the
next layer. :data:`TRINITY_MINI_EP4` is rank 0 of 4: experts 0-31 of 128.
The model states its range as the shape of an empty buffer,
``experts_held`` [first, count, 0]: the benchmark's reference lays out
the same entry from its configuration's ``expert_rank`` and
``num_experts_held``, so a tenant whose configuration holds other
experts fails its layout check instead of running them as these.

Departures from the published model: the weights keep the port's [in,
out] layout (q, k, v and the gate side by side as ``wqkvg``; W1 and W3 as
``w13``); the residual stream stays in fp32; the router reads the fp32
norm (its product and selection in fp32) while the experts read it in the
weights' dtype; and ``forward`` takes embeddings only (a serving engine's
``inputs_embeds``): no embedding table is held.

Counters for the card (a CPU call counts nothing): ``_build.launches``
under ``flash_window``, ``flash_absorb``, ``expert_apply`` and
``swiglu_gate``, 24, 8, 30 and 62 (2 dense, 30 shared, 30 routed) a
forward of Trinity-Mini.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .attention import apply_rope, expand_kv, rope_tables
from .flash import flash_attention
from .lfm2 import SwiGLU, rms_norm
from .moe import SigmoidMoE

#: the layer types an AFMoE stack takes
LAYER_TYPES = ("sliding_attention", "full_attention")


@dataclass(frozen=True)
class AFMoEConfig:
    """The sizes of an AFMoE stack; the defaults are Trinity-Mini's
    (https://huggingface.co/arcee-ai/Trinity-Mini, ``config.json``), every
    expert held."""
    dim: int = 2048
    layer_types: tuple = ("sliding_attention", "sliding_attention",
                          "sliding_attention", "full_attention") * 8
    dense_layers: int = 2
    ffn_hidden: int = 6144
    expert_hidden: int = 1024
    experts: int = 128
    #: (first, count) of each expert layer's experts held here
    held: tuple = (0, 128)
    top_k: int = 8
    #: num_shared_experts x moe_intermediate_size
    shared_hidden: int = 1024
    heads: int = 32
    kv_heads: int = 4
    head_dim: int = 128
    vocab: int = 200192
    window: int = 2048
    rope_theta: float = 10000.0
    eps: float = 1e-5
    route_scale: float = 2.826
    gate_eps: float = 1e-20
    #: embeddings times sqrt(dim) before layer 0
    mup: bool = True


TRINITY_MINI = AFMoEConfig()
#: rank 0 of a 4-way expert-parallel deployment: experts 0-31 of 128
TRINITY_MINI_EP4 = dataclasses.replace(TRINITY_MINI, held=(0, 32))


class Attention(nn.Module):
    """Gated grouped-query attention's weights: the fused ``wqkvg`` [D, (2H
    + 2 Hkv) Dh] (q, k, v, then the gate), the per-head norms ``q_norm``
    and ``k_norm`` [Dh], and ``wo`` [H Dh, D]."""

    def __init__(self, cfg: AFMoEConfig, dtype: torch.dtype):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = (cfg.heads, cfg.kv_heads,
                                                    cfg.head_dim)
        width = (2 * cfg.heads + 2 * cfg.kv_heads) * cfg.head_dim
        self.wqkvg = nn.Parameter(torch.empty(cfg.dim, width, dtype=dtype))
        self.q_norm = nn.Parameter(torch.empty(cfg.head_dim, dtype=dtype))
        self.k_norm = nn.Parameter(torch.empty(cfg.head_dim, dtype=dtype))
        self.wo = nn.Parameter(torch.empty(cfg.heads * cfg.head_dim, cfg.dim,
                                           dtype=dtype))


def output_gate(o, g):
    """The attention output gated per element: o * sigmoid(g)."""
    return o * torch.sigmoid(g)


def attention(u, attn: Attention, cos, sin, eps: float, window: int):
    """Gated causal GQA with QK-norm over u [B, T, D] (see the module
    docstring): with a ``window`` (a sliding layer) RoPE from ``cos``,
    ``sin`` and the band, without one (a full layer) neither."""
    b, t, _ = u.shape
    heads, kv, hd = attn.heads, attn.kv_heads, attn.head_dim
    q, k, v, g = (u @ attn.wqkvg).split(
        [heads * hd, kv * hd, kv * hd, heads * hd], dim=-1)
    q = rms_norm(q.view(b, t, heads, hd), attn.q_norm, eps)
    k = rms_norm(k.view(b, t, kv, hd), attn.k_norm, eps)
    if window:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = flash_attention(q, expand_kv(k, heads),
                        expand_kv(v.view(b, t, kv, hd), heads),
                        window=window)
    return output_gate(o.reshape(b, t, heads * hd), g) @ attn.wo


class AFMoELayer(nn.Module):
    """One layer: ``input_norm``, ``attn``, ``post_attn_norm``, then
    ``pre_mlp_norm``, the FFN (``ffn``, dense, or ``moe``) and
    ``post_mlp_norm``."""

    def __init__(self, cfg: AFMoEConfig, kind: str, dense: bool,
                 dtype: torch.dtype):
        super().__init__()
        if kind not in LAYER_TYPES:
            raise ValueError(f"no layer type {kind!r}")
        self.eps = cfg.eps
        self.window = cfg.window if kind == "sliding_attention" else 0
        for name in ("input_norm", "post_attn_norm", "pre_mlp_norm",
                     "post_mlp_norm"):
            setattr(self, name, nn.Parameter(torch.empty(cfg.dim,
                                                         dtype=dtype)))
        self.attn = Attention(cfg, dtype)
        if dense:
            self.ffn = SwiGLU(cfg.dim, cfg.ffn_hidden, dtype)
        else:
            self.moe = SigmoidMoE(cfg.dim, cfg.expert_hidden, cfg.experts,
                                  cfg.top_k, dtype, held=cfg.held,
                                  shared=SwiGLU(cfg.dim, cfg.shared_hidden,
                                                dtype),
                                  route_scale=cfg.route_scale,
                                  gate_eps=cfg.gate_eps)

    def _post(self, y, weight):
        """A post-norm in fp32, for the fp32 residual stream."""
        return F.rms_norm(y.float(), y.shape[-1:], weight.float(), self.eps)

    def forward(self, x, cos, sin):
        u = rms_norm(x, self.input_norm, self.eps)
        h = x + self._post(attention(u, self.attn, cos, sin, self.eps,
                                     self.window), self.post_attn_norm)
        if hasattr(self, "ffn"):
            y = self.ffn(rms_norm(h, self.pre_mlp_norm, self.eps))
        else:
            y = self.moe(F.rms_norm(h, h.shape[-1:],
                                    self.pre_mlp_norm.float(), self.eps))
        return h + self._post(y, self.post_mlp_norm)


class AFMoE(nn.Module):
    """The model: ``layers``, ``final_norm``, the untied ``head`` [D, V]
    and ``experts_held``, empty, of shape [first, count, 0] (``cfg.held``).
    ``forward(x)`` gives the last position's logits [B, V] in fp32 of
    embeddings x [B, T, D]."""

    def __init__(self, cfg: AFMoEConfig = TRINITY_MINI,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            AFMoELayer(cfg, kind, i < cfg.dense_layers, dtype)
            for i, kind in enumerate(cfg.layer_types))
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, dtype=dtype))
        self.head = nn.Parameter(torch.empty(cfg.dim, cfg.vocab,
                                             dtype=dtype))
        self.register_buffer("experts_held",
                             torch.empty(*cfg.held, 0, dtype=torch.float32))

    def forward(self, x):
        cfg = self.cfg
        if not x.is_floating_point():
            raise ValueError("AFMoE takes embeddings [B, T, D]: it holds no "
                             "embedding table")
        x = x.float()
        if cfg.mup:
            x = x * math.sqrt(cfg.dim)
        cos, sin = rope_tables(torch.arange(x.shape[1], device=x.device),
                               cfg.head_dim, cfg.rope_theta)
        for lyr in self.layers:
            x = lyr(x, cos, sin)
        last = rms_norm(x[:, -1], self.final_norm, cfg.eps)
        return (last @ self.head).float()
