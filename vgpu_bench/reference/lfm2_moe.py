"""LFM2-8B-A1B (LiquidAI, ``model_type`` ``lfm2_moe``) prefill, in plain
fp32: the last position's logits of a batch of prompts.

A stack of pre-norm layers over the residual stream x [B, T, D]: each
layer is ``h = x + Op(RMSNorm_op(x))``, then ``x = h + FFN(RMSNorm_ffn(h))``,
where RMSNorm(x) = w * x / sqrt(mean(x^2) + eps). ``layer_types`` names
each layer's Op:

- ``conv``, the gated short convolution: [B, C, X] = split(u W_in, 3)
  (no bias), v = B * X, z_t = sum_j c_j v_{t - L + 1 + j} over the
  ``conv_L_cache`` = L taps (zeros before t = 0), y = (C * z) W_out;
- ``full_attention``: q, k, v projections to H, Hkv and Hkv heads of Dh,
  a per-head RMSNorm of q and of k (each its own Dh weights), RoPE
  (theta ``rope_theta``, the two halves of the head rotated) at positions
  0..T-1, causal softmax(q k^T / sqrt(Dh)) v with query head h reading KV
  head h // (H / Hkv), and the output projection.

The first ``num_dense_layers`` FFNs are SwiGLU, W2 (silu(W1 u) * W3 u), at
``intermediate_size``; the rest are sparse: s = sigmoid(u W_router) over
``num_experts``, the ``num_experts_per_tok`` experts of largest s +
``expert_bias`` (the bias selects and never weighs), gate g_e = s_e /
(sum of the selected s + 1e-6) x ``routed_scaling_factor``, and the output
sum over the selected e of g_e SwiGLU_e(u) at ``moe_intermediate_size``.
Every token reaches its experts: nothing is dropped. The logits are
RMSNorm_final(x_T) E^T with the head E tied to the embedding table.

Inputs are the prompts' embeddings [B, T, D] (a float tensor) or token ids
[B, T] (looked up in E). The weights are in the port's layout (``layout``):
products [in, out], W1 and W3 side by side as ``w13`` [.., D, 2F], the
convolution's taps as ``kernel`` [L, D], the experts stacked [E, ...].

The forward fits one card beside the weights: each weight is cast to fp32
where it is used, attention runs one sequence at a time, and each expert
takes only the tokens routed to it.
"""

from __future__ import annotations

import math

import torch

from . import rounded

#: added to the selected scores' sum before the gates divide by it
GATE_EPS = 1e-6


def _head_dim(cfg) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def layout(cfg) -> dict:
    """{name: (shape, dtype, init)}: every weight in the served dtype but
    the expert bias, fp32. Products are ``("normal", 1/sqrt(fan-in))``; the
    norms' weights are ``("around", 1.0, 0.1)``, the taps
    ``("normal", 1/sqrt(L))``, and the expert bias ``("around", 0.0,
    0.05)``, near the gaps between the top scores, so that it changes some
    selections."""
    dtype = getattr(torch, cfg["dtype"])
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    heads, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     _head_dim(cfg))
    taps, n_exp = cfg["conv_L_cache"], cfg["num_experts"]
    ff, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    norm = ("around", 1.0, 0.1)

    def dense(fan_in):
        return ("normal", fan_in ** -0.5)
    out = {"embed": ((v, d), dtype, dense(d)),
           "final_norm": ((d,), dtype, norm)}
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        out[p + "op_norm"] = ((d,), dtype, norm)
        out[p + "ffn_norm"] = ((d,), dtype, norm)
        if kind == "conv":
            out[p + "conv.in_proj"] = ((d, 3 * d), dtype, dense(d))
            out[p + "conv.kernel"] = ((taps, d), dtype, dense(taps))
            out[p + "conv.out_proj"] = ((d, d), dtype, dense(d))
        elif kind == "full_attention":
            out[p + "attn.wqkv"] = ((d, (heads + 2 * kv) * hd), dtype,
                                    dense(d))
            out[p + "attn.q_norm"] = ((hd,), dtype, norm)
            out[p + "attn.k_norm"] = ((hd,), dtype, norm)
            out[p + "attn.wo"] = ((heads * hd, d), dtype, dense(heads * hd))
        else:
            raise ValueError(f"layer {i}: no layer type {kind!r}")
        if i < cfg["num_dense_layers"]:
            out[p + "ffn.w13"] = ((d, 2 * ff), dtype, dense(d))
            out[p + "ffn.w2"] = ((ff, d), dtype, dense(ff))
        else:
            out[p + "moe.router"] = ((d, n_exp), dtype, dense(d))
            out[p + "moe.expert_bias"] = ((n_exp,), torch.float32,
                                          ("around", 0.0, 0.05))
            out[p + "moe.w13"] = ((n_exp, d, 2 * fe), dtype, dense(d))
            out[p + "moe.w2"] = ((n_exp, fe, d), dtype, dense(fe))
    return out


def _rms(x, weight, eps):
    return weight.float() * x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                            + eps)


def _swiglu(u, w13, w2, precision):
    h = rounded(u, precision) @ rounded(w13.float(), precision)
    h1, h3 = h.chunk(2, dim=-1)
    a = torch.nn.functional.silu(h1) * h3
    return rounded(a, precision) @ rounded(w2.float(), precision)


def _short_conv(u, w, p, precision):
    bcx = rounded(u, precision) @ rounded(w[p + "conv.in_proj"].float(),
                                          precision)
    b, c, x = bcx.chunk(3, dim=-1)
    v = b * x
    taps = w[p + "conv.kernel"].float()
    n = taps.shape[0]
    z = torch.zeros_like(v)
    for j in range(n):
        shift = n - 1 - j  # tap j reads v_{t - shift}
        z[:, shift:] += taps[j] * v[:, :v.shape[1] - shift]
    return rounded(c * z, precision) @ rounded(
        w[p + "conv.out_proj"].float(), precision)


def _rope(x, positions, theta):
    """x [T, H, Dh]: the two halves of the head dim rotated."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[:, None] * freqs[None]
    cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(u, w, p, cfg, precision):
    heads, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     _head_dim(cfg))
    eps = cfg["norm_eps"]
    wqkv = rounded(w[p + "attn.wqkv"].float(), precision)
    wo = rounded(w[p + "attn.wo"].float(), precision)
    t = u.shape[1]
    positions = torch.arange(t, device=u.device)
    causal = torch.ones(t, t, dtype=torch.bool, device=u.device).tril()
    out = []
    for seq in u:  # one sequence at a time: its scores are [H, T, T]
        qkv = rounded(seq, precision) @ wqkv
        q, k, v = qkv.split([heads * hd, kv * hd, kv * hd], dim=-1)
        q = _rms(q.reshape(t, heads, hd), w[p + "attn.q_norm"], eps)
        k = _rms(k.reshape(t, kv, hd), w[p + "attn.k_norm"], eps)
        q = _rope(q, positions, cfg["rope_theta"])
        k = _rope(k, positions, cfg["rope_theta"])
        group = heads // kv
        k = k.repeat_interleave(group, dim=1)
        v = v.reshape(t, kv, hd).repeat_interleave(group, dim=1)
        s = torch.einsum("qhd,khd->hqk", rounded(q, precision),
                         rounded(k, precision)) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf")).softmax(dim=-1)
        o = torch.einsum("hqk,khd->qhd", rounded(s, precision),
                         rounded(v, precision))
        del s
        out.append(rounded(o.reshape(t, heads * hd), precision) @ wo)
    return torch.stack(out)


def _moe(u, w, p, cfg, precision, sel=None):
    """The sparse FFN of tokens u [..., D]; ``sel`` [N, k], if given, are
    the experts each token takes in place of its own top k."""
    lead = u.shape[:-1]
    u = u.reshape(-1, u.shape[-1])
    logits = rounded(u, precision) @ rounded(w[p + "moe.router"].float(),
                                             precision)
    s = torch.sigmoid(logits)
    if sel is None:
        _, sel = torch.topk(s + w[p + "moe.expert_bias"].float(),
                            cfg["num_experts_per_tok"], dim=-1)
    sel = sel.to(u.device, torch.long)
    g = s.gather(-1, sel)
    g = g / (g.sum(-1, keepdim=True) + GATE_EPS) \
        * cfg["routed_scaling_factor"]
    out = torch.zeros_like(u)
    w13, w2 = w[p + "moe.w13"], w[p + "moe.w2"]
    for e in range(cfg["num_experts"]):
        token, slot = (sel == e).nonzero(as_tuple=True)
        if len(token):
            y = _swiglu(u[token], w13[e], w2[e], precision)
            out.index_add_(0, token, g[token, slot, None] * y)
    return out.reshape(*lead, -1)


def forward(w: dict, x: torch.Tensor, cfg, precision: str = "fp32",
            routing=None):
    """Logits [B, V] in fp32 at the last position of prompts ``x``:
    embeddings [B, T, D] or token ids [B, T], under the weights ``w`` (any
    dtype; each read as fp32 where it is used). ``routing``, if given, is
    the experts each token takes in each sparse layer, in the order of the
    layers ([B T, k] each, tokens in [B, T] order), in place of the
    reference's own selection: a near-tie that another computation breaks
    the other way then moves nothing. The gates are still the reference's
    scores of the given experts."""
    if not x.is_floating_point():
        x = w["embed"][x]
    x = x.float()
    eps = cfg["norm_eps"]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        u = _rms(x, w[p + "op_norm"], eps)
        if kind == "conv":
            h = x + _short_conv(u, w, p, precision)
        else:
            h = x + _attention(u, w, p, cfg, precision)
        del u
        u = _rms(h, w[p + "ffn_norm"], eps)
        if i < cfg["num_dense_layers"]:
            x = h + _swiglu(u, w[p + "ffn.w13"], w[p + "ffn.w2"], precision)
        else:
            x = h + _moe(u, w, p, cfg, precision, None if routing is None
                         else routing[i - cfg["num_dense_layers"]])
        del h, u
    last = _rms(x[:, -1], w["final_norm"], eps)
    return rounded(last, precision) @ rounded(w["embed"].float(),
                                              precision).T
