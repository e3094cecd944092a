"""AFMoE (Arcee, ``model_type`` ``afmoe``; Trinity-Mini) prefill, in plain
fp32: the last position's logits of a batch of prompts, as one rank of an
expert-parallel deployment.

A stack of layers over the residual stream x [B, T, D], the input
embeddings times sqrt(D) when ``mup_enabled``. Each layer is ``h = x +
RMSNorm_post_attn(Attn(RMSNorm_in(x)))``, then ``x = h +
RMSNorm_post_mlp(FFN(RMSNorm_pre_mlp(h)))``, where RMSNorm(x) = w * x /
sqrt(mean(x^2) + eps):

- Attn: q, k, v projections of u to H, Hkv, Hkv heads of Dh and a gate
  projection g = u W_gate [H Dh]; a per-head RMSNorm of q and of k; on a
  ``sliding_attention`` layer RoPE (theta ``rope_theta``, the two halves of
  the whole head dim rotated) at positions 0..T-1, on a ``full_attention``
  layer none; softmax(q k^T / sqrt(Dh)) v with query head h reading KV
  head h // (H / Hkv), key j visible to query i iff j <= i and, on a
  sliding layer, i - ``sliding_window`` < j; the output times sigmoid(g),
  element by element, then the output projection;
- FFN of the first ``num_dense_layers`` layers: SwiGLU, W2 (silu(W1 u) *
  W3 u), at ``intermediate_size``; of the rest, s = sigmoid(u W_router)
  over ``num_experts``, the ``num_experts_per_tok`` experts of largest s +
  ``expert_bias`` (the bias selects and never weighs), gates g_e = s_e /
  (sum of the selected s + :data:`GATE_EPS`) x ``route_scale``, and the
  output the sum over the selected experts held here of g_e SwiGLU_e(u)
  at ``moe_intermediate_size``, plus the shared SwiGLU of
  ``num_shared_experts`` x ``moe_intermediate_size`` that every token
  takes;
- the logits: RMSNorm_final(x_T) W_head, the head untied.

The experts held here are ``expert_rank`` x ``num_experts_held`` .. that
+ ``num_experts_held`` - 1 of each layer's ``num_experts``: the pairs
routed to experts held on other ranks add nothing, as on a rank of an
expert-parallel deployment run without its exchange. With
``num_experts_held`` = ``num_experts`` the layer is whole.

Inputs are the prompts' embeddings [B, T, D] (a float tensor): no
embedding table is held. The weights are in the port's layout
(``layout``): products [in, out], q, k, v and the gate side by side as
``wqkvg``, W1 and W3 side by side as ``w13``, the held experts stacked
[E_held, ...]; ``experts_held`` is empty, of shape [first, count, 0] (the
held range).

The forward fits one card beside the weights at T = 16,384: each weight
is cast to fp32 where it is used, attention runs one sequence and
:data:`QUERY_BLOCK` queries at a time over only the keys the block can
see, and each expert takes only the tokens routed to it.
"""

from __future__ import annotations

import math

import torch

from . import rounded

#: added to the selected scores' sum before the gates divide by it (the
#: reading of ``modeling_afmoe.py``'s router; the config states none)
GATE_EPS = 1e-20
#: queries a step of the blocked attention: a full layer's scores at T =
#: 16,384 are then at most 32 heads x 512 x 16,384 fp32, 1.07 GB
QUERY_BLOCK = 512


def held(cfg) -> tuple[int, int]:
    """(first, count) of each expert layer's experts held here."""
    count = cfg["num_experts_held"]
    return cfg["expert_rank"] * count, count


def layout(cfg) -> dict:
    """{name: (shape, dtype, init)}: every weight in the served dtype but
    the expert bias, fp32. Products are ``("normal", 1/sqrt(fan-in))``; the
    norms' weights are ``("around", 1.0, 0.1)`` and the expert bias
    ``("around", 0.0, 0.05)``, near the gaps between the top scores, so
    that it changes some selections."""
    dtype = getattr(torch, cfg["dtype"])
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    heads, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["head_dim"])
    ff, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = cfg["num_shared_experts"] * fe
    first, count = held(cfg)
    norm = ("around", 1.0, 0.1)

    def dense(fan_in):
        return ("normal", fan_in ** -0.5)
    # no value, and no draw: its shape [first, count, 0] states the experts
    # held, so that a tenant's layout check refuses a program that holds
    # others
    out = {"experts_held": ((first, count, 0), torch.float32,
                            ("normal", 0.0)),
           "final_norm": ((d,), dtype, norm),
           "head": ((d, v), dtype, dense(d))}
    for i, kind in enumerate(cfg["layer_types"]):
        if kind not in ("sliding_attention", "full_attention"):
            raise ValueError(f"layer {i}: no layer type {kind!r}")
        p = f"layers.{i}."
        for name in ("input_norm", "post_attn_norm", "pre_mlp_norm",
                     "post_mlp_norm"):
            out[p + name] = ((d,), dtype, norm)
        out[p + "attn.wqkvg"] = ((d, (2 * heads + 2 * kv) * hd), dtype,
                                 dense(d))
        out[p + "attn.q_norm"] = ((hd,), dtype, norm)
        out[p + "attn.k_norm"] = ((hd,), dtype, norm)
        out[p + "attn.wo"] = ((heads * hd, d), dtype, dense(heads * hd))
        if i < cfg["num_dense_layers"]:
            out[p + "ffn.w13"] = ((d, 2 * ff), dtype, dense(d))
            out[p + "ffn.w2"] = ((ff, d), dtype, dense(ff))
        else:
            out[p + "moe.router"] = ((d, cfg["num_experts"]), dtype,
                                     dense(d))
            out[p + "moe.expert_bias"] = ((cfg["num_experts"],),
                                          torch.float32,
                                          ("around", 0.0, 0.05))
            out[p + "moe.w13"] = ((count, d, 2 * fe), dtype, dense(d))
            out[p + "moe.w2"] = ((count, fe, d), dtype, dense(fe))
            out[p + "moe.shared.w13"] = ((d, 2 * fs), dtype, dense(d))
            out[p + "moe.shared.w2"] = ((fs, d), dtype, dense(fs))
    return out


def _rms(x, weight, eps):
    return weight.float() * x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                            + eps)


def _swiglu(u, w13, w2, precision):
    h = rounded(u, precision) @ rounded(w13.float(), precision)
    h1, h3 = h.chunk(2, dim=-1)
    a = torch.nn.functional.silu(h1) * h3
    return rounded(a, precision) @ rounded(w2.float(), precision)


def _rope(x, positions, theta):
    """x [T, H, Dh]: the two halves of the head dim rotated."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[:, None] * freqs[None]
    cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _softmax_v(q, k, v, window, precision):
    """softmax(q k^T / sqrt(Dh)) v of one sequence, q [T, H, Dh] and k, v
    [T, H, Dh], causal and within ``window`` (0 for none), computed
    :data:`QUERY_BLOCK` queries at a time over the keys they can see."""
    t, _, hd = q.shape
    out = torch.empty_like(q)
    for q0 in range(0, t, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, t)
        k0 = max(0, q0 - window + 1) if window else 0
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(k0, q1, device=q.device)[None, :]
        visible = cols <= rows
        if window:
            visible &= rows - cols < window
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[k0:q1]) / math.sqrt(hd)
        s = s.masked_fill(~visible, float("-inf")).softmax(dim=-1)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", rounded(s, precision),
                                  v[k0:q1])
        del s
    return out


def _attention(u, w, p, cfg, window, precision):
    heads, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    wqkvg = rounded(w[p + "attn.wqkvg"].float(), precision)
    wo = rounded(w[p + "attn.wo"].float(), precision)
    t = u.shape[1]
    positions = torch.arange(t, device=u.device)
    group = heads // kv
    out = []
    for seq in u:  # one sequence at a time
        q, k, v, g = (rounded(seq, precision) @ wqkvg).split(
            [heads * hd, kv * hd, kv * hd, heads * hd], dim=-1)
        q = _rms(q.reshape(t, heads, hd), w[p + "attn.q_norm"], eps)
        k = _rms(k.reshape(t, kv, hd), w[p + "attn.k_norm"], eps)
        if window:
            q = _rope(q, positions, cfg["rope_theta"])
            k = _rope(k, positions, cfg["rope_theta"])
        k = rounded(k.repeat_interleave(group, dim=1), precision)
        v = rounded(v.reshape(t, kv, hd).repeat_interleave(group, dim=1),
                    precision)
        o = _softmax_v(rounded(q, precision), k, v, window, precision)
        o = o.reshape(t, heads * hd) * torch.sigmoid(g)
        out.append(rounded(o, precision) @ wo)
    return torch.stack(out)


def _moe(u, w, p, cfg, precision):
    """The sparse FFN of tokens u [..., D]: the held experts' share and the
    shared expert."""
    lead = u.shape[:-1]
    u = u.reshape(-1, u.shape[-1])
    logits = rounded(u, precision) @ rounded(w[p + "moe.router"].float(),
                                             precision)
    s = torch.sigmoid(logits)
    _, sel = torch.topk(s + w[p + "moe.expert_bias"].float(),
                        cfg["num_experts_per_tok"], dim=-1)
    g = s.gather(-1, sel)
    g = g / (g.sum(-1, keepdim=True) + GATE_EPS) * cfg["route_scale"]
    out = _swiglu(u, w[p + "moe.shared.w13"], w[p + "moe.shared.w2"],
                  precision)
    first, count = held(cfg)
    w13, w2 = w[p + "moe.w13"], w[p + "moe.w2"]
    for e in range(count):
        token, slot = (sel == first + e).nonzero(as_tuple=True)
        if len(token):
            y = _swiglu(u[token], w13[e], w2[e], precision)
            out.index_add_(0, token, g[token, slot, None] * y)
    return out.reshape(*lead, -1)


def forward(w: dict, x: torch.Tensor, cfg, precision: str = "fp32"):
    """Logits [B, V] in fp32 at the last position of prompts ``x``,
    embeddings [B, T, D], under the weights ``w`` (any dtype; each read as
    fp32 where it is used)."""
    x = x.float()
    if cfg["mup_enabled"]:
        x = x * math.sqrt(cfg["hidden_size"])
    eps = cfg["rms_norm_eps"]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        window = cfg["sliding_window"] if kind == "sliding_attention" else 0
        a = _attention(_rms(x, w[p + "input_norm"], eps), w, p, cfg, window,
                       precision)
        h = x + _rms(a, w[p + "post_attn_norm"], eps)
        del a
        u = _rms(h, w[p + "pre_mlp_norm"], eps)
        if i < cfg["num_dense_layers"]:
            y = _swiglu(u, w[p + "ffn.w13"], w[p + "ffn.w2"], precision)
        else:
            y = _moe(u, w, p, cfg, precision)
        x = h + _rms(y, w[p + "post_mlp_norm"], eps)
        del h, u, y
    last = _rms(x[:, -1], w["final_norm"], eps)
    return rounded(last, precision) @ rounded(w["head"].float(), precision)
