"""LFM2-MoE's FLOP per prompt and the cost of its kernels per launch.

One LFM2-8B-A1B prompt of T = 4096 tokens (2 FLOP per multiply-add;
D 2048, 32 query and 8 KV heads of 64, 4 of 32 experts of width 1792,
dense width 7168, vocab 65,536):

- 18 short convolutions: T x (2 D 3D + 2 x 3 D + 2 D D) = 2,474,807,132,160
- 6 attention layers' projections: T x (2 D 3072 + 2 D D) = 515,396,075,520
- 6 causal attentions: T (T + 1) / 2 pairs x 32 heads x 4 x 64 =
  412,417,523,712
- 2 dense SwiGLUs: T x (2 D 14336 + 2 7168 D) = 721,554,505,728
- 22 expert layers: T x (2 D 32 + 4 x (2 D 3584 + 2 1792 D)) =
  7,948,910,723,072 (the 4 active experts only)
- the tied head at the last position: 2 D V = 268,435,456

12,073,354,395,648 in all. Norms, RoPE, the softmax's exponentials, the
gates and the routing's sort are not counted, as ``harness.count_flops``
counts only products.
"""

from __future__ import annotations

import torch


def _sizes(cfg):
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return (cfg["hidden_size"], heads, kv, cfg["hidden_size"] // heads,
            cfg["seq"])


def _experts_per_token(cfg) -> int:
    """2 FLOP a multiply-add of one token through one expert's SwiGLU."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return 2 * d * 2 * f + 2 * f * d


def flops_per_item(cfg) -> int:
    d, heads, kv, hd, t = _sizes(cfg)
    types = cfg["layer_types"]
    dense = cfg["num_dense_layers"]
    total = 0
    for i, kind in enumerate(types):
        if kind == "conv":
            total += t * (2 * d * 3 * d + 2 * cfg["conv_L_cache"] * d
                          + 2 * d * d)
        else:
            total += t * (2 * d * (heads + 2 * kv) * hd + 2 * heads * hd * d)
            total += t * (t + 1) // 2 * heads * 4 * hd
        if i < dense:
            total += t * 3 * 2 * d * cfg["intermediate_size"]
        else:
            total += t * (2 * d * cfg["num_experts"]
                          + cfg["num_experts_per_tok"]
                          * _experts_per_token(cfg))
    return total + 2 * d * cfg["vocab_size"]


def kernel_cost(cfg) -> dict:
    """``flash_absorb``: one whole-sequence causal absorb of K3 at [B, T,
    H, Dh] from the identity state: T (T + 1) / 2 pairs of q.k and p.v a
    head; reads q, k and v (k and v expanded to H heads, as K3 takes them)
    in the served dtype and m, l [B, H, T] and o [B, T, H, Dh] in fp32,
    writes the new m, l and o. ``moe_experts``: one layer's grouped
    products, B T k token-expert pairs through W13 [E, D, 2F] then W2 [E,
    F, D]; reads the sorted tokens, the gated SwiGLU and both stacks, writes
    both products' outputs, in the served dtype."""
    d, heads, kv, hd, t = _sizes(cfg)
    b = cfg["batch"]
    size = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
    qkv = 3 * b * t * heads * hd * size
    state = 2 * (2 * b * heads * t + b * t * heads * hd) * 4
    absorb = (b * heads * (t * (t + 1) // 2) * 4 * hd, qkv + state)
    pairs = b * t * cfg["num_experts_per_tok"]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    elements = (pairs * d + e * d * 2 * f + pairs * 2 * f  # W13's product
                + pairs * f + e * f * d + pairs * d)  # W2's product
    return {"flash_absorb": absorb,
            "moe_experts": (pairs * _experts_per_token(cfg),
                            elements * size)}
