"""AFMoE's FLOP per prompt and the cost of its kernels per launch.

One Trinity-Mini prompt of T = 16,384 tokens on rank 0 of 4-way expert
parallelism (2 FLOP per multiply-add; D 2048, 32 query and 4 KV heads of
128, 24 sliding layers with a window of W = 2048 and 8 full layers, 2
dense SwiGLUs of 6144, 30 expert layers of 128 experts of 1024, top 8, 32
held, 1 shared expert of 1024, vocab 200,192):

- 32 layers' q, k, v, gate and output projections: T x (2 D 9216 + 2
  4096 D) = 28,587,302,322,176
- 24 sliding attentions over the band, sum over i of min(i + 1, W) =
  31,458,304 pairs x 32 heads x 4 x 128 = 12,369,908,465,664
- 8 causal attentions: T (T + 1) / 2 pairs x 32 heads x 4 x 128 =
  17,593,259,786,240
- 2 dense SwiGLUs: T x 3 x 2 D 6144 = 2,473,901,162,496
- 30 expert layers: T x (2 D 128 + 3 x 2 D 1024) for the router and the
  shared expert, and the held experts' T k 32 / 128 = 32,768 expected
  pairs x 3 x 2 D 1024 = 18,811,956,756,480
- the head at the last position: 2 D V = 819,986,432

79,837,148,479,488 in all. Norms, RoPE, the softmax's exponentials, the
gates and the routing's sort are not counted, as ``harness.count_flops``
counts only products. The held experts' pairs are the expectation under
uniform routing: what the seeded weights route differs by a few percent.
"""

from __future__ import annotations

import torch


def _sizes(cfg):
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"], cfg["seq"])


def band_pairs(t: int, window: int) -> int:
    """Query-key pairs of causal attention over t tokens within a window
    (0 for none): the sum over i of min(i + 1, window)."""
    if not window or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def held_pairs(cfg) -> int:
    """The token-expert pairs a layer's held experts take, expected under
    uniform routing."""
    return (cfg["batch"] * cfg["seq"] * cfg["num_experts_per_tok"]
            * cfg["num_experts_held"] // cfg["num_experts"])


def _swiglu(d: int, f: int) -> int:
    """2 FLOP a multiply-add of one token through a SwiGLU of width f."""
    return 3 * 2 * d * f


def flops_per_item(cfg) -> int:
    d, heads, kv, hd, t = _sizes(cfg)
    fe = cfg["moe_intermediate_size"]
    shared = cfg["num_shared_experts"] * fe
    pairs = held_pairs(cfg) // cfg["batch"]
    total = 0
    for i, kind in enumerate(cfg["layer_types"]):
        total += t * (2 * d * (2 * heads + 2 * kv) * hd
                      + 2 * heads * hd * d)
        window = cfg["sliding_window"] if kind == "sliding_attention" else 0
        total += band_pairs(t, window) * heads * 4 * hd
        if i < cfg["num_dense_layers"]:
            total += t * _swiglu(d, cfg["intermediate_size"])
        else:
            total += t * (2 * d * cfg["num_experts"] + _swiglu(d, shared))
            total += pairs * _swiglu(d, fe)
    return total + 2 * d * cfg["vocab_size"]


def kernel_cost(cfg) -> dict:
    """``flash_absorb``: one whole-sequence causal absorb of K3 at [B, T,
    H, Dh] from the identity state, T (T + 1) / 2 pairs of q.k and p.v a
    head; ``flash_window``: one windowed absorb at the same shape, the
    band's pairs. Each reads q, k and v (k and v expanded to H heads, as
    K3 takes them) in the served dtype and m, l [B, H, T] and o [B, T, H,
    Dh] in fp32 once, and writes the new m, l and o. ``moe_experts``: one
    layer's grouped products over the expected held pairs (``held_pairs``)
    through W13 [E_held, D, 2F] then W2 [E_held, F, D]; reads the sorted
    tokens, the gated SwiGLU and both stacks, writes both products'
    outputs, in the served dtype."""
    d, heads, kv, hd, t = _sizes(cfg)
    b = cfg["batch"]
    size = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
    qkv = 3 * b * t * heads * hd * size
    state = 2 * (2 * b * heads * t + b * t * heads * hd) * 4
    pair = b * heads * 4 * hd
    pairs = held_pairs(cfg)
    e, f = cfg["num_experts_held"], cfg["moe_intermediate_size"]
    elements = (pairs * d + e * d * 2 * f + pairs * 2 * f  # W13's product
                + pairs * f + e * f * d + pairs * d)  # W2's product
    return {"flash_absorb": (band_pairs(t, 0) * pair, qkv + state),
            "flash_window": (band_pairs(t, cfg["sliding_window"]) * pair,
                             qkv + state),
            "moe_experts": (pairs * _swiglu(d, f), elements * size)}
