"""Autoregressive decoding with a static KV cache (long-context serving).

Counterpart of ``k8s_device_plugin_tpu/workloads/decode.py`` over the same
LM (``attention.init_lm_params``): a preallocated fp32 cache
[L, B, T_max, Hkv, Dh] per K and V (Hkv = :func:`kv_heads_of`, fewer than
the query heads under GQA), one fixed-shape step per token: a cache write,
one masked grouped attention over the whole cache, the block MLPs.

Where JAX runs the steps as one ``lax.scan``, the port runs a Python loop
of :func:`decode_step`, and writes the cache IN PLACE: a step at position
``pos`` fills slot ``pos`` of every layer. Slots past ``pos`` are masked, so
a prefilled state can be decoded from again and again: each run rewrites
the same slots. The prefill is token by token, as in the JAX package.

Exactness contract: greedy generation through the cache equals greedy
generation recomputed from scratch with ``lm_forward`` at every step
(:func:`reference_generate`). MoE serving (``moe_generate``) waits for the
MoE port.
"""

from __future__ import annotations

import math

import torch

from .attention import (LM, _mlp, _norm, apply_rope, kv_heads_of, layer_qkv,
                        lm_forward, rope_tables)


def init_kv_cache(params: LM, batch: int, max_len: int):
    """Zeroed fp32 K/V buffers [L, B, T_max, Hkv, Dh] on the weights'
    device."""
    heads = params.heads
    dim = params.embed.shape[1]
    shape = (len(params.layers), batch, max_len, kv_heads_of(params, heads),
             dim // heads)
    device = params.embed.device
    return {"k": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device)}


@torch.inference_mode()
def decode_step(params: LM, cache, pos: int, tokens, ffn=None,
                use_rope: bool = False):
    """Feed ``tokens`` [B] at position ``pos``; returns (cache, logits
    [B, V]). The cache is written in place at slot ``pos``. ``ffn``
    swaps the feed-forward as in ``lm_forward``; ``use_rope`` rotates
    this step's q and k at ``pos`` and caches the rotated key."""
    ffn = _mlp if ffn is None else ffn
    heads = params.heads
    x = params.embed[tokens]                         # [B, D]
    b, dim = x.shape
    head_dim = dim // heads
    k_cache, v_cache = cache["k"], cache["v"]
    t_max, kv_h = k_cache.shape[2], k_cache.shape[3]
    # slots past pos are future (zeros) and must not attend
    valid = torch.arange(t_max, device=x.device)[None, :] <= pos
    scale = 1.0 / math.sqrt(head_dim)
    if use_rope:  # one trig table per step, shared by every layer
        cos, sin = rope_tables(torch.tensor([pos], device=x.device),
                               head_dim)
    for li, lyr in enumerate(params.layers):
        h = _norm(x)
        q, k, v = layer_qkv(lyr, h, heads)           # q [B,H,Dh]; kv Hkv
        if use_rope:  # a length-1 sequence at absolute position pos
            q = apply_rope(q[:, None], cos, sin)[:, 0]
            k = apply_rope(k[:, None], cos, sin)[:, 0]
        k_cache[li, :, pos] = k.float()
        v_cache[li, :, pos] = v.float()
        # grouped: query head k*g + i reads kv head k (expand_kv's order),
        # straight from the Hkv-head cache
        q_g = q.float().reshape(b, kv_h, heads // kv_h, head_dim)
        s = torch.einsum("bkgd,btkd->bkgt", q_g, k_cache[li]) * scale
        s = torch.where(valid[:, None, None, :], s, -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgt,btkd->bkgd", p, v_cache[li])
        x = x + o.reshape(b, dim).to(x.dtype) @ lyr.proj
        x = x + ffn(_norm(x), lyr)
    return cache, _norm(x) @ params.embed.T


@torch.inference_mode()
def prefill(params: LM, prompt, max_len: int | None = None, ffn=None,
            steps_budget: int = 0, use_rope: bool = False):
    """Teacher-forced prefill of ``prompt`` [B, P] through
    :func:`decode_step`, one token at a time. Returns (cache, pos,
    last_logits); ``steps_budget`` reserves cache room past the prompt
    when ``max_len`` is defaulted."""
    b, p_len = prompt.shape
    max_len = max_len if max_len is not None else p_len + steps_budget
    if max_len < p_len + steps_budget:
        raise ValueError(f"max_len {max_len} < prompt {p_len} + "
                         f"steps {steps_budget}")
    cache = init_kv_cache(params, b, max_len)
    logits = None
    for pos in range(p_len):
        cache, logits = decode_step(params, cache, pos, prompt[:, pos], ffn,
                                    use_rope)
    return cache, p_len, logits


def sample_token(logits, generator: torch.Generator | None = None,
                 temperature: float = 0.0, top_k: int = 0):
    """One next token from [B, V] logits: greedy at temperature 0, else a
    draw from the temperature-scaled softmax, truncated to the top_k
    candidates when 0 < top_k < V (top_k == 1 is greedy)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    scaled = logits.float() / temperature
    if top_k and top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, -1e30)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def decode_from(params: LM, cache, pos: int, logits, steps: int, ffn=None,
                temperature: float = 0.0, top_k: int = 0,
                generator: torch.Generator | None = None,
                use_rope: bool = False):
    """``steps`` tokens from a prefilled state (``logits``: the prefill's
    last, so the first token is drawn by the same policy as the rest).
    Returns [B, steps] int64. Sampling (temperature > 0) draws from
    ``generator``, which must live on the logits' device."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if temperature and generator is None:
        raise ValueError("sampling (temperature > 0) needs an rng: pass a "
                         "torch.Generator")
    tok = sample_token(logits, generator, temperature, top_k)
    out = [tok]
    for i in range(1, steps):
        cache, logits = decode_step(params, cache, pos + i - 1, tok, ffn,
                                    use_rope)
        tok = sample_token(logits, generator, temperature, top_k)
        out.append(tok)
    return torch.stack(out, dim=1)


def generate(params: LM, prompt, steps: int, max_len: int | None = None,
             ffn=None, use_rope: bool = False):
    """Greedy generation: prefill + decode_from. Returns [B, P + steps]
    (prompt included)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    cache, pos, logits = prefill(params, prompt, max_len, ffn,
                                 steps_budget=steps, use_rope=use_rope)
    gen = decode_from(params, cache, pos, logits, steps, ffn,
                      use_rope=use_rope)
    return torch.cat([prompt, gen.to(prompt.dtype)], dim=1)


@torch.inference_mode()
def reference_generate(params: LM, prompt, steps: int, forward=None):
    """Oracle: greedy continuation recomputed from scratch with the full
    forward (default ``lm_forward``, dense attention) at every step."""
    if forward is None:
        def forward(p, t):
            return lm_forward(p, t)
    seq = prompt
    for _ in range(steps):
        nxt = forward(params, seq)[:, -1].argmax(dim=-1).to(prompt.dtype)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    return seq
