"""LFM2-MoE (``workloads/lfm2.py``, ``moe.SigmoidMoE``): the port against
the benchmark's plain fp32 reference (``vgpu_bench/reference/lfm2_moe.py``)
on the CPU, at a tiny size on seeded weights, and the pieces that the
comparison alone would not pin down: the short convolution's causality,
the routing's selection and gates, the drop-free expert apply, and the
published widths in the port, the reference's layout and the benchmark's
configuration and counts. There is no JAX counterpart.
"""

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.workloads import lfm2, moe, run
from torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgpu_bench import weights
from vgpu_bench.counts import lfm2_moe as counts
from vgpu_bench.reference import lfm2_moe as reference

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "vgpu_bench", "configs",
    "lfm2-8b-a1b.prefill4k.json")
#: conv and attention layers, each with a dense FFN and with experts
TINY = lfm2.LFM2Config(
    dim=64, layer_types=("conv", "full_attention", "conv", "conv",
                         "full_attention", "conv"),
    dense_layers=2, ffn_hidden=96, expert_hidden=32, experts=8, top_k=2,
    heads=4, kv_heads=2, head_dim=16, vocab=128)


def published() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def as_config(c: lfm2.LFM2Config, dtype: str = "float32", batch: int = 2,
              seq: int = 11) -> dict:
    """The benchmark's configuration keys of the port's sizes ``c``."""
    return {"model": "lfm2_moe", "dtype": dtype, "hidden_size": c.dim,
            "layer_types": list(c.layer_types),
            "num_hidden_layers": len(c.layer_types),
            "num_dense_layers": c.dense_layers,
            "intermediate_size": c.ffn_hidden,
            "moe_intermediate_size": c.expert_hidden,
            "num_experts": c.experts, "num_experts_per_tok": c.top_k,
            "num_attention_heads": c.heads,
            "num_key_value_heads": c.kv_heads, "head_dim": c.head_dim,
            "vocab_size": c.vocab, "conv_L_cache": c.conv_taps,
            "rope_theta": c.rope_theta, "norm_eps": c.eps,
            "routed_scaling_factor": c.route_scale, "batch": batch,
            "seq": seq, "input_shape": [batch, seq, c.dim]}


def port_and_weights(seed: int, dtype=torch.float32):
    cfg = as_config(TINY, str(dtype).split(".")[-1])
    w = weights.make(cfg, seed, "cpu")
    model = lfm2.LFM2MoE(TINY, dtype)
    model.load_state_dict(w)
    return model.eval(), w, cfg


@pytest.mark.parametrize("seed,tokens", [(3, False), (2 ** 40 + 7, False),
                                         (11, True)])
def test_port_matches_reference_in_fp32(seed, tokens):
    """Every layer kind, the routing, the tied head: in fp32 the port and
    the reference compute the same function, to rounding."""
    model, w, cfg = port_and_weights(seed)
    x = torch.randint(TINY.vocab, (2, 11),
                      generator=torch.Generator().manual_seed(seed)) \
        if tokens else weights.inputs(cfg, seed, 0, 0, "cpu")
    with torch.inference_mode():
        got = model(x)
    want = reference.forward(w, x, cfg)
    assert got.dtype == torch.float32 and got.shape == (2, TINY.vocab)
    gap = ((got - want).abs().max() / want.abs().max()).item()
    assert gap < 1e-4, gap


def ports_routing(monkeypatch, model, x):
    """The port's logits of ``x`` and the experts it chose in each sparse
    layer, in the layers' order."""
    taken, route = [], moe.route_sigmoid_topk

    def keep(*args):
        sel, gates = route(*args)
        taken.append(sel)
        return sel, gates
    monkeypatch.setattr(moe, "route_sigmoid_topk", keep)
    with torch.inference_mode():
        return model(x), taken


@pytest.mark.parametrize("seed", [4, 2 ** 40 + 9])
def test_reference_takes_the_ports_routing(monkeypatch, seed):
    """Given the experts the port chose in each sparse layer, the reference
    computes the port's function; given other experts, another one."""
    model, w, cfg = port_and_weights(seed)
    x = weights.inputs(cfg, seed, 0, 0, "cpu")
    got, taken = ports_routing(monkeypatch, model, x)
    assert len(taken) == len(TINY.layer_types) - TINY.dense_layers
    want = reference.forward(w, x, cfg, routing=taken)
    gap = ((got - want).abs().max() / want.abs().max()).item()
    assert gap < 1e-4, gap
    other = reference.forward(
        w, x, cfg, routing=[(t + 1) % TINY.experts for t in taken])
    assert ((other - want).abs().max() / want.abs().max()).item() > 1e-2


def test_routed_alike_reads_the_port_and_the_control():
    """``chip_smoke.lfm2_routed_alike``, which holds the card's forward to
    the reference on the program's routing, read on the CPU in fp32: the
    port to rounding, the float8 control far off."""
    import chip_smoke
    model, _, cfg = port_and_weights(6)
    program, control = chip_smoke.lfm2_routed_alike(
        model, cfg, weights.inputs(cfg, 6, 0, 0, "cpu"))
    assert program < 1e-4 < 1e-2 < control, (program, control)
    assert moe.route_sigmoid_topk.__name__ == "route_sigmoid_topk"


def test_counters_count_only_the_card():
    model, _, cfg = port_and_weights(5)
    _build.launches.clear()
    with torch.inference_mode():
        model(weights.inputs(cfg, 5, 0, 0, "cpu"))
    assert not _build.launches
    assert moe.largest_expert_load() >= 2 * 11 * TINY.top_k / TINY.experts


@pytest.mark.parametrize("t", [0, 1, 5, 9])
def test_short_conv_is_causal(t):
    """Changing input t + 1 leaves every output at or before t unchanged,
    and moves the outputs t + 1 .. t + 3 (the three taps)."""
    model, _, _ = port_and_weights(7)
    conv = model.layers[0].conv
    u = torch.randn(2, 11, TINY.dim, generator=torch.Generator().manual_seed(t))
    changed = u.clone()
    changed[:, t + 1] += 1.0
    with torch.inference_mode():
        a, b = lfm2.short_conv(u, conv), lfm2.short_conv(changed, conv)
    assert torch.equal(a[:, :t + 1], b[:, :t + 1])
    for s in range(t + 1, min(t + 4, 11)):
        assert not torch.allclose(a[:, s], b[:, s])
    assert torch.equal(a[:, t + 4:], b[:, t + 4:])


def test_short_conv_taps_against_conv1d():
    """The shifted multiply-adds are ``conv1d``'s causal depthwise
    convolution over v = B * X, with the kernel [L, D] as [D, 1, L]."""
    model, _, _ = port_and_weights(8)
    conv = model.layers[3].conv
    u = torch.randn(2, 11, TINY.dim, generator=torch.Generator().manual_seed(1))
    b, c, x = (u @ conv.in_proj).chunk(3, dim=-1)
    v = (b * x).transpose(1, 2)
    z = F.conv1d(v, conv.kernel.T[:, None, :], padding=TINY.conv_taps - 1,
                 groups=TINY.dim)[..., :11].transpose(1, 2)
    with torch.no_grad():
        got = lfm2.short_conv(u, conv)
    torch.testing.assert_close(got, (c * z) @ conv.out_proj, rtol=1e-5,
                               atol=1e-5)


def routing_inputs(seed=0, n=64, experts=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, 16, generator=g),
            torch.randn(16, experts, generator=g) / 4)


def test_expert_bias_selects_and_never_weighs():
    """A bias moves selections, and the gates are the selected sigmoid
    scores over their sum, whatever the bias: equal where the selection
    is equal, and the same formula where it moved."""
    h, router = routing_inputs()
    zero = torch.zeros(8)
    bias = torch.zeros(8)
    bias[3] = 0.3
    sel0, g0 = moe.route_sigmoid_topk(h, router, zero, 2)
    sel1, g1 = moe.route_sigmoid_topk(h, router, bias, 2)
    moved = (sel0 != sel1).any(-1)
    assert 0 < int(moved.sum()) < len(h)
    assert torch.equal(g0[~moved], g1[~moved])
    s = torch.sigmoid(h @ router)
    want = s.gather(-1, sel1)
    torch.testing.assert_close(g1, want / (want.sum(-1, keepdim=True)
                                           + moe.GATE_EPS))
    assert (sel1 == 3).any(-1).sum() > (sel0 == 3).any(-1).sum()


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_every_token_gets_exactly_k_experts(top_k):
    h, router = routing_inputs(1, n=200)
    bias = torch.randn(8, generator=torch.Generator().manual_seed(2)) / 10
    sel, gates = moe.route_sigmoid_topk(h, router, bias, top_k)
    assert sel.shape == gates.shape == (200, top_k)
    assert all(len(set(row)) == top_k for row in sel.tolist())
    torch.testing.assert_close(gates.sum(-1), torch.ones(200),
                               rtol=1e-5, atol=1e-5)
    w13 = torch.randn(8, 16, 6)
    w2 = torch.randn(8, 3, 16)
    moe.expert_apply(h, sel, gates, w13, w2)
    counts = moe.expert_apply.last_counts
    assert int(counts.sum()) == 200 * top_k
    assert torch.equal(counts, torch.bincount(sel.flatten(), minlength=8))


@pytest.mark.parametrize("seed,n,top_k", [(0, 50, 4), (1, 7, 2), (2, 1, 3)])
def test_grouped_apply_equals_a_per_token_loop(seed, n, top_k):
    """Sorting the pairs by expert, applying each expert to its own pairs
    and folding the gates into the second product give each token's sum
    over its experts of gate x SwiGLU, computed token by token."""
    g = torch.Generator().manual_seed(seed)
    d, f, e = 16, 12, 8
    h = torch.randn(n, d, generator=g)
    w13 = torch.randn(e, d, 2 * f, generator=g) / 4
    w2 = torch.randn(e, f, d, generator=g) / 4
    sel, gates = moe.route_sigmoid_topk(h, torch.randn(d, e, generator=g),
                                        torch.zeros(e), top_k)
    got = moe.expert_apply(h, sel, gates, w13, w2)
    want = torch.zeros(n, d)
    for i in range(n):
        for j in range(top_k):
            x = sel[i, j]
            h1, h3 = (h[i] @ w13[x]).chunk(2)
            want[i] += gates[i, j] * ((F.silu(h1) * h3) @ w2[x])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_layout_at_published_widths_is_the_ports():
    """The benchmark's weights fill every tensor of the model that
    ``run.build_model`` makes (on ``meta``, as a tenant makes it), at the
    configuration's widths: 8,339,930,560 parameters."""
    cfg = published()
    with torch.device("meta"):
        model = run.build_model(cfg["model"], getattr(torch, cfg["dtype"]),
                                cfg["runner_size"], on_card=True)
    state = model.state_dict()
    layout = reference.layout(cfg)
    assert sorted(state) == sorted(layout)
    for k, (shape, dtype, _) in layout.items():
        assert tuple(state[k].shape) == shape and state[k].dtype == dtype, k
    assert sum(math.prod(s) for s, _, _ in layout.values()) == 8_339_930_560


def test_configuration_is_the_ports_constants():
    """The configuration's published widths are the port's, every one:
    nothing is cut but the embedding lookup."""
    cfg = published()
    assert {k: v for k, v in as_config(lfm2.LFM2_8B_A1B, "bfloat16", 4,
                                       4096).items()
            if k != "model"} == {k: cfg[k] for k in as_config(TINY)
                                 if k != "model"}
    assert cfg["model"] == cfg["model_type"] == "lfm2_moe"
    assert cfg["norm_topk_prob"] and cfg["use_expert_bias"]
    assert not cfg["conv_bias"]
    assert list(cfg["reduced"]) == ["inputs_embeds"]
    assert cfg["seq"] == cfg["runner_size"]
    with pytest.raises(SystemExit):
        run.build_model("lfm2_moe", torch.bfloat16, 4096, train=True)


@pytest.mark.parametrize("argv", [["--mode", "infer"], ["--mode", "train"],
                                  ["--multichip"]])
def test_runner_leaves_lfm2_to_the_benchmark(argv):
    """The runner takes no ``--model lfm2_moe`` in any mode: the model is
    built for the benchmark's tenant, which fills it with its weights."""
    with pytest.raises(SystemExit):
        args = run.parse_args(["--model", "lfm2_moe", "--device", "cpu",
                               *argv])
        run.build_call(args, torch.device("cpu"))


def test_flops_per_item_is_a_hand_count():
    """One prompt of 4096 tokens, 2 FLOP a multiply-add: the short convs,
    the attention projections, the causal half of attention, the dense
    and the active experts' SwiGLUs with the router, and the head at the
    last position."""
    cfg = published()
    t, d = 4096, 2048
    conv = 18 * t * (2 * d * 6144 + 2 * 3 * d + 2 * d * d)
    projections = 6 * t * (2 * d * 3072 + 2 * 2048 * d)
    causal = 6 * (t * (t + 1) // 2) * 32 * 64 * 2 * 2
    dense = 2 * t * (2 * d * 14336 + 2 * 7168 * d)
    experts = 22 * t * (2 * d * 32 + 4 * (2 * d * 3584 + 2 * 1792 * d))
    head = 2 * d * 65536
    assert counts.flops_per_item(cfg) == conv + projections + causal \
        + dense + experts + head == 12_073_354_395_648


def test_kernel_costs_are_hand_counts():
    """K3 at [4, 4096, 32, 64] reads q, k, v in bf16 and the fp32 state
    once and writes the state once; one layer's grouped products move the
    sorted tokens, both expert stacks and both products' outputs."""
    cost = counts.kernel_cost(published())
    pairs = 4 * 4096 * 4
    assert cost["flash_absorb"] == (
        4 * 32 * (4096 * 4097 // 2) * 2 * 2 * 64,
        3 * 4 * 4096 * 32 * 64 * 2 + 2 * (2 * 4 * 32 * 4096
                                          + 4 * 4096 * 32 * 64) * 4)
    assert cost["flash_absorb"][1] == 478_150_656
    assert cost["moe_experts"] == (
        pairs * (2 * 2048 * 3584 + 2 * 1792 * 2048),
        2 * (pairs * 2048 + 32 * 2048 * 3584 + pairs * 3584 + pairs * 1792
             + 32 * 1792 * 2048 + pairs * 2048))
