"""AFMoE (``workloads/afmoe.py``; Trinity-Mini): the port against the
benchmark's plain fp32 reference (``vgpu_bench/reference/afmoe.py``) on
the CPU, at a tiny size on seeded weights, and what that comparison alone
would not pin down: the expert layer's held shares against the uncut
layer, K3's window against a naive banded softmax, which layers take the
window and RoPE, that dropping the window or the output gate shows, and
the published widths in the port, the reference's layout, the
benchmark's configuration and counts; and ``hack/logit_err_sweep.py``,
which placed the configuration's limit. There is no JAX counterpart.
"""

import json
import math
import os
import sys

import pytest
import torch

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.workloads import afmoe, flash, moe, run
from torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgpu_bench import check, tenant, weights
from vgpu_bench.counts import afmoe as counts
from vgpu_bench.reference import afmoe as reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "hack"))
import logit_err_sweep  # noqa: E402

CONFIG = os.path.join(REPO, "vgpu_bench", "configs",
                      "trinity-mini.ep4-prefill16k.json")
S, F = "sliding_attention", "full_attention"
#: 2 dense layers (one of each attention), then one [s, s, s, f] period;
#: T = 24 tokens against a window of 8
TINY = afmoe.AFMoEConfig(
    dim=64, layer_types=(S, F, S, S, S, F), dense_layers=2, ffn_hidden=96,
    expert_hidden=32, experts=8, held=(0, 8), top_k=2, shared_hidden=32,
    heads=4, kv_heads=2, head_dim=16, vocab=128, window=8)
SEQ = 24


def published() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def as_config(c: afmoe.AFMoEConfig, dtype: str = "float32", batch: int = 2,
              seq: int = SEQ) -> dict:
    """The benchmark's configuration keys of the port's sizes ``c``."""
    first, count = c.held
    return {"model": "afmoe", "dtype": dtype, "hidden_size": c.dim,
            "layer_types": list(c.layer_types),
            "num_hidden_layers": len(c.layer_types),
            "num_dense_layers": c.dense_layers,
            "intermediate_size": c.ffn_hidden,
            "moe_intermediate_size": c.expert_hidden,
            "num_experts": c.experts, "num_experts_per_tok": c.top_k,
            "num_experts_held": count, "expert_rank": first // count,
            "num_shared_experts": c.shared_hidden // c.expert_hidden,
            "num_attention_heads": c.heads,
            "num_key_value_heads": c.kv_heads, "head_dim": c.head_dim,
            "vocab_size": c.vocab, "sliding_window": c.window,
            "rope_theta": c.rope_theta, "rms_norm_eps": c.eps,
            "route_scale": c.route_scale, "mup_enabled": c.mup,
            "batch": batch, "seq": seq, "input_shape": [batch, seq, c.dim]}


def port_and_weights(seed: int, c: afmoe.AFMoEConfig = TINY):
    cfg = as_config(c)
    w = weights.make(cfg, seed, "cpu")
    model = afmoe.AFMoE(c, torch.float32)
    model.load_state_dict(w)
    return model.eval(), w, cfg


def gap(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("seed,held", [(3, (0, 8)), (2 ** 40 + 7, (2, 2)),
                                       (11, (6, 2))])
def test_port_matches_reference_in_fp32(seed, held):
    """Both attention kinds, the gate, the sandwich norms, the routing over
    all experts with a held share, the shared expert and the untied head:
    in fp32 the port and the reference compute the same function."""
    c = afmoe.AFMoEConfig(**{**TINY.__dict__, "held": held})
    model, w, cfg = port_and_weights(seed, c)
    x = weights.inputs(cfg, seed, 0, 0, "cpu")
    with torch.inference_mode():
        got = model(x)
    want = reference.forward(w, x, cfg)
    assert got.dtype == torch.float32 and got.shape == (2, TINY.vocab)
    assert gap(got, want) < 1e-4, gap(got, want)


def test_four_held_shares_sum_to_the_uncut_layer():
    """The four ranks' shares of one expert layer (2 of 8 experts each),
    each with the shared expert, summed with the shared expert counted
    once, give the uncut layer of the reference: the port's shares and the
    reference's alike."""
    model, w, cfg = port_and_weights(5)
    whole = model.layers[2].moe
    u = torch.randn(2 * SEQ, TINY.dim,
                    generator=torch.Generator().manual_seed(2))
    want = reference._moe(u, w, "layers.2.", cfg, "fp32")
    shared = whole.shared(u)
    ports, refs = [], []
    for rank in range(4):
        part = moe.SigmoidMoE(TINY.dim, TINY.expert_hidden, TINY.experts,
                              TINY.top_k, held=(2 * rank, 2),
                              shared=whole.shared,
                              route_scale=TINY.route_scale,
                              gate_eps=TINY.gate_eps)
        state = {k: v for k, v in whole.state_dict().items()
                 if not k.startswith("shared.")}
        state["w13"] = state["w13"][2 * rank:2 * rank + 2]
        state["w2"] = state["w2"][2 * rank:2 * rank + 2]
        part.load_state_dict(state, strict=False)
        with torch.inference_mode():
            ports.append(part(u))
        rw = {**w, "layers.2.moe.w13": state["w13"],
              "layers.2.moe.w2": state["w2"]}
        refs.append(reference._moe(u, rw, "layers.2.", {
            **cfg, "num_experts_held": 2, "expert_rank": rank}, "fp32"))
        assert gap(ports[-1], refs[-1]) < 1e-5
    for shares in (ports, refs):
        assert gap(sum(shares) - 3 * shared, want) < 1e-5
    assert min(gap(p - shared, want - shared) for p in ports) > 0.1


def banded(q, k, v, window):
    """Causal softmax(q k^T / sqrt(D)) v with key j visible to query i iff
    i - window < j <= i, written out."""
    t = q.shape[1]
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    visible = (j <= i) & (i - j < window)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    p = s.masked_fill(~visible, float("-inf")).softmax(-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("window", [1, 5, 37, 100, 120])
def test_plain_window_is_a_banded_softmax(window):
    """K3's plain version under a window: W = 1 (each query sees itself),
    W not a multiple of any of K3's key tiles (5, 37), W = T and W > T
    (the causal absorb)."""
    g = torch.Generator().manual_seed(window)
    q, k, v = (torch.randn(2, 100, 3, 16, generator=g) for _ in range(3))
    got = flash.flash_attention(q, k, v, window=window)
    torch.testing.assert_close(got, banded(q, k, v, window), rtol=1e-5,
                               atol=1e-5)
    if window >= 100:
        torch.testing.assert_close(got, flash.flash_attention(q, k, v))


def test_window_keeps_the_carried_state_and_refuses_what_it_does_not_take():
    """A windowed absorb on a carried state is the block absorb under the
    band's mask; a window is whole-sequence only and a whole number."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, 2, 16, generator=g) for _ in range(3))
    m = torch.randn(1, 2, 40, generator=g)
    l = torch.rand(1, 2, 40, generator=g) + 0.5
    o = torch.randn(1, 40, 2, 16, generator=g)
    i = torch.arange(40)[:, None]
    j = torch.arange(40)[None, :]
    want = flash.absorb_block_reference(q, k, v, (j <= i) & (i - j < 9), m,
                                        l, o, 0.25)
    for got, w in zip(flash.flash_absorb(q, k, v, 1, m, l, o, 9), want):
        torch.testing.assert_close(got, w)
    with pytest.raises(ValueError, match="seq_block"):
        flash.flash_attention(q, k, v, seq_block=8, window=9)
    with pytest.raises(ValueError, match="window"):
        flash.flash_absorb(q, k, v, 1, m, l, o, -1)
    assert flash.absorb_route(torch.bfloat16, 64, 40) == "wgmma"
    assert flash.absorb_route(torch.bfloat16, 64, 40, 9) == "mma_sync"
    assert flash.absorb_route(torch.bfloat16, 128, 40) == "mma_sync"


def test_sliding_layers_take_the_window_and_rope_full_layers_neither(
        monkeypatch):
    """Each sliding layer hands K3 the window, each full layer none; and
    RoPE turns only on the sliding layers: rotating a full layer's q and k
    would move its output."""
    windows = []
    absorb = afmoe.flash_attention

    def keep(q, k, v, window=0):
        windows.append(window)
        return absorb(q, k, v, window=window)
    monkeypatch.setattr(afmoe, "flash_attention", keep)
    model, w, cfg = port_and_weights(7)
    x = weights.inputs(cfg, 7, 0, 0, "cpu")
    with torch.inference_mode():
        model(x)
    assert windows == [8 if t == S else 0 for t in TINY.layer_types]
    rotated = []
    monkeypatch.setattr(afmoe, "apply_rope",
                        lambda t, cos, sin: rotated.append(1) or t)
    with torch.inference_mode():
        model(x)
    assert len(rotated) == 2 * TINY.layer_types.count(S)


@pytest.mark.parametrize("fault", ["no_window", "no_gate"])
def test_reference_comparison_sees_a_dropped_window_or_gate(fault):
    """The faults ``hack/logit_err_sweep.py`` plants: the sliding layers
    run causal without their window, or the attention output goes
    ungated. The port then leaves the reference far behind, where it
    agreed to 1e-4; and the fault is gone once its context closes."""
    model, w, cfg = port_and_weights(3)
    x = weights.inputs(cfg, 3, 0, 0, "cpu")
    want = reference.forward(w, x, cfg)
    with logit_err_sweep._faults()[fault](), torch.inference_mode():
        assert gap(model(x), want) > 1e-2
    with torch.inference_mode():
        assert gap(model(x), want) < 1e-4


def test_counters_count_only_the_card():
    model, _, cfg = port_and_weights(5)
    _build.launches.clear()
    with torch.inference_mode():
        model(weights.inputs(cfg, 5, 0, 0, "cpu"))
    assert not _build.launches
    assert moe.largest_expert_load() >= 2 * SEQ * TINY.top_k / TINY.experts


def test_held_experts_must_be_the_routers():
    for held in ((0, 0), (6, 4), (-1, 2)):
        with pytest.raises(ValueError, match="held experts"):
            moe.SigmoidMoE(16, 8, 8, 2, held=held)
    with pytest.raises(ValueError, match="embeddings"):
        port_and_weights(1)[0](torch.zeros(1, 4, dtype=torch.long))


def test_layout_at_published_widths_is_the_ports():
    """The benchmark's weights fill every tensor of the model that
    ``run.build_model`` makes (on ``meta``, as a tenant makes it), at the
    configuration's widths: 7,594,587,904 parameters held."""
    cfg = published()
    with torch.device("meta"):
        model = run.build_model(cfg["model"], getattr(torch, cfg["dtype"]),
                                cfg["runner_size"], on_card=True)
    state = model.state_dict()
    layout = reference.layout(cfg)
    assert sorted(state) == sorted(layout)
    for k, (shape, dtype, _) in layout.items():
        assert tuple(state[k].shape) == shape and state[k].dtype == dtype, k
    assert sum(math.prod(s) for s, _, _ in layout.values()) == 7_594_587_904
    with pytest.raises(SystemExit):
        run.build_model("afmoe", torch.bfloat16, 16384, train=True)


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_tenant_refuses_a_configuration_that_holds_other_experts(
        monkeypatch, rank):
    """The held range is laid out once more by the reference, from the
    configuration's ``expert_rank`` and ``num_experts_held``, as the
    shape of ``experts_held``: a tenant builds the model that holds the
    configuration's experts, and refuses one that holds others (here the
    tiny model holding rank 0's 2 of 8)."""
    cfg = {**as_config(afmoe.AFMoEConfig(**{**TINY.__dict__,
                                            "held": (0, 2)})),
           "expert_rank": rank, "runner_size": SEQ}
    monkeypatch.setattr(run, "build_model", lambda *a, **k: afmoe.AFMoE(
        afmoe.AFMoEConfig(**{**TINY.__dict__, "held": (0, 2)}),
        torch.float32))
    if rank:
        with pytest.raises(SystemExit, match="experts_held"):
            tenant.build(cfg, 4, "cpu")
    else:
        assert tenant.build(cfg, 4, "cpu").experts_held.shape == (0, 2, 0)


def test_configuration_is_the_ports_constants():
    """The configuration's published widths are the port's rank 0 of 4,
    every one; nothing is cut but the experts held and the embedding
    lookup."""
    cfg = published()
    port = as_config(afmoe.TRINITY_MINI_EP4, "bfloat16", 1, 16384)
    assert {k: cfg[k] for k in port if k != "model"} == {
        k: v for k, v in port.items() if k != "model"}
    assert cfg["model"] == cfg["model_type"] == "afmoe"
    assert cfg["score_func"] == "sigmoid" and cfg["route_norm"]
    assert not cfg["tie_word_embeddings"]
    assert cfg["num_hidden_layers"] == len(cfg["layer_types"]) == 32
    assert afmoe.TRINITY_MINI_EP4.gate_eps == reference.GATE_EPS
    assert sorted(cfg["reduced"]) == ["inputs_embeds", "num_experts_held"]
    assert cfg["seq"] == cfg["runner_size"]
    assert sorted(cfg["kernels"]) == ["flash_absorb", "swiglu"]


def test_flops_per_item_is_a_hand_count():
    """One prompt of 16,384 tokens, 2 FLOP a multiply-add: the gated
    projections, the band of the 24 sliding layers and the causal half of
    the 8 full ones, the dense SwiGLUs, the router, the shared expert and
    the held experts' expected 32,768 pairs, and the head."""
    t, d = 16384, 2048
    projections = 32 * t * (2 * d * 9216 + 2 * 4096 * d)
    band = 2048 * 2049 // 2 + (t - 2048) * 2048
    sliding = 24 * band * 32 * 4 * 128
    full = 8 * (t * (t + 1) // 2) * 32 * 4 * 128
    dense = 2 * t * 6 * d * 6144
    experts = 30 * (t * (2 * d * 128 + 6 * d * 1024) + 32768 * 6 * d * 1024)
    head = 2 * d * 200192
    assert counts.flops_per_item(published()) == projections + sliding \
        + full + dense + experts + head == 79_837_148_479_488


def test_kernel_costs_are_hand_counts():
    """K3 at [1, 16384, 32, 128], causal and over the band, reads q, k, v in
    bf16 and the fp32 state once and writes the state once; one layer's
    grouped products move the sorted tokens, the 32 held experts' stacks
    and both products' outputs."""
    cost = counts.kernel_cost(published())
    nbytes = 3 * 16384 * 32 * 128 * 2 + 2 * (2 * 32 * 16384
                                             + 16384 * 32 * 128) * 4
    assert cost["flash_absorb"] == (32 * (16384 * 16385 // 2) * 4 * 128,
                                    nbytes)
    assert cost["flash_window"] == (32 * 31_458_304 * 4 * 128, nbytes)
    pairs = 32768
    assert cost["moe_experts"] == (
        pairs * 6 * 2048 * 1024,
        2 * (pairs * 2048 + 32 * 2048 * 2048 + pairs * 2048 + pairs * 1024
             + 32 * 1024 * 2048 + pairs * 2048))


def test_a_sweep_seed_reads_what_the_benchmark_reads():
    """``hack/logit_err_sweep.py``'s readings of a seed are the benchmark's
    own ``logit_err`` of the program on the pool (here a tiny LSTM, which
    the tenant builds at any width), with the control's beside it."""
    with open(os.path.join(REPO, "vgpu_bench", "configs",
                           "lstm.case5.1.json")) as f:
        cfg = {**json.load(f), "batch": 2, "time_steps": 3, "features": 8,
               "runner_size": 8, "input_shape": [2, 3, 8], "kernels": []}
    seed, cpu = 2 ** 33 + 5, torch.device("cpu")
    out = logit_err_sweep.readings(cfg, seed, cpu, 2, True, [])
    assert sorted(out) == ["control", "program", "seed"]
    model = tenant.build(cfg, seed, cpu)
    with torch.inference_mode():
        ys = [model(weights.inputs(cfg, seed, 0, j, cpu)) for j in range(2)]
    want, compared = check.logit_err(cfg, seed, {0: list(enumerate(ys))},
                                     cpu)
    assert compared == 2 and out["program"] == want
    assert out["program"] < cfg["limits"]["logit_err"]
    assert out["control"] > out["program"]
    assert logit_err_sweep.ranges([out, {**out, "program": 1.0}]) \
        == {"program": [out["program"], 1.0],
            "control": [out["control"]] * 2}
