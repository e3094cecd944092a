"""LFM2-MoE's SwiGLU and gate in one pass (``workloads/swiglu.py``, K6).

On the CPU: the wrapper takes its plain version, which is the ATen chain
the model ran before the kernel, in the same order and dtype, and counts
no launch; the expert apply and the model's forward give what that chain
gives. On the card (marked ``cuda``, skipped without one): the kernel is
bit-equal to the chain at LFM2-8B-A1B's two shapes and at ragged row
counts, refuses what it does not take, and a reduced LFM2 stack counts one
launch a layer with logits bit-equal to the chain's.
"""

import pytest
import torch
import torch.nn.functional as F

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.workloads import lfm2, moe, swiglu
from torch_support import one_torch_thread  # noqa: F401 (autouse)

DTYPES = [torch.float32, torch.bfloat16]


def _h13(rows, hidden, dtype, seed, device="cpu"):
    """[rows, 2 * hidden] in ``dtype``, spread wide enough that the SiLU
    meets its tails (expf(-x) overflows below about -88)."""
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(rows, 2 * hidden, generator=g, device=device) * 3
    h.view(-1)[::97] *= 40
    return h.to(dtype)


def _gate(rows, dtype, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(rows, generator=g, device=device).to(dtype)


def _chain(h13, g=None):
    """The chain the model ran before K6 (``expert_apply``'s bf16 branch;
    without a gate ``lfm2.SwiGLU``'s), written out."""
    hidden = h13.shape[-1] // 2
    a = F.silu(h13[..., :hidden]).mul_(h13[..., hidden:])
    return a if g is None else a.mul_(g[..., None])


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(13, 24), (2, 5, 40)])
def test_wrapper_takes_the_plain_chain_on_the_cpu(shape, dtype, gated):
    *lead, hidden = shape
    h13 = _h13(int(torch.tensor(lead).prod()), hidden, dtype, seed=hidden)
    h13 = h13.view(*lead, 2 * hidden)
    g = _gate(h13.numel() // (2 * hidden), dtype, 1).view(lead) \
        if gated else None
    before = _build.launches["swiglu_gate"]
    got = swiglu.swiglu_gate(h13, g)
    assert _build.launches["swiglu_gate"] == before
    want = _chain(h13, g)
    assert got.dtype == dtype and got.shape == (*lead, hidden)
    assert torch.equal(got, want)
    assert torch.equal(swiglu.swiglu_gate_reference(h13, g), want)


def _expert_apply_loop(h, sel, gates, w13, w2):
    """``expert_apply``'s CPU loop as it stood before K6."""
    n, k = sel.shape
    hidden = w2.shape[1]
    experts, order = torch.sort(sel.reshape(-1), stable=True)
    ends = torch.searchsorted(experts, torch.arange(1, w2.shape[0] + 1),
                              out_int32=True)
    xs = h.index_select(0, order // k)
    g = gates.reshape(-1)[order].to(h.dtype)[:, None]
    ys = torch.empty_like(xs)
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            rows = slice(start, end)
            h13 = xs[rows] @ w13[e]
            ys[rows] = (F.silu(h13[:, :hidden]) * h13[:, hidden:]
                        * g[rows]) @ w2[e]
            start = end
    place = torch.empty_like(order)
    place[order] = torch.arange(len(order))
    return ys.index_select(0, place).view(n, k, -1).sum(dim=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_expert_apply_on_the_cpu_is_unchanged(dtype):
    g = torch.Generator().manual_seed(7)
    d, f, e, n, k = 32, 24, 8, 40, 3
    h = torch.randn(n, d, generator=g).to(dtype)
    w13 = (torch.randn(e, d, 2 * f, generator=g) / 4).to(dtype)
    w2 = (torch.randn(e, f, d, generator=g) / 4).to(dtype)
    sel, gates = moe.route_sigmoid_topk(h, torch.randn(d, e, generator=g),
                                        torch.zeros(e), k)
    before = _build.launches["swiglu_gate"]
    got = moe.expert_apply(h, sel, gates, w13, w2)
    assert _build.launches["swiglu_gate"] == before
    assert torch.equal(got, _expert_apply_loop(h, sel, gates, w13, w2))


#: a reduced LFM2 stack: one dense layer, then experts; attention at K3's
#: head dim 64; every hidden width a multiple of 8
SMALL = lfm2.LFM2Config(
    dim=128, layer_types=("conv", "full_attention", "conv", "conv"),
    dense_layers=1, ffn_hidden=96, expert_hidden=32, experts=8, top_k=2,
    heads=2, kv_heads=1, head_dim=64, vocab=256)


def _small_model(dtype, device="cpu"):
    """:data:`SMALL` on seeded weights: matrices normal over sqrt(fan-in),
    norms 1, the expert bias small."""
    g = torch.Generator().manual_seed(3)
    model = lfm2.LFM2MoE(SMALL, dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name.endswith("expert_bias") or p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
            else:
                p.copy_(torch.randn(p.shape, generator=g)
                        * p.shape[-2] ** -0.5)
    return model.to(device).eval()


def _forward_with_chain(monkeypatch, model, x):
    """``model(x)`` with the SwiGLUs forced through the plain chain."""
    with monkeypatch.context() as m:
        m.setattr(lfm2, "swiglu_gate", _chain)
        m.setattr(moe, "swiglu_gate", _chain)
        with torch.inference_mode():
            return model(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lfm2_forward_on_the_cpu_is_unchanged(monkeypatch, dtype):
    model = _small_model(dtype)
    x = torch.randn(2, 9, SMALL.dim, generator=torch.Generator()
                    .manual_seed(1))
    before = _build.launches["swiglu_gate"]
    with torch.inference_mode():
        got = model(x)
    assert _build.launches["swiglu_gate"] == before
    assert torch.equal(got, _forward_with_chain(monkeypatch, model, x))


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


#: (rows, hidden, gated): an MoE layer's pairs and a dense layer's tokens
#: of LFM2-8B-A1B at the cell's 4 x 4096, then ragged row counts and
#: widths whose octets do not fill a warp
CARD_CASES = [(65536, 1792, True), (16384, 7168, False),
              *((rows, hidden, gated) for rows in (1, 7, 4097)
                for hidden, gated in ((1792, True), (7168, False),
                                      (40, True)))]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hidden,gated", CARD_CASES)
def test_kernel_is_bit_equal_to_the_chain(cuda, rows, hidden, gated):
    h13 = _h13(rows, hidden, torch.bfloat16, rows + hidden, cuda)
    g = _gate(rows, torch.bfloat16, 2, cuda) if gated else None
    before = _build.launches["swiglu_gate"]
    got = swiglu.swiglu_gate(h13, g)
    torch.cuda.synchronize()
    assert _build.launches["swiglu_gate"] == before + 1
    assert got.shape == (rows, hidden) and got.is_contiguous()
    assert torch.equal(got, _chain(h13, g))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    h13 = _h13(6, 16, torch.bfloat16, 0, cuda)
    flat = torch.zeros(6 * 32 + 1, dtype=torch.bfloat16, device=cuda)
    g = _gate(6, torch.bfloat16, 0, cuda)
    cases = [(_h13(6, 12, torch.bfloat16, 0, cuda), None, "multiple of 8"),
             (flat[1:].view(6, 32), None, "aligned"),
             (_h13(6, 32, torch.bfloat16, 0, cuda)[:, ::2], None,
              "contiguous"),
             (h13, g.float(), "gate"), (h13, g[:5], "gate")]
    before = _build.launches["swiglu_gate"]
    for t, gate, match in cases:
        with pytest.raises(ValueError, match=match):
            swiglu.swiglu_gate(t, gate)
    assert _build.launches["swiglu_gate"] == before


@pytest.mark.cuda
def test_small_lfm2_counts_one_launch_a_layer_and_is_bit_equal(
        cuda, monkeypatch):
    model = _small_model(torch.bfloat16, cuda)
    x = torch.randn(2, 256, SMALL.dim, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    before = _build.launches["swiglu_gate"]
    with torch.inference_mode():
        got = model(x)
    torch.cuda.synchronize()
    assert _build.launches["swiglu_gate"] - before == len(SMALL.layer_types)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, _forward_with_chain(monkeypatch, model, x))
