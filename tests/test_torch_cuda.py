"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build at
first use) and skips without one. Run them on the card with:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.monitor import dutyprobe
from k8s_device_plugin_torch.workloads import flash, harness, pallas_ops
from k8s_device_plugin_torch.workloads.lstm import LSTMClassifier

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("size", [8, 32, 128])
def test_probe_chain_kernel_matches_plain(cuda, size):
    x, w = (torch.from_numpy(a).to(cuda)
            for a in dutyprobe.probe_operands(size))
    before = dutyprobe.probe_chain.launches
    got = dutyprobe.probe_chain(x, w, 16)
    torch.cuda.synchronize()
    assert dutyprobe.probe_chain.launches == before + 1
    want = dutyprobe.probe_chain_reference(x, w, 16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
# (250, 64, 256): the ring route over three row blocks of 112
@pytest.mark.parametrize("batch,features,hidden", [
    (8, 128, 128), (3, 30, 100), (100, 300, 1024), (250, 64, 256)])
def test_lstm_cell_kernel_matches_plain(cuda, dtype, tol, batch, features,
                                        hidden):
    rng = np.random.default_rng(0)
    shapes = [(batch, features), (batch, hidden), (batch, hidden),
              (features, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,)]
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             * (0.1 if i >= 3 else 1.0)).to(cuda, dtype)
            for i, s in enumerate(shapes)]
    before = pallas_ops.lstm_cell.launches
    got = pallas_ops.lstm_cell(*args)
    torch.cuda.synchronize()
    assert pallas_ops.lstm_cell.launches == before + 1
    want = pallas_ops.lstm_cell_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("batch,features,hidden", [
    (8, 128, 128), (100, 300, 1024)])
def test_lstm_cell_kernel_reads_unaligned_bf16_inputs(cuda, batch, features,
                                                      hidden):
    # each input one element past an aligned address: no vector load fits,
    # so every chunk takes the element-wise path
    rng = np.random.default_rng(1)
    shapes = [(batch, features), (batch, hidden), (batch, hidden),
              (features, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,)]
    args = []
    for i, s in enumerate(shapes):
        flat = torch.from_numpy(rng.standard_normal(int(np.prod(s)) + 1)
                                .astype(np.float32) * (0.1 if i >= 3 else 1.0))
        args.append(flat.to(cuda, torch.bfloat16)[1:].view(s))
    assert all(a.data_ptr() % 4 == 2 and a.is_contiguous() for a in args)
    got = pallas_ops.lstm_cell(*args)
    want = pallas_ops.lstm_cell_reference(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)


def test_lstm_classifier_on_the_card_matches_the_cpu(cuda):
    model = harness.init_model(
        LSTMClassifier(300, hidden=1024, dtype=torch.float32), 0, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8, 300)).astype(np.float32))
    want = harness.make_infer_fn(model)(x)
    got = harness.make_infer_fn(model.to(cuda))(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _flash_args(batch, tq, tk, heads, dim, dtype, device, seed=0):
    """q, k, v in ``dtype`` and a carried state that is not the identity."""
    rng = np.random.default_rng(seed)

    def t(shape, lo=None):
        a = (rng.uniform(lo, 2.0, shape) if lo is not None
             else rng.standard_normal(shape))
        return torch.from_numpy(a.astype(np.float32)).to(device)
    q, k, v = (t((batch, n, heads, dim)).to(dtype) for n in (tq, tk, tk))
    return q, k, v, t((batch, heads, tq)), t((batch, heads, tq), lo=0.5), \
        t((batch, tq, heads, dim))


# tq, tk, heads, dim: the LM's head dim, an odd T (24, as
# tests/test_attention.py), ragged tiles with tq != tk, and D = 16
@pytest.mark.parametrize("tq,tk,heads,dim", [
    (128, 128, 2, 64), (24, 24, 2, 64), (100, 37, 3, 16), (37, 100, 1, 64)])
@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_absorb_kernel_matches_plain(cuda, dtype, tol, kind, tq, tk,
                                           heads, dim):
    q, k, v, m, l, o = _flash_args(2, tq, tk, heads, dim, dtype, cuda)
    before = flash.flash_absorb.launches
    got = flash.flash_absorb(q, k, v, kind, m, l, o)
    torch.cuda.synchronize()
    assert flash.flash_absorb.launches == before + 1
    if kind == 2:  # the state passes through bit for bit
        for g, w in zip(got, (m, l, o)):
            assert torch.equal(g, w)
        return
    want = flash.absorb_block_reference(
        q, k, v, _allowed(kind, tq, tk, cuda), m, l, o, dim ** -0.5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def _allowed(kind, tq, tk, device):
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    return (rows >= cols) if kind == 1 else torch.ones(
        tq, tk, dtype=torch.bool, device=device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("seq_block", [None, 32])
def test_flash_attention_kernel_matches_dense(cuda, dtype, tol, seq_block):
    from k8s_device_plugin_torch.workloads.attention import \
        reference_attention
    q, k, v, *_ = _flash_args(2, 96, 96, 4, 64, dtype, cuda, seed=3)
    for causal in (True, False):
        got = flash.flash_attention(q, k, v, causal=causal,
                                    seq_block=seq_block)
        want = reference_attention(q, k, v, causal=causal)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 1e-4)),
                                       (torch.bfloat16, (2e-2, 2e-2))])
@pytest.mark.parametrize("seq_block", [None, 32])
def test_flash_attention_gradients_on_the_card_match_dense(cuda, dtype, tol,
                                                           seq_block):
    """Grads of sum(sin(flash_attention)) through the Function (K3 forward,
    recompute backward) against dense attention's, causal and not; fp32 at
    tests/test_attention.py's 1e-5 / 1e-4. K3 runs once a chunk pair."""
    from k8s_device_plugin_torch.workloads.attention import \
        reference_attention
    q, k, v, *_ = _flash_args(2, 96, 96, 4, 64, dtype, cuda, seed=4)
    for causal in (True, False):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        before = flash.flash_absorb.launches
        out = flash.flash_attention(*qkv, causal=causal, seq_block=seq_block)
        pairs = 1 if seq_block is None else (6 if causal else 9)
        assert flash.flash_absorb.launches == before + pairs
        got = torch.autograd.grad(torch.sin(out.float()).sum(), qkv)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(torch.sin(reference_attention(
            *qkv, causal=causal).float()).sum(), qkv)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            torch.testing.assert_close(g.float(), w.float(), atol=tol[0],
                                       rtol=tol[1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_lstm_cell_weights_get_their_gradients_on_the_card(cuda, dtype, tol):
    """The cell's weights get the plain cell's gradients through the kernel
    (case 5.2: batch 10, 300 features, 1024 hidden, 4 steps). A kernel
    that wrote fresh tensors outside autograd left wx, wh and b with no
    gradient at all, and raised nothing."""
    model = harness.init_model(LSTMClassifier(300, dtype=dtype), 0, cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (10, 4, 300)).astype(np.float32)).to(cuda)
    labels = torch.zeros(10, dtype=torch.long, device=cuda)
    before = pallas_ops.lstm_cell.launches
    harness.cross_entropy(model(x), labels).backward()
    assert pallas_ops.lstm_cell.launches == before + 4
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    plain = LSTMClassifier(300, dtype=dtype).to(cuda)
    plain.load_state_dict(model.state_dict())
    plain.cell.forward = lambda h, c, x_t: pallas_ops.lstm_cell_reference(
        x_t, h, c, plain.cell.wx, plain.cell.wh, plain.cell.b)
    harness.cross_entropy(plain(x), labels).backward()
    for name, p in plain.named_parameters():
        assert got[name] is not None, name
        scale = p.grad.float().abs().max()
        assert scale > 0, name
        torch.testing.assert_close(got[name].float() / scale,
                                   p.grad.float() / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("route", ["mma_sync", "wgmma"])
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("tq,tk", [(1000, 1000), (300, 77), (64, 200)])
def test_flash_absorb_bf16_routes_match_plain(cuda, route, kind, tq, tk):
    """Both bf16 routes at the LM's head dim, forced: T = 1000 wraps the
    wgmma route's K/V ring many times; the others end mid-tile."""
    q, k, v, m, l, o = _flash_args(2, tq, tk, 3, 64, torch.bfloat16, cuda,
                                   seed=5)
    got = flash._absorb_kernel(route, q, k, v, kind, m, l, o)
    want = flash.absorb_block_reference(
        q, k, v, _allowed(kind, tq, tk, cuda), m, l, o, 64 ** -0.5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-2)


def test_flash_absorb_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, m, l, o = _flash_args(1, 8, 8, 1, 12, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash.flash_absorb(q, k, v, 0, m, l, o)
    for dtype, dim in ((torch.float32, 16), (torch.bfloat16, 64)):
        q, k, v, m, l, o = _flash_args(1, 8, 8, 2, dim, dtype, cuda)
        # a [B, H, T, D] buffer seen as [B, T, H, D]: read in place
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        assert not qt.is_contiguous()
        for g, w in zip(flash.flash_absorb(qt, k, v, 0, m, l, o),
                        flash.flash_absorb(q, k, v, 0, m, l, o)):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="last dim"):
            flash.flash_absorb(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, v, 0, m, l, o)
    # the measurement entry that forces a route has no backward; the
    # wrapper differentiates through the plain absorb
    with pytest.raises(RuntimeError, match="no backward"):
        flash._absorb_kernel("wgmma", q.requires_grad_(), k, v, 0, m, l, o)
    _, l1, o1 = flash.flash_absorb(q, k, v, 0, m, l, o)
    (got,) = torch.autograd.grad(o1.sum() + l1.sum(), q)
    _, l2, o2 = flash._absorb_reference(q, k, v, 0, m, l, o, dim ** -0.5)
    (want,) = torch.autograd.grad(o2.sum() + l2.sum(), q)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype,dim", [(torch.bfloat16, 64),
                                       (torch.bfloat16, 32),
                                       (torch.float32, 64)])
def test_flash_absorb_reads_fused_qkv_views_in_place(cuda, dtype, dim):
    """q, k, v as the views of one [B, T, 3, H, D] projection (what
    layer_qkv returns): bit-equal to the same absorb on contiguous
    copies, on every route."""
    qkv = torch.randn(2, 200, 3, 4, dim,
                      generator=torch.Generator().manual_seed(2)).to(cuda,
                                                                     dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    for kind in (0, 1):
        m, l, o = flash.flash_state(q)
        got = flash.flash_absorb(q, k, v, kind, m, l, o)
        want = flash.flash_absorb(q.contiguous(), k.contiguous(),
                                  v.contiguous(), kind, m, l, o)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_lm_with_the_kernel_matches_dense_attention(cuda, dtype, tol,
                                                    kv_heads):
    """The LM at LM_CONFIG's widths (8 heads of 64, vocab 8192), 2 layers,
    with K3 against the same LM with dense attention on the card; tol is
    relative to the largest logit."""
    from k8s_device_plugin_torch.workloads.attention import (init_lm_params,
                                                             lm_forward)
    model = init_lm_params(torch.Generator().manual_seed(0), 8192, 512, 8, 2,
                           dtype=dtype, kv_heads=kv_heads, device=cuda)
    tokens = torch.randint(0, 8192, (2, 200),
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    before = flash.flash_absorb.launches
    with torch.inference_mode():
        got = lm_forward(model, tokens, use_flash=True).float()
        want = lm_forward(model, tokens).float()
    assert flash.flash_absorb.launches == before + 2  # one per layer
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=tol)


def test_greedy_generate_on_the_card_is_token_exact(cuda):
    from k8s_device_plugin_torch.workloads import decode
    from k8s_device_plugin_torch.workloads.attention import (init_lm_params,
                                                             lm_forward)
    model = init_lm_params(torch.Generator().manual_seed(0), 8192, 512, 8, 2,
                           device=cuda)
    prompt = torch.randint(0, 8192, (2, 16),
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    got = decode.generate(model, prompt, steps=8)
    want = decode.reference_generate(
        model, prompt, steps=8,
        forward=lambda p, t: lm_forward(p, t, use_flash=True))
    assert torch.equal(got, want)


def test_whole_sequence_absorb_gradient_at_the_moe_lm_train_shape(cuda):
    """The MoE LM trains on one whole-sequence absorb a layer (its loss
    passes no chunking): q, k, v [4, 2048, 8, 64] bf16, causal, one K3
    launch, its backward rebuilding a [4, 8, 2048, 2048] fp32 score block;
    gradients of sum(sin(out)) within 2e-2 of the largest |grad| of dense
    attention's."""
    from k8s_device_plugin_torch.workloads.attention import \
        reference_attention
    rng = np.random.default_rng(22)
    inputs = [torch.from_numpy(rng.standard_normal((4, 2048, 8, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(3)]

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = torch.sin(fn(*leaves).float()).sum()
        return torch.autograd.grad(out, leaves)
    before = flash.flash_absorb.launches
    got = grads(lambda *a: flash.flash_attention(*a, seq_block=None))
    assert flash.flash_absorb.launches == before + 1
    want = grads(reference_attention)
    for g, w in zip(got, want):
        scale = w.float().abs().max()
        assert (g.float() - w.float()).abs().max() <= 2e-2 * scale


def _route_decisions(moe):
    """Patch moe._route to record each call's expert choices; returns the
    record and the original to restore."""
    decisions, route = [], moe._route

    def recording(x, gate_w, n_experts, capacity):
        decisions.append(torch.softmax((x @ gate_w).float(), -1).argmax(-1)
                         .cpu())
        return route(x, gate_w, n_experts, capacity)
    moe._route = recording
    return decisions, route


def test_moe_lm_on_the_card_matches_the_cpu(cuda):
    """The MoE LM (vocab 512, dim 128, 2 heads of 64, 2 layers, 8 experts)
    on 2 x 64 tokens in 2 x 2 routing blocks, fp32 with TF32 off: through
    K3 on the card against the plain absorb on the CPU, every routing
    decision the same (a flip moves a token's output by O(1)), the logits
    within 1e-4 of the largest and the aux loss at 1e-5."""
    import copy
    from k8s_device_plugin_torch.workloads import moe
    ref = moe.init_moe_lm_params(torch.Generator().manual_seed(0), 512, 128,
                                 2, 2, n_experts=8, device="cpu")
    model = copy.deepcopy(ref).to(cuda)
    tokens = torch.randint(0, 512, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    outs, choices = [], []
    for net, t in ((ref, tokens), (model, tokens.to(cuda))):
        decisions, route = _route_decisions(moe)
        try:
            with torch.inference_mode():
                outs.append(moe.moe_lm_forward(net, t, use_flash=True,
                                               shard_shape=(2, 2)))
        finally:
            moe._route = route
        choices.append(torch.stack(decisions))
    assert torch.equal(choices[0], choices[1])
    (want, aux_want), (got, aux_got) = outs
    scale = want.abs().max()
    torch.testing.assert_close(got.cpu() / scale, want / scale, rtol=0,
                               atol=1e-4)
    assert abs(aux_got.item() - aux_want.item()) <= 1e-5


def test_vgg16_dropout_step_on_the_card_matches_the_cpu(cuda):
    """VGG-16 at batch 2 @ 32, fp32, in training with dropout: the masks
    drawn on the CPU (the generator's device) and moved to the card, so
    both devices drop the same units; the gradients within 1e-4 of each
    parameter's largest."""
    import copy
    from k8s_device_plugin_torch.workloads.vgg import VGG16
    ref = harness.init_model(VGG16(num_classes=10, image_size=32,
                                   dtype=torch.float32), 0, "cpu").train()
    model = copy.deepcopy(ref).to(cuda)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (2,)))
    g = torch.Generator()
    for net, dev in ((ref, "cpu"), (model, cuda)):
        harness.cross_entropy(net(x.to(dev), dropout_generator=g.manual_seed(
            0)), labels.to(dev)).backward()
    for (name, w), p in zip(ref.named_parameters(), model.parameters()):
        scale = w.grad.abs().max()
        assert scale > 0, name
        assert (p.grad.cpu() - w.grad).abs().max() <= 1e-4 * scale, name
