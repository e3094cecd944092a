"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build at
first use) and skips without one. Run them on the card with:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.monitor import dutyprobe
from k8s_device_plugin_torch.workloads import (afmoe, bn_relu, flash,
                                               harness, lfm2, moe, pallas_ops,
                                               resnet)
from k8s_device_plugin_torch.workloads.lstm import LSTMClassifier

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    before = _build.launches["probe_chain"]
    got = dutyprobe.probe_chain(x, w, 16)
    torch.cuda.synchronize()
    assert _build.launches["probe_chain"] == before + 1
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
    before = _build.launches["lstm_cell"]
    got = pallas_ops.lstm_cell(*args)
    torch.cuda.synchronize()
    assert _build.launches["lstm_cell"] == before + 1
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


def _of_largest(got, want) -> float:
    """max |got - want| over max |want|, after checking got's kind."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("steps", [1, 2, 64, 1024])
@pytest.mark.parametrize("batch", [100, 37, 10])
def test_lstm_sequence_matches_the_per_step_kernel(cuda, batch, steps):
    """K2's sequence route (one launch) against a loop of per-step K2
    launches on the same inputs and against a loop of the plain cell
    (``lstm_cell_reference``, fp32 products) on them: h_T and c_T within
    2e-2 of their largest magnitude, the bf16 cell tests' bound."""
    xs, h0, c0, wx, wh, b = chip_smoke.sequence_args(batch, steps, cuda,
                                                     seed=batch + steps)
    with torch.inference_mode():
        assert pallas_ops.sequence_route(xs, h0, c0, wx, wh, b)
        before = dict(_build.launches)
        got = pallas_ops.lstm_sequence(xs, h0, c0, wx, wh, b)
        torch.cuda.synchronize()
        assert _build.launches["lstm_sequence"] == \
            before.get("lstm_sequence", 0) + 1
        assert _build.launches["lstm_cell"] == before.get("lstm_cell", 0)
        h, c = h0, c0
        for x_t in xs:
            h, c = pallas_ops.lstm_cell(x_t, h, c, wx, wh, b)
        plain = chip_smoke._plain_sequence(xs, h0, c0, wx, wh, b)
    for g, k2, want in zip(got, (h, c), plain):
        assert _of_largest(g, k2) <= 2e-2
        assert _of_largest(g, want) <= 2e-2


def test_lstm_sequence_launches_wherever_its_grid_is_resident(cuda):
    """The residency answer, asked with the launch's own attributes, is
    a promise: every shape it says yes to launches (one step, no error),
    and a shape whose weights do not fit in shared memory is refused."""
    from k8s_device_plugin_torch.workloads.pallas_ops import _resident
    yes = []
    for batch, features, hidden in ((1, 4, 16), (100, 300, 1024),
                                    (128, 300, 1024), (128, 1024, 1024),
                                    (64, 300, 512), (128, 4, 2048)):
        if not _resident(cuda.index or 0, batch, features, hidden):
            continue
        yes.append(hidden)
        args = chip_smoke.sequence_args(batch, 1, cuda, seed=batch,
                                        features=features, hidden=hidden)
        with torch.inference_mode():
            h, c = pallas_ops.lstm_sequence(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(h.float()).all() and \
            torch.isfinite(c.float()).all()
    assert 1024 in yes and 2048 not in yes, yes


def test_lstm_classifier_bf16_inference_is_one_sequence_launch(cuda):
    """A bf16 forward of the classifier without autograd launches K2's
    sequence route once and no per-step K2; its logits agree with the
    per-step loop's (2e-2 of the largest)."""
    model = harness.init_model(LSTMClassifier(300, dtype=torch.bfloat16), 0,
                               cuda).eval()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (100, 64, 300)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = dict(_build.launches)
    got = harness.make_infer_fn(model)(x)
    torch.cuda.synchronize()
    assert _build.launches["lstm_sequence"] == \
        before.get("lstm_sequence", 0) + 1
    assert _build.launches["lstm_cell"] == before.get("lstm_cell", 0)
    with torch.inference_mode():
        h = c = torch.zeros(100, 1024, dtype=torch.bfloat16, device=cuda)
        for x_t in x.transpose(0, 1).contiguous():
            h, c = pallas_ops.lstm_cell(x_t, h, c, model.cell.wx,
                                        model.cell.wh, model.cell.b)
        want = model.head(h.float())
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 2e-2, err


def test_lstm_classifier_bf16_on_the_card_matches_the_cpu(cuda):
    """The runner's bf16 forward (B 100 x 64 steps) on the card, where it
    takes K2's sequence route, against the same model on the CPU (the
    plain cell): logits within 2e-2 of the largest."""
    model = harness.init_model(
        LSTMClassifier(300, hidden=1024, dtype=torch.bfloat16), 0, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (100, 64, 300)).astype(np.float32)).to(torch.bfloat16)
    want = harness.make_infer_fn(model)(x)
    before = _build.launches["lstm_sequence"]
    got = harness.make_infer_fn(model.to(cuda))(x.to(cuda)).cpu()
    assert _build.launches["lstm_sequence"] == before + 1
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 2e-2, err


@pytest.mark.parametrize("case", ["grad", "fp32", "batch129"])
def test_lstm_classifier_takes_the_per_step_route_elsewhere(cuda, case):
    """Under autograd, in fp32 and at B 129 the classifier loops the
    per-step K2: T launches, none of the sequence route."""
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    batch = 129 if case == "batch129" else 10
    model = harness.init_model(LSTMClassifier(300, dtype=dtype), 0, cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (batch, 4, 300)).astype(np.float32)).to(cuda)
    before = dict(_build.launches)
    if case == "grad":
        model(x).sum().backward()
    else:
        harness.make_infer_fn(model)(x)
    torch.cuda.synchronize()
    assert _build.launches["lstm_cell"] == before.get("lstm_cell", 0) + 4
    assert _build.launches["lstm_sequence"] == \
        before.get("lstm_sequence", 0)


# The gate math alone: one step with x one-hot (row m at feature m) and
# h = 0, so each (row, j)'s preactivations are wx's row m plus b, set
# directly. Columns below _BIAS_COLS carry theirs in b alone (wx 0 there),
# so that subnormal and extreme values reach the gate math without a
# tensor-core product.
_GATE_ROWS, _GATE_HIDDEN, _BIAS_COLS = 128, 1024, 64


def _gate_pool(subnormal: bool):
    """Preactivations over [-100, 100]: 0, +-88, the branch points of
    tanhf and of the kernel (|x| 0.55-0.6), a dense line, magnitudes from
    the smallest up, fp32's extremes; rounded to bf16 where the kernels
    read bf16."""
    tiny = 1e-39 if subnormal else 1e-37
    geo = np.geomspace(tiny, 100.0, 600)
    special = [0.0, 88.0, -88.0, 0.55, -0.55, 0.5999, 0.6, -0.6, 0.6001,
               100.0, -100.0, 1e30, -1e30, 3e38, -3e38]
    if subnormal:
        special += [1e-39, -1e-39, 5e-41, 1.17e-38, -1e-38]
    pool = np.concatenate([special, np.linspace(-100.0, 100.0, 4001),
                           geo, -geo])
    return torch.from_numpy(pool.astype(np.float32)).to(torch.bfloat16)


def _gate_args(seed=0):
    """x [B, B] one-hot, h0 = 0, c0 over magnitudes, wx [B, 4H], wh, b
    (bf16, on the CPU); the first 64 rows sweep each gate's pool column by
    column, the rest draw the four gates at random."""
    rng = np.random.default_rng(seed)
    rows, hidden = _GATE_ROWS, _GATE_HIDDEN
    pool = _gate_pool(subnormal=False)
    wx = pool[torch.from_numpy(rng.integers(0, len(pool),
                                            (rows, 4 * hidden)))]
    walk = pool[torch.arange(16 * hidden) % len(pool)].view(16, hidden)
    for q in range(4):  # rows 16q .. 16q+15: gate q walks the pool
        wx[16 * q:16 * q + 16, q * hidden:(q + 1) * hidden] = walk
    b = torch.zeros(4 * hidden, dtype=torch.bfloat16)
    full = _gate_pool(subnormal=True)
    for q in range(4):
        cols = slice(q * hidden, q * hidden + _BIAS_COLS)
        wx[:, cols] = 0
        b[cols] = full[torch.from_numpy(rng.integers(0, len(full),
                                                     _BIAS_COLS))]
        b[q * hidden + _BIAS_COLS:(q + 1) * hidden] = torch.from_numpy(
            rng.choice([0.0, 0.25, -0.5], hidden - _BIAS_COLS)
            .astype(np.float32)).to(torch.bfloat16)
    cs = torch.tensor([0.0, 1e-3, -1e-3, 0.5, -0.5, 1.0, -1.0, 3.0, -3.0,
                       7.0, -7.0, 100.0, -100.0, 1e-38, -1e-39])
    c0 = cs[torch.from_numpy(rng.integers(0, len(cs), (rows, hidden)))] \
        .to(torch.bfloat16)
    x = torch.eye(rows, dtype=torch.bfloat16)
    h0 = torch.zeros(rows, hidden, dtype=torch.bfloat16)
    wh = (torch.randn(hidden, 4 * hidden, generator=torch.Generator()
                      .manual_seed(seed)) * 0.03).to(torch.bfloat16)
    return x, h0, c0, wx, wh, b


def _gate_reference(wx, b, c0):
    """h', c' in float64 from the fp32 preactivations (wx + b, as the
    kernels add them), and each's allowance where fp32 cannot be nearer:
    16 fp32 ulps of |sigmoid(f) c| + |sigmoid(i) tanh(g)|, the two terms
    whose fp32 sum c' is (times sigmoid(o) for h')."""
    pre = (wx.float() + b.float()).double()
    i, f, g, o = pre.split(_GATE_HIDDEN, dim=1)
    c = c0.double()
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    terms = (torch.sigmoid(f) * c).abs() + (torch.sigmoid(i)
                                            * torch.tanh(g)).abs()
    return ((h_new, 2.0 ** -20 * terms * torch.sigmoid(o)),
            (c_new, 2.0 ** -20 * terms))


def _bf16_steps(got, want):
    """|got - want| in bf16 steps, element by element (-0 and +0 are one
    value)."""
    def ordered(t):
        bits = t.view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (ordered(got) - ordered(want)).abs()


@pytest.mark.parametrize("route", ["sequence", "ring", "elementwise", "fma"])
def test_lstm_gate_math_holds_h_and_c_to_float64(cuda, route):
    """One step of each K2 entry on preactivations set directly (0, +-88,
    |x| 0.55-0.6, subnormal and extreme magnitudes, a dense line over
    [-100, 100]) and c over magnitudes: h' and c' finite and within 1
    bf16 step of the float64 math rounded to bf16, or, where c's two
    terms cancel, within fp32's own rounding of them (``_gate_reference``).
    The fp32 route's outputs are rounded to bf16 for the comparison."""
    x, h0, c0, wx, wh, b = _gate_args(seed=11)
    args = [t.to(cuda) for t in (x, h0, c0, wx, wh, b)]
    with torch.inference_mode():
        if route == "sequence":
            assert pallas_ops.sequence_route(args[0][None], *args[1:])
            got = pallas_ops.lstm_sequence(args[0][None], *args[1:])
        elif route == "fma":
            got = pallas_ops.lstm_cell(*(t.float() for t in args))
        elif route == "ring":
            assert pallas_ops.cell_route(*(args[i] for i in (0, 1, 3, 4))) \
                == "ring"
            got = pallas_ops.lstm_cell(*args)
        else:
            got = (torch.empty_like(h0, device=cuda),
                   torch.empty_like(c0, device=cuda))
            pallas_ops.LSTM_CELL(
                args[0], pallas_ops.ROUTES[route],
                *(t.data_ptr() for t in (*args, *got)), *x.shape,
                _GATE_HIDDEN)
        torch.cuda.synchronize()
    for name, out, (want, slack) in zip("hc", got, _gate_reference(wx, b, c0)):
        out = out.cpu()
        assert torch.isfinite(out.float()).all(), name
        out = out.to(torch.bfloat16)
        steps = _bf16_steps(out, want.float().to(torch.bfloat16))
        err = (out.double() - want).abs()
        bad = (steps > 1) & (err > slack)
        assert not bad.any(), (
            f"{route} {name}': {int(bad.sum())} elements off, e.g. "
            f"{out[bad][:4].tolist()} against {want[bad][:4].tolist()}")


def test_lstm_gate_functions_hold_fp32_accuracy(cuda):
    """sigmoid and tanh as the kernels compute them, read through the fp32
    route's c' = sigmoid(f) c + sigmoid(i) tanh(g): with i = 100, f = -100
    and c = 0 it is tanh(g); with i = -100, g = 1 and c = 1 it is
    sigmoid(f) (plus sigmoid(-100) tanh(1), kept in the reference). Each
    within 4 fp32 ulp or 2^-22 absolute of float64, over a sweep of all
    of fp32's range: 0, subnormals, |x| 0.55-0.6, +-88, +-100, 1e30,
    3e38."""
    rows, hidden = _GATE_ROWS, _GATE_HIDDEN
    n = rows // 2 * hidden
    mag = np.geomspace(1e-45, 3e38, n // 4)
    sweep = np.concatenate([mag, -mag, np.linspace(-100.0, 100.0, n // 2)])
    sweep[:8] = [0.0, 88.0, -88.0, 0.55, -0.55, 0.6, -0.6, -100.0]
    v = torch.from_numpy(sweep.astype(np.float32)).view(rows // 2, hidden)
    wx = torch.zeros(rows, 4 * hidden)
    c0 = torch.zeros(rows, hidden)
    tanh_rows, sig_rows = slice(0, rows // 2), slice(rows // 2, rows)
    wx[tanh_rows, :hidden] = 100.0
    wx[tanh_rows, hidden:2 * hidden] = -100.0
    wx[tanh_rows, 2 * hidden:3 * hidden] = v
    wx[sig_rows, :hidden] = -100.0
    wx[sig_rows, hidden:2 * hidden] = v
    wx[sig_rows, 2 * hidden:3 * hidden] = 1.0
    c0[sig_rows] = 1.0
    x = torch.eye(rows)
    h0 = torch.zeros(rows, hidden)
    wh = torch.zeros(hidden, 4 * hidden)
    b = torch.zeros(4 * hidden)
    with torch.inference_mode():
        _, c_new = pallas_ops.lstm_cell(*(t.to(cuda) for t in
                                          (x, h0, c0, wx, wh, b)))
    got = c_new.cpu().double()
    vd = v.double()
    want = torch.cat([torch.tanh(vd), torch.sigmoid(vd) + torch.sigmoid(
        torch.tensor(-100.0, dtype=torch.float64)) * np.tanh(1.0)])
    ulp = torch.from_numpy(np.spacing(want.abs().float().numpy())).double()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    bad = (err > 4 * ulp) & (err > 2.0 ** -22)
    assert not bad.any(), (
        f"{int(bad.sum())} off, e.g. at {torch.cat([v, v])[bad][:4].tolist()}"
        f": {(err / ulp)[bad][:4].tolist()} ulp")


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
    before = _build.launches["flash_absorb"]
    got = flash.flash_absorb(q, k, v, kind, m, l, o)
    torch.cuda.synchronize()
    assert _build.launches["flash_absorb"] == before + 1
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
        before = _build.launches["flash_absorb"]
        out = flash.flash_attention(*qkv, causal=causal, seq_block=seq_block)
        pairs = 1 if seq_block is None else (6 if causal else 9)
        assert _build.launches["flash_absorb"] == before + pairs
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
    before = _build.launches["lstm_cell"]
    harness.cross_entropy(model(x), labels).backward()
    assert _build.launches["lstm_cell"] == before + 4
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
                                       (torch.float32, 64),
                                       (torch.bfloat16, 128)])
def test_flash_absorb_reads_fused_qkv_views_in_place(cuda, dtype, dim):
    """q, k, v as the views of one [B, T, 3, H, D] projection (what
    layer_qkv returns): bit-equal to the same absorb on contiguous
    copies, on every route, with and without a window."""
    qkv = torch.randn(2, 200, 3, 4, dim,
                      generator=torch.Generator().manual_seed(2)).to(cuda,
                                                                     dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    for kind, window in ((0, 0), (1, 0), (1, 77)):
        m, l, o = flash.flash_state(q)
        got = flash.flash_absorb(q, k, v, kind, m, l, o, window)
        want = flash.flash_absorb(q.contiguous(), k.contiguous(),
                                  v.contiguous(), kind, m, l, o, window)
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
    before = _build.launches["flash_absorb"]
    with torch.inference_mode():
        got = lm_forward(model, tokens, use_flash=True).float()
        want = lm_forward(model, tokens).float()
    assert _build.launches["flash_absorb"] == before + 2  # one per layer
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
    before = _build.launches["flash_absorb"]
    got = grads(lambda *a: flash.flash_attention(*a, seq_block=None))
    assert _build.launches["flash_absorb"] == before + 1
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


#: ResNet-V2-50's activations at ai-benchmark case 1.1 (batch 50 @ 346),
#: a stage's (width, side): bn1 and bn2 normalize the width, the adds and
#: the next preact BatchNorm four times it
RESNET_STAGES = [(64, 87), (128, 44), (256, 22), (512, 11)]


def _card_bn(channels, device, seed):
    """An eval BatchNorm on ``device`` with drawn statistics and affine."""
    g = torch.Generator().manual_seed(seed)
    bn = resnet.BatchNorm(channels)
    with torch.no_grad():
        bn.running_mean.uniform_(-0.3, 0.3, generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
        bn.weight.uniform_(0.8, 1.2, generator=g)
        bn.bias.uniform_(-0.3, 0.3, generator=g)
    return bn.to(device).eval()


def _card_activation(shape, device, seed):
    """A channels-last bf16 activation [N, C, H, W] on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _bf16_ulps(got, want) -> int:
    """The largest distance in bf16 steps between two bf16 tensors."""
    assert got.dtype == want.dtype == torch.bfloat16
    return int(_bf16_steps(got, want).max())


@pytest.mark.parametrize("width,side", RESNET_STAGES)
def test_bn_relu_kernel_matches_plain_at_the_stage_shapes(cuda, width, side):
    x = _card_activation((50, width, side, side), cuda, seed=width)
    bn = _card_bn(width, cuda, seed=width)
    before = _build.launches["bn_relu"]
    got = bn_relu.bn_relu(x, bn)
    torch.cuda.synchronize()
    assert _build.launches["bn_relu"] == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _bf16_ulps(got, bn_relu.bn_relu_reference(x, bn)) <= 1


@pytest.mark.parametrize("keep_sum", [True, False])
@pytest.mark.parametrize("width,side", RESNET_STAGES)
def test_add_bn_relu_kernel_matches_plain_at_the_stage_shapes(
        cuda, width, side, keep_sum):
    shape = (50, 4 * width, side, side)
    a = _card_activation(shape, cuda, seed=1)
    b = _card_activation(shape, cuda, seed=2)
    bn = _card_bn(4 * width, cuda, seed=width)
    before = _build.launches["add_bn_relu"]
    s, y = bn_relu.add_bn_relu(a, b, bn, keep_sum=keep_sum)
    torch.cuda.synchronize()
    assert _build.launches["add_bn_relu"] == before + 1
    want_s, want_y = bn_relu.add_bn_relu_reference(a, b, bn)
    if keep_sum:
        assert s.is_contiguous(memory_format=torch.channels_last)
        assert _bf16_ulps(s, want_s) <= 1
    else:
        assert s is None
    assert _bf16_ulps(y, want_y) <= 1


def test_bn_relu_kernels_refuse_what_they_do_not_take(cuda):
    bn = _card_bn(16, cuda, seed=0)
    x = _card_activation((2, 16, 5, 3), cuda, seed=0)
    odd = _card_activation((2, 12, 5, 3), cuda, seed=0)
    cases = [(x.contiguous(), bn, "channels-last"),
             (odd, _card_bn(12, cuda, seed=0), "12 channels")]
    for t, norm, match in cases:
        with pytest.raises(ValueError, match=match):
            bn_relu.bn_relu(t, norm)
        with pytest.raises(ValueError, match=match):
            bn_relu.add_bn_relu(t, t, norm)
    # fp32 and fp16 are the plain versions': equal to them, no launch
    before = (_build.launches["bn_relu"], _build.launches["add_bn_relu"])
    for t in (x.float(), x.half()):
        assert torch.equal(bn_relu.bn_relu(t, bn),
                           bn_relu.bn_relu_reference(t, bn))
        for got, want in zip(bn_relu.add_bn_relu(t, t, bn),
                             bn_relu.add_bn_relu_reference(t, t, bn)):
            assert got.dtype == t.dtype and torch.equal(got, want)
    assert (_build.launches["bn_relu"],
            _build.launches["add_bn_relu"]) == before


def _resnet_by_modules(model, x):
    """ResNetV2's eval logits with each block's own ``forward``: BatchNorm,
    ReLU and the add as ATen's separate passes."""
    import torch.nn.functional as F
    x = x.to(model.dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    x = model.conv_root(x)
    x, pad = resnet._pad_same(x, 3, 2, value=float("-inf"))
    x = F.max_pool2d(x, 3, stride=2, padding=pad)
    for name in model.block_names:
        x = getattr(model, name)(x)
    x = F.relu(model.final_bn(x)).mean(dim=(2, 3))
    return model.head(x.float())


# per forward: 33 BatchNorm + ReLU passes (the stem's preact, bn1 and bn2
# of 16 blocks) and 16 add passes (15 into the next preact, one into
# final_bn); fp32 takes the plain versions. The logits' bound is
# tests/test_torch_resnet.py's TOLERANCE (that file imports JAX).
@pytest.mark.parametrize("dtype,launches,tol", [
    (torch.bfloat16, (33, 16), 5e-2), (torch.float32, (0, 0), 1e-4)])
def test_resnet50_eval_fused_matches_the_modules(cuda, dtype, launches, tol):
    model = harness.init_model(resnet.resnet50(dtype=dtype), 0, "cpu")
    for k, m in enumerate(model.modules()):
        if isinstance(m, resnet.BatchNorm):
            m.load_state_dict(_card_bn(m.num_features, "cpu", k).state_dict())
    model = model.to(cuda)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (50, 346, 346, 3)).astype(np.float32)).to(cuda)
    before = (_build.launches["bn_relu"], _build.launches["add_bn_relu"])
    got = harness.make_infer_fn(model)(x)
    torch.cuda.synchronize()
    assert (_build.launches["bn_relu"] - before[0],
            _build.launches["add_bn_relu"] - before[1]) == launches
    with torch.inference_mode():
        want = _resnet_by_modules(model, x)
    scale = want.abs().max().item()
    assert scale > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


def test_lfm2_forward_counts_its_kernels(cuda):
    """A bf16 forward of LFM2-8B-A1B at its published widths, built by the
    benchmark's tenant (``tenant.build``: the configuration's seeded
    weights, nonzero expert bias included), on one prompt of 512
    embeddings: 18 short convs, 22 grouped expert applies, 6 K3 absorbs
    and 24 K6 passes (one a layer), and finite logits over the whole
    vocabulary."""
    from vgpu_bench import tenant
    with open(os.path.join(REPO, "vgpu_bench", "configs",
                           "lfm2-8b-a1b.prefill4k.json")) as f:
        model = tenant.build(json.load(f), 0, cuda)
    x = torch.randn(1, 512, model.cfg.dim, device=cuda).to(torch.bfloat16)
    counters = ("short_conv", "expert_apply", "flash_absorb", "swiglu_gate")
    before = [_build.launches[c] for c in counters]
    logits = harness.make_infer_fn(model)(x)
    torch.cuda.synchronize()
    assert [_build.launches[c] - b for c, b in zip(counters, before)] == [
        18, 22, 6, 24]
    assert logits.shape == (1, 65536) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    del model
    torch.cuda.empty_cache()


def test_lfm2_grouped_apply_matches_the_cpu_loop(cuda):
    """One expert layer at published widths (32 experts of 1792, top 4)
    on 4096 tokens: the two grouped products on the card against the loop
    of plain fp32 products on the CPU, on the same routed tokens. bf16
    rounds the first product, the gated SwiGLU and each expert's output
    once (0.0057 of the largest output on the H100); a pair sent to the
    wrong expert would read near 1."""
    g = torch.Generator(cuda).manual_seed(0)
    layer = moe.SigmoidMoE(2048, 1792, 32, 4, dtype=torch.bfloat16).to(cuda)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            fan_in = 1.0 if name == "expert_bias" else p.shape[-2]
            p.normal_(0.0, fan_in ** -0.5, generator=g)
    h = torch.randn(4096, 2048, device=cuda, generator=g).to(torch.bfloat16)
    sel, gates = moe.route_sigmoid_topk(h, layer.router, layer.expert_bias, 4)
    before = _build.launches["expert_apply"]
    with torch.inference_mode():
        got = moe.expert_apply(h, sel, gates, layer.w13, layer.w2)
    assert _build.launches["expert_apply"] == before + 1
    assert int(moe.expert_apply.last_counts.sum()) == 4096 * 4
    want = moe.expert_apply(h.cpu().float(), sel.cpu(), gates.cpu(),
                            layer.w13.cpu().float(), layer.w2.cpu().float())
    err = (got.cpu().float() - want).abs().max() / want.abs().max()
    assert err < 2e-2, err


def test_lfm2_attention_takes_k3_wgmma(cuda):
    """LFM2's attention (32 query heads over 8 KV heads of 64) runs K3 on
    its ``wgmma`` route: one ``wg::flash_kernel`` launch, and nothing of
    the other routes."""
    from torch.profiler import ProfilerActivity, profile
    assert flash.absorb_route(torch.bfloat16, 64, 1024) == "wgmma"
    attn = lfm2.Attention(lfm2.LFM2_8B_A1B, torch.bfloat16).to(cuda)
    with torch.no_grad():
        for p in (attn.wqkv, attn.wo):
            p.normal_(0.0, 0.02)
        attn.q_norm.fill_(1.0)
        attn.k_norm.fill_(1.0)
    u = torch.randn(2, 1024, 2048, device=cuda).to(torch.bfloat16)
    cos, sin = lfm2.rope_tables(torch.arange(1024, device=cuda), 64, 1e6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            torch.inference_mode():
        out = lfm2.attention(u, attn, cos, sin, 1e-5)
        torch.cuda.synchronize()
    absorbs = [(e.key, e.count) for e in prof.key_averages()
               if "flash_kernel" in e.key]
    assert len(absorbs) == 1 and "wg::" in absorbs[0][0], absorbs
    assert absorbs[0][1] == 1 and out.shape == u.shape


def _banded(kind, tq, tk, window, device):
    """K3's mask under a window: kind's, and row - col < window."""
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    return _allowed(kind, tq, tk, device) & (rows - cols < window)


# windows inside a 64-key tile, on its edge, straddling two or more tiles,
# and wider than the sequence; T ends mid-tile (300) or wraps many tiles
@pytest.mark.parametrize("window", [1, 50, 64, 100, 257, 2048])
@pytest.mark.parametrize("tq", [300, 1000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_window_matches_plain_at_head_dim_128(cuda, dtype, tol, tq,
                                                    window):
    """K3's window on its FMA (fp32) and wgmma (bf16) routes at head dim
    128, against the plain absorb under the band's mask, on a carried state
    that is not the identity: one launch, counted under ``flash_window``.
    fp32 at the LM tests' 1e-4: over up to 1000 keys the kernel's rescaled
    running sums round otherwise than one product does."""
    assert flash.absorb_route(dtype, 128, tq, window) == (
        "fma" if dtype == torch.float32 else "wgmma")
    q, k, v, m, l, o = _flash_args(1, tq, tq, 2, 128, dtype, cuda, seed=6)
    before = dict(_build.launches)
    got = flash.flash_absorb(q, k, v, 1, m, l, o, window)
    torch.cuda.synchronize()
    assert _build.launches["flash_window"] == before.get("flash_window",
                                                         0) + 1
    assert _build.launches["flash_absorb"] == before.get("flash_absorb", 0)
    want = flash.absorb_block_reference(
        q, k, v, _banded(1, tq, tq, window, cuda), m, l, o, 128 ** -0.5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,dim", [(torch.bfloat16, 128),
                                       (torch.bfloat16, 64),
                                       (torch.float32, 128)])
def test_flash_window_past_the_sequence_is_the_causal_absorb(cuda, dtype,
                                                             dim):
    """A window as wide as the sequence masks nothing more: the windowed
    kernel gives the causal kernel's bits (the same body, the band's test
    always true), on each route that takes the dtype."""
    q, k, v, m, l, o = _flash_args(2, 333, 333, 3, dim, dtype, cuda, seed=7)
    routes = (("fma",) if dtype == torch.float32
              else ("mma_sync", "wgmma"))
    for route in routes:
        got = flash._absorb_kernel(route, q, k, v, 1, m, l, o, 333)
        want = flash._absorb_kernel(route, q, k, v, 1, m, l, o)
        for g, w in zip(got, want):
            assert torch.equal(g, w), route


def test_flash_window_is_refused_by_the_wgmma_route(cuda):
    """Of the wgmma routes only the measurement variant that rounds P
    (head dim 64, no window) refuses a window: forced with one, it raises;
    by default a windowed call at head dim 64 takes wgmma, as the causal
    call at LFM2's head dim does, and matches the plain absorb."""
    q, k, v, m, l, o = _flash_args(1, 100, 100, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="no window"):
        flash._absorb_kernel("wgmma_round_p", q, k, v, 1, m, l, o, 16)
    assert flash.absorb_route(torch.bfloat16, 64, 100, 16) == "wgmma"
    assert flash.absorb_route(torch.bfloat16, 64, 100) == "wgmma"
    got = flash.flash_absorb(q, k, v, 1, m, l, o, 16)
    want = flash.absorb_block_reference(
        q, k, v, _banded(1, 100, 100, 16, cuda), m, l, o, 64 ** -0.5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-2)


# T ends mid-tile (3000) with tq == tk, or tq != tk; windows none, not a
# multiple of 64 (100), and longer than T (5000)
@pytest.mark.parametrize("tq,tk", [(3000, 3000), (200, 1000)])
@pytest.mark.parametrize("window", [0, 100, 5000])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_wgmma_at_head_dim_128_matches_plain(cuda, kind, window, tq, tk):
    """K3's ``wgmma`` route at head dim 128 (two 64-column panels a row, two
    consumer warpgroups) against the plain absorb under kind's mask and the
    window, on a carried state that is not the identity; kind 2 passes the
    state through bit for bit. One launch, under ``flash_window`` when
    there is a window."""
    assert flash.absorb_route(torch.bfloat16, 128, tk, window) == "wgmma"
    q, k, v, m, l, o = _flash_args(1, tq, tk, 2, 128, torch.bfloat16, cuda,
                                   seed=8)
    counter = "flash_window" if window else "flash_absorb"
    before = _build.launches[counter]
    got = flash._absorb_kernel("wgmma", q, k, v, kind, m, l, o, window)
    torch.cuda.synchronize()
    assert _build.launches[counter] == before + 1
    if kind == 2:
        for g, w in zip(got, (m, l, o)):
            assert torch.equal(g, w)
        return
    allowed = (_banded(kind, tq, tk, window, cuda) if window
               else _allowed(kind, tq, tk, cuda))
    want = flash.absorb_block_reference(q, k, v, allowed, m, l, o,
                                        128 ** -0.5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-2)


def test_flash_window_routes_agree_at_head_dim_128(cuda):
    """At head dim 128 under a window, K3 forced onto ``mma_sync`` and onto
    ``wgmma`` give the same state within bf16's 2e-2 (the same split P,
    summed in another order), and the same finalized output."""
    q, k, v, m, l, o = _flash_args(1, 2000, 2000, 4, 128, torch.bfloat16,
                                   cuda, seed=9)
    sync = flash._absorb_kernel("mma_sync", q, k, v, 1, m, l, o, 300)
    wg = flash._absorb_kernel("wgmma", q, k, v, 1, m, l, o, 300)
    for g, w in zip(wg, sync):
        torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(
        flash.flash_finalize(*wg, torch.bfloat16).float(),
        flash.flash_finalize(*sync, torch.bfloat16).float(), rtol=2e-2,
        atol=2e-2)


def _trinity_config():
    with open(os.path.join(REPO, "vgpu_bench", "configs",
                           "trinity-mini.ep4-prefill16k.json")) as f:
        return json.load(f)


def test_trinity_forward_counts_its_kernels(cuda):
    """A bf16 forward of Trinity-Mini at its published widths as rank 0 of
    4-way expert parallelism, built by the benchmark's tenant, on one
    prompt of 4096 embeddings (two windows): 24 windowed and 8 causal K3
    launches, 30 grouped expert applies and 62 K6 passes (2 dense, 30
    shared, 30 routed), and finite logits over the whole vocabulary."""
    from vgpu_bench import tenant
    model = tenant.build(_trinity_config(), 0, cuda)
    x = torch.randn(1, 4096, 2048, device=cuda).to(torch.bfloat16)
    counters = ("flash_window", "flash_absorb", "expert_apply",
                "swiglu_gate")
    before = [_build.launches[c] for c in counters]
    logits = harness.make_infer_fn(model)(x)
    torch.cuda.synchronize()
    assert [_build.launches[c] - b for c, b in zip(counters, before)] == [
        24, 8, 30, 62]
    assert logits.shape == (1, 200192) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    del model
    torch.cuda.empty_cache()


def test_trinity_attention_takes_k3_wgmma(cuda):
    """Trinity's attention (32 query heads over 4 KV heads of 128) runs K3
    on its ``wgmma`` route: a sliding layer launches one
    ``wg::flash_window_kernel``, a full layer one ``wg::flash_kernel``."""
    from torch.profiler import ProfilerActivity, profile
    attn = afmoe.Attention(afmoe.TRINITY_MINI, torch.bfloat16).to(cuda)
    with torch.no_grad():
        for p in (attn.wqkvg, attn.wo):
            p.normal_(0.0, 0.02)
        attn.q_norm.fill_(1.0)
        attn.k_norm.fill_(1.0)
    u = torch.randn(1, 3000, 2048, device=cuda).to(torch.bfloat16)
    cos, sin = afmoe.rope_tables(torch.arange(3000, device=cuda), 128, 1e4)
    names = {}
    for window in (2048, 0):
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                torch.inference_mode():
            out = afmoe.attention(u, attn, cos, sin, 1e-5, window)
            torch.cuda.synchronize()
        names[window] = [(e.key, e.count) for e in prof.key_averages()
                         if "flash_" in e.key and "_kernel" in e.key]
        assert out.shape == u.shape
    assert len(names[2048]) == 1 and "wg::flash_window_kernel" in \
        names[2048][0][0] and names[2048][0][1] == 1, names
    assert len(names[0]) == 1 and "wg::flash_kernel" in names[0][0][0] \
        and names[0][0][1] == 1, names


def test_held_expert_share_matches_the_cpu_loop(cuda):
    """One expert layer of Trinity-Mini's rank 0 (32 of 128 experts of
    1024 held, top 8) on 4096 tokens: the grouped products on the card
    over the held pairs only against the loop of plain fp32 products on the
    CPU, on the same routed tokens; about a quarter of the pairs held."""
    g = torch.Generator(cuda).manual_seed(0)
    layer = moe.SigmoidMoE(2048, 1024, 128, 8, dtype=torch.bfloat16,
                           held=(0, 32)).to(cuda)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            # the expert bias as the configuration draws it, std 0.05
            std = 0.05 if name == "expert_bias" else p.shape[-2] ** -0.5
            p.normal_(0.0, std, generator=g)
    h = torch.randn(4096, 2048, device=cuda, generator=g).to(torch.bfloat16)
    sel, gates = moe.route_sigmoid_topk(h, layer.router, layer.expert_bias,
                                        8, 2.826, 1e-20)
    before = _build.launches["expert_apply"]
    with torch.inference_mode():
        got = moe.expert_apply(h, sel, gates, layer.w13, layer.w2, 0)
    assert _build.launches["expert_apply"] == before + 1
    held = int(moe.expert_apply.last_counts.sum())
    assert held == int((sel < 32).sum()) and 0.15 < held / (4096 * 8) < 0.35
    want = moe.expert_apply(h.cpu().float(), sel.cpu(), gates.cpu(),
                            layer.w13.cpu().float(), layer.w2.cpu().float(),
                            0)
    err = (got.cpu().float() - want).abs().max() / want.abs().max()
    assert err < 2e-2, err
