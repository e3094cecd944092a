"""Fused LSTM cell and classifier: the PyTorch port against the JAX package.

On the CPU the port's ``lstm_cell`` runs its plain version (the CUDA
kernel is held against that plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Here the same seeded
numpy inputs go through the Pallas kernel in interpret mode, the JAX
reference, and the port, at the shapes and tolerances of
``tests/test_pallas_ops.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.workloads import convert, harness
from k8s_device_plugin_torch.workloads import lstm as tlstm
from k8s_device_plugin_torch.workloads.pallas_ops import (
    lstm_cell as t_lstm_cell, lstm_cell_reference as t_lstm_cell_reference)
from k8s_device_plugin_tpu.workloads.lstm import LSTMClassifier
from k8s_device_plugin_tpu.workloads.pallas_ops import (lstm_cell,
                                                        lstm_cell_reference)
from torch_support import one_torch_thread  # noqa: F401 (autouse)

# tolerances of tests/test_pallas_ops.py
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _inputs(batch, features, hidden, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    return [n((batch, features)), n((batch, hidden)), n((batch, hidden)),
            n((features, 4 * hidden)) * 0.1, n((hidden, 4 * hidden)) * 0.1,
            n((4 * hidden,)) * 0.1]


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,features,hidden", [
    (8, 128, 128),   # tests/test_pallas_ops.py's aligned shape
    (3, 30, 100),    # its unaligned shape (the compiled TPU path falls
                     # back there; interpret mode runs the kernel)
])
def test_lstm_cell_matches_pallas_and_reference(dtype, batch, features,
                                                hidden):
    args = [a.astype(np.float32) for a in _inputs(batch, features, hidden)]
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in args]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in args]
    h_t, c_t = t_lstm_cell(*targs)
    assert h_t.dtype == c_t.dtype == getattr(torch, dtype)
    tol = TOLERANCE[dtype]
    for h_j, c_j in (lstm_cell_reference(*jargs),
                     lstm_cell(*jargs, interpret=True)):
        np.testing.assert_allclose(_f32(h_t.float()), _f32(h_j),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(_f32(c_t.float()), _f32(c_j),
                                   atol=tol, rtol=tol)


def test_lstm_cell_on_cpu_is_the_plain_version_and_counts_nothing():
    targs = [torch.from_numpy(a.astype(np.float32))
             for a in _inputs(4, 16, 8)]
    before = _build.launches["lstm_cell"]
    got = t_lstm_cell(*targs)
    want = t_lstm_cell_reference(*targs)
    assert _build.launches["lstm_cell"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lstm_cell_rejects_a_device_without_a_kernel():
    targs = [torch.from_numpy(a.astype(np.float32)).to("meta")
             for a in _inputs(4, 16, 8)]
    with pytest.raises(ValueError, match="no kernel for device"):
        t_lstm_cell(*targs)


def test_lstm_classifier_matches_flax_with_transferred_weights():
    batch, steps, features, hidden = 4, 6, 128, 128
    x = np.random.default_rng(1).standard_normal(
        (batch, steps, features)).astype(np.float32)
    ref = LSTMClassifier(hidden=hidden, num_classes=2, dtype=jnp.float32,
                         use_pallas=True, pallas_interpret=True)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(_f32, variables)
    want = _f32(ref.apply(variables, jnp.asarray(x)))

    model = tlstm.LSTMClassifier(features, hidden=hidden, num_classes=2,
                                 dtype=torch.float32)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    got = harness.make_infer_fn(model.eval())(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_lstm_classifier_init_is_seeded_and_shaped():
    def build():
        return harness.init_model(
            tlstm.LSTMClassifier(12, hidden=8, dtype=torch.bfloat16), 3,
            "cpu")
    a, b = build(), build()
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    wh = a.cell.wh.detach().float()
    # orthogonal: the 4H columns' rows are orthonormal, as Flax's init
    np.testing.assert_allclose((wh @ wh.T).numpy(), np.eye(8), atol=2e-2)
    assert a.cell.wx.dtype == torch.bfloat16
    assert a.head.weight.dtype == torch.float32


def test_cell_route_follows_dtype_shape_and_alignment():
    from k8s_device_plugin_torch.workloads import pallas_ops as tops

    def args(batch, features, hidden, dtype, offset=0):
        def t(*shape):
            n = int(np.prod(shape))
            return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
        return (t(batch, features), t(batch, hidden),
                t(features, 4 * hidden), t(hidden, 4 * hidden))
    assert tops.cell_route(*args(100, 300, 1024, torch.float32)) == "fma"
    assert tops.cell_route(*args(100, 300, 1024, torch.bfloat16)) == "ring"
    assert tops.cell_route(*args(8, 128, 128, torch.bfloat16)) == "ring"
    for shape in ((3, 30, 100), (8, 128, 120)):  # F % 4, H % 16
        assert tops.cell_route(*args(*shape, torch.bfloat16)) == "elementwise"
    assert tops.cell_route(*args(100, 300, 1024, torch.bfloat16,
                                 offset=1)) == "elementwise"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("contiguous", [True, False])
def test_lstm_sequence_on_cpu_is_the_plain_loop_and_counts_nothing(
        dtype, contiguous):
    from k8s_device_plugin_torch.workloads import pallas_ops as tops
    steps, (x, h, c, wx, wh, b) = 5, _inputs(3, 12, 8, seed=4)
    xs = np.random.default_rng(5).standard_normal((3, steps, 12))
    t = getattr(torch, dtype)
    xs = torch.from_numpy(xs.astype(np.float32)).to(t).transpose(0, 1)
    if contiguous:
        xs = xs.contiguous()
    args = [torch.from_numpy(a.astype(np.float32)).to(t)
            for a in (h, c, wx, wh, b)]
    before = dict(_build.launches)
    got = tops.lstm_sequence(xs, *args)
    assert dict(_build.launches) == before
    want_h, want_c = args[0], args[1]
    for x_t in xs:
        want_h, want_c = t_lstm_cell_reference(x_t, want_h, want_c,
                                               *args[2:])
    assert torch.equal(got[0], want_h) and torch.equal(got[1], want_c)
    assert not tops.sequence_route(xs, *args)  # the CPU has no kernel


def test_sequence_route_follows_dtype_grad_shape_and_device(monkeypatch):
    from k8s_device_plugin_torch.workloads import pallas_ops as tops
    fits = tops.sequence_fits
    case = dict(device_type="cuda", dtype=torch.bfloat16, recording=False,
                batch=100, features=300, hidden=1024)
    assert fits(**case)
    for change in ({"device_type": "cpu"}, {"device_type": "meta"},
                   {"dtype": torch.float32}, {"dtype": torch.float16},
                   {"recording": True}, {"batch": 0}, {"batch": 129},
                   {"features": 302}, {"hidden": 1000}, {"hidden": 0}):
        assert not fits(**{**case, **change}), change
    for change in ({"batch": 1}, {"batch": 128}, {"features": 4},
                   {"hidden": 16}):
        assert fits(**{**case, **change}), change
    # tensors off the card never ask the card whether the grid fits
    monkeypatch.setattr(tops, "_resident", lambda *a: pytest.fail(str(a)))
    xs = torch.zeros(2, 4, 12, dtype=torch.bfloat16)
    h = torch.zeros(4, 16, dtype=torch.bfloat16)
    w = [torch.zeros(12, 64, dtype=torch.bfloat16),
         torch.zeros(16, 64, dtype=torch.bfloat16),
         torch.zeros(64, dtype=torch.bfloat16)]
    assert not tops.sequence_route(xs, h, h, *w)
    assert not tops.sequence_route(xs.to("meta"), h.to("meta"),
                                   h.to("meta"), *(t.to("meta") for t in w))
    with pytest.raises(ValueError, match="no sequence route"):
        tops.lstm_sequence(xs.to("meta"), h.to("meta"), h.to("meta"),
                           *(t.to("meta") for t in w))
