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

from k8s_device_plugin_torch.workloads import convert, harness
from k8s_device_plugin_torch.workloads import lstm as tlstm
from k8s_device_plugin_torch.workloads.pallas_ops import (
    lstm_cell as t_lstm_cell, lstm_cell_reference as t_lstm_cell_reference)
from k8s_device_plugin_tpu.workloads.lstm import LSTMClassifier
from k8s_device_plugin_tpu.workloads.pallas_ops import (lstm_cell,
                                                        lstm_cell_reference)

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
    before = t_lstm_cell.launches
    got = t_lstm_cell(*targs)
    want = t_lstm_cell_reference(*targs)
    assert t_lstm_cell.launches == before
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
