"""The LSTM classifier's stock layout (Flax's ``nn.OptimizedLSTMCell`` under
``nn.RNN``, the JAX runner's cell off the TPU) against the JAX package's
``LSTMClassifier(use_pallas=False)``, on the CPU in fp32: the same Flax
variables, carried across by ``convert.flax_to_state_dict``, and the same
seeded numpy inputs. And the runner: the stock layout on the CPU, the
fused cell's on the card, as the JAX runner's ``use_pallas=on_tpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import harness as th
from k8s_device_plugin_torch.workloads import lstm as tlstm
from k8s_device_plugin_torch.workloads import run as trun
from k8s_device_plugin_tpu.workloads import harness as jh
from k8s_device_plugin_tpu.workloads.lstm import LSTMClassifier
from torch_support import one_torch_thread  # noqa: F401 (autouse)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("batch,steps,features,hidden", [(3, 6, 12, 16),
                                                         (2, 9, 5, 8)])
def test_stock_layout_matches_flax(batch, steps, features, hidden):
    """Logits within 1e-5 and the cross entropy's gradient in every
    parameter within 1e-4 of that gradient's norm, from the Flax init."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((batch, steps, features)).astype(np.float32)
    labels = rng.integers(0, 2, (batch,))
    ref = LSTMClassifier(hidden=hidden, dtype=jnp.float32)
    variables = jax.jit(lambda b: jh.init_model(ref, b))(jnp.asarray(x))

    def loss_of(params):
        logits = ref.apply({"params": params}, jnp.asarray(x))
        return jh.cross_entropy(logits, jnp.asarray(labels)), logits
    (_, want), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"])

    model = tlstm.LSTMClassifier(features, hidden=hidden,
                                 dtype=torch.float32, use_pallas=False)
    model.load_state_dict(convert.flax_to_state_dict(_f32(variables)))
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    th.cross_entropy(got, torch.from_numpy(labels)).backward()
    want_grads = convert.flax_to_state_dict(_f32({"params": grads}))
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(want_grads)
    assert len(params) == 14  # 4 input, 4 hidden kernels, 4 biases, head
    for name, g in want_grads.items():
        err = (params[name].grad - g).norm().item()
        assert err <= 1e-4 * g.norm().item(), (name, err)


def test_stock_cell_keeps_flax_dtypes_and_init():
    """fp32 parameters (Flax's param_dtype) under the Flax module name,
    gates in the compute dtype and an fp32 carry; Flax's initializers:
    orthogonal hidden kernels, zero biases."""
    model = th.init_model(tlstm.LSTMClassifier(6, hidden=8,
                                               use_pallas=False), 0, "cpu")
    cell = getattr(model, tlstm.STOCK_CELL)
    assert not hasattr(model, "cell")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    wh = cell.hf.weight
    torch.testing.assert_close(wh @ wh.T, torch.eye(8), atol=1e-5, rtol=0)
    assert not cell.hi.bias.any() and cell.ii.bias is None
    wi, wh4, bh = cell.kernels()
    assert (wi.shape, wh4.shape, bh.shape) == ((6, 32), (8, 32), (32,))
    assert wi.dtype == torch.bfloat16
    out = model(torch.ones(2, 3, 6))
    assert out.shape == (2, 2) and out.dtype == torch.float32


@pytest.mark.parametrize("on_card,layout", [(False, tlstm.STOCK_CELL),
                                            (True, "cell")])
def test_runner_builds_the_jax_runners_layout(on_card, layout):
    model = trun.build_model("lstm", torch.bfloat16, 8, on_card=on_card)
    assert model.use_pallas is on_card
    assert hasattr(model, layout)


def test_runner_runs_the_stock_layout_on_the_cpu(monkeypatch, capsys):
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    built = []

    def build(*args, **kwargs):
        built.append(trun_build(*args, **kwargs))
        return built[-1]
    trun_build = trun.build_model
    monkeypatch.setattr(trun, "build_model", build)
    before = _build.launches["lstm_cell"]
    assert trun.main(["--model", "lstm", "--batch", "2", "--size", "8",
                      "--steps", "1", "--device", "cpu"]) == 0
    assert len(built) == 1 and not built[0].use_pallas
    assert _build.launches["lstm_cell"] == before
