"""Train steps of the port's models against the JAX package's, on the CPU
at tiny sizes: ``harness.make_train_fn`` with SGD-momentum (``optax.sgd(
1e-3, momentum=0.9)`` on the JAX side) on the ResNet's bottleneck and the
whole ResNet-50, and the LSTM classifier through the fused cell's
``autograd.Function``. Both sides start from the same weights (the Flax
init's, or for ResNet-50 seeded numpy ones in its tree), carried across
by ``convert.flax_to_state_dict``, and see the same seeded numpy batch; the
parameters' updates and the BatchNorm running statistics are compared,
each case stating its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import harness as th
from k8s_device_plugin_torch.workloads import lstm as tlstm
from k8s_device_plugin_torch.workloads import resnet as tresnet
from k8s_device_plugin_tpu.workloads import harness as jh
from k8s_device_plugin_tpu.workloads.lstm import LSTMClassifier
from k8s_device_plugin_tpu.workloads.resnet import BottleneckV2, ResNetV2
from torch_support import one_torch_thread, seeded_variables  # noqa: F401


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_steps(model, x, labels, loss_fn, steps, dtype=None, init=None):
    """``steps`` of the JAX harness's train step from the variables
    ``init`` or, when none are given, from the model's own init (under
    jit, which draws the same weights in half the time), the state cast to
    ``dtype`` when one is given; returns the initial variables (fp32), the
    final state and the losses."""
    tx = optax.sgd(1e-3, momentum=0.9)
    if init is None:
        state = jax.jit(lambda b: jh.init_train_state(model, tx, b))(x)
        init = {"params": state["params"],
                "batch_stats": state["batch_stats"]}
    else:
        state = {"params": init["params"],
                 "batch_stats": init["batch_stats"],
                 "opt_state": tx.init(init["params"]),
                 "step": jnp.zeros((), jnp.int32)}
    if dtype is not None:
        state = jax.tree_util.tree_map(
            lambda a: a.astype(dtype)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, state)
    step = jax.jit(jh.make_train_fn(model, tx, loss_fn=loss_fn))
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, labels)
        losses.append(float(loss))
    return _f32(init), state, losses


def _torch_steps(model, x, labels, loss_fn, steps):
    step = th.make_train_fn(model, th.sgd(model), loss_fn=loss_fn)
    state = th.init_train_state(model)
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, labels)
        losses.append(loss.item())
    assert state == {"step": steps}
    return losses


def _assert_moved_alike(model, before, jax_state, tol):
    """Every parameter's update p_n - p_0, and every BatchNorm running
    statistic, against the JAX state's within ``tol`` of the largest
    magnitude of that array."""
    want = convert.flax_to_state_dict(_f32(
        {"params": jax_state["params"],
         "batch_stats": jax_state["batch_stats"]}))
    after = model.state_dict()
    params = dict(model.named_parameters())
    checked = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        if name in params:
            got = (after[name].float() - before[name].float()).numpy()
            w = w.numpy() - before[name].float().numpy()
        else:
            got, w = after[name].float().numpy(), w.numpy()
        scale = np.abs(w).max()
        assert scale > 0, name  # the step moved it
        np.testing.assert_allclose(got, w, rtol=0, atol=tol * scale,
                                   err_msg=name)
        checked += 1
    return checked


@pytest.mark.parametrize("stride,in_ch,filters", [(1, 16, 4), (2, 8, 4)])
def test_bottleneck_train_steps_match_flax(stride, in_ch, filters):
    """Two SGD-momentum steps of make_train_fn on BottleneckV2 in train
    mode (batch 2 @ 8x8, fp32, seg_cross_entropy over its channels-last
    output): each parameter's update and each running statistic within
    1e-4 of its largest magnitude. PyTorch's own BatchNorm2d updates the
    running variance with the unbiased batch variance, 0.8% off here."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, in_ch)).astype(np.float32)
    out_hw = 8 // stride
    labels = rng.integers(0, 4 * filters, (2, out_hw, out_hw))
    ref = BottleneckV2(filters, stride, dtype=jnp.float32)
    init, state, losses = _jax_steps(ref, jnp.asarray(x),
                                     jnp.asarray(labels),
                                     jh.seg_cross_entropy, 2)

    block = tresnet.BottleneckV2(in_ch, filters, stride,
                                 param_dtype=torch.float32)
    block.load_state_dict(convert.flax_to_state_dict(init))
    before = {k: v.clone() for k, v in block.state_dict().items()}
    got = _torch_steps(_ChannelsLast(block), torch.from_numpy(x),
                       torch.from_numpy(labels), th.seg_cross_entropy, 2)
    np.testing.assert_allclose(got, losses, rtol=1e-5, atol=1e-5)
    assert _assert_moved_alike(block, before, state, 1e-4) >= 10


class _ChannelsLast(torch.nn.Module):
    """A bare block on NHWC tensors, as the JAX block is called (inside
    ResNetV2 blocks see the NCHW view of channels_last memory)."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x):
        return self.block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def test_bottleneck_bf16_keeps_fp32_weights_as_flax():
    """Flax's Conv(dtype=bf16) keeps fp32 parameters; so does the port's
    train build (param_dtype fp32), computing in bf16. Both take the same
    two steps: the losses within 1e-2, each update and running statistic
    within 3e-2 of its largest magnitude (bf16 activations round at other
    places in the two frameworks; 1e-2 seen). bf16 weights would round
    most conv updates at lr 1e-3 away: 100% off."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    labels = rng.integers(0, 16, (2, 8, 8))
    ref = BottleneckV2(4, 1, dtype=jnp.bfloat16)
    init, state, losses = _jax_steps(ref, jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(labels),
                                     jh.seg_cross_entropy, 2)
    block = tresnet.BottleneckV2(16, 4, 1, param_dtype=torch.float32)
    block.load_state_dict(convert.flax_to_state_dict(init))
    assert all(p.dtype == torch.float32 for p in block.parameters())
    before = {k: v.clone() for k, v in block.state_dict().items()}
    got = _torch_steps(_ChannelsLast(block),
                       torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(labels), th.seg_cross_entropy, 2)
    np.testing.assert_allclose(got, losses, rtol=1e-2)
    assert _assert_moved_alike(block, before, state, 3e-2) >= 10


def test_resnet50_train_step_matches_flax():
    """One step of the whole ResNet-V2-50 (batch 2 @ 64, 4 classes) from
    seeded weights, both sides in fp64 but the fp32 heads: the loss at
    1e-6, each parameter's update within 1e-4 of its own L2 norm (4.3e-6
    seen, the fp32 head's rounding), each BatchNorm running statistic
    within 1e-6 of its largest magnitude. fp64 keeps the comparison
    tight: in fp32 a ReLU mask flipped by rounding moves a channel's whole
    gradient at this batch (from the Flax init the port and Flax differed
    by 2.8-8.6% in L2). At 32 x 32 stage 4 sees two values a channel and
    the step is degenerate (conv_root moves by 1.7e6 in L2, against 0.17
    here)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 64, 64, 3))
    labels = rng.integers(0, 4, (2,))
    with jax.enable_x64(True):
        ref = ResNetV2(depth=50, num_classes=4, dtype=jnp.float64)
        init, state, losses = _jax_steps(
            ref, jnp.asarray(x), jnp.asarray(labels), jh.cross_entropy, 1,
            dtype=jnp.float64, init=seeded_variables(ref, x, seed=0))
    model = tresnet.ResNetV2(depth=50, num_classes=4, dtype=torch.float64)
    model.double()
    model.head.float()  # the port's head is fp32, as the JAX Dense
    model.load_state_dict(convert.flax_to_state_dict(init))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = _torch_steps(model, torch.from_numpy(x), torch.from_numpy(labels),
                       th.cross_entropy, 1)
    np.testing.assert_allclose(got, losses, rtol=1e-6, atol=1e-6)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": state["params"],
                     "batch_stats": state["batch_stats"]}))
    after = model.state_dict()
    moved = 0
    for name, _ in model.named_parameters():
        d_got = after[name].double() - before[name].double()
        d_want = want[name].double() - before[name].double()
        assert (d_got - d_want).norm() <= 1e-4 * d_want.norm(), name
        moved += d_want.numel()
    assert moved > 2e7
    stats = [n for n in want if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 49  # 16 blocks of 3, and the final one
    for name in stats:
        w = want[name].numpy()
        np.testing.assert_allclose(after[name].numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("batch,features,hidden", [(3, 12, 16), (4, 30, 8)])
def test_lstm_train_steps_match_jax(batch, features, hidden):
    """Two SGD-momentum steps of the LSTM classifier (6 time steps, fp32)
    against the JAX LSTMClassifier in its fused-cell layout at shapes
    where its lstm_cell takes the jnp path (F, H % 128 != 0), which JAX
    differentiates: the losses at 1e-5, each update within 1e-4 of its
    largest magnitude. The port's cell runs its recompute backward."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((batch, 6, features)).astype(np.float32)
    labels = rng.integers(0, 2, (batch,))
    ref = LSTMClassifier(hidden=hidden, dtype=jnp.float32, use_pallas=True,
                         pallas_interpret=False)
    init, state, losses = _jax_steps(ref, jnp.asarray(x),
                                     jnp.asarray(labels), jh.cross_entropy,
                                     2)
    model = tlstm.LSTMClassifier(features, hidden=hidden,
                                 dtype=torch.float32)
    model.load_state_dict(convert.flax_to_state_dict(init))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = _torch_steps(model, torch.from_numpy(x), torch.from_numpy(labels),
                       th.cross_entropy, 2)
    np.testing.assert_allclose(got, losses, rtol=1e-5, atol=1e-5)
    assert _assert_moved_alike(model, before, state, 1e-4) == 5


def test_harness_sgd_is_optax_sgd():
    """Three steps of harness.sgd against optax.sgd on fixed gradients, with
    momentum 0.9 and without (the LM's plain p - lr g), at 1e-7."""
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal(5).astype(np.float32)
    grads = rng.standard_normal((3, 5)).astype(np.float32)
    for momentum in (0.9, 0.0):
        tx = optax.sgd(1e-3, momentum=momentum or None)
        params, opt = jnp.asarray(p0), None
        opt = tx.init(params)
        model = torch.nn.Linear(5, 1, bias=False)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(p0)[None])
        sgd = th.sgd(model, momentum=momentum)
        for g in grads:
            updates, opt = tx.update(jnp.asarray(g), opt, params)
            params = optax.apply_updates(params, updates)
            model.weight.grad = torch.from_numpy(g)[None].clone()
            sgd.step()
        np.testing.assert_allclose(model.weight.detach().numpy()[0],
                                   np.asarray(params), rtol=1e-7, atol=1e-7)
