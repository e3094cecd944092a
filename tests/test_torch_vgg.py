"""VGG-16: the PyTorch port against the Flax reference on the CPU.

The same seeded numpy weights (drawn into the Flax model's tree by
``torch_support.seeded_variables``, carried across by
``convert.flax_to_state_dict``) and the same seeded numpy batch go through
both models in fp32, at the JAX tests' 32 x 32 with 10 classes, and at
64 x 64, where ``fc1`` sees 2 x 2 positions and the order of its rows
shows. Dropout masks cannot match JAX's bit for bit, so the train step is
compared with dropout off and the dropout itself is checked by its
statistics.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import harness as th
from k8s_device_plugin_torch.workloads import vgg as tvgg
from k8s_device_plugin_tpu.workloads import harness as jh
from k8s_device_plugin_tpu.workloads.vgg import VGG16
from test_torch_train_models import _jax_steps, _torch_steps
from torch_support import one_torch_thread, seeded_variables  # noqa: F401

#: fp32 logits: both sides sum 16 layers of products in other orders
TOLERANCE = 1e-4


@functools.lru_cache
def _variables(size):
    """Seeded weights and a batch at ``size``, drawn once a module."""
    x = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = VGG16(num_classes=10, dtype=jnp.float32)
    return x, ref, seeded_variables(ref, jnp.asarray(x), seed=0)


def _models(size):
    x, ref, variables = _variables(size)
    model = tvgg.VGG16(num_classes=10, image_size=size, dtype=torch.float32)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return x, ref, variables, model.eval()


@pytest.mark.parametrize("size", [32, 64])
def test_vgg16_logits_match_flax(size):
    """Eval-mode logits within 1e-4 of the largest. At 64 x 64 the input
    (not symmetric) reaches ``fc1`` on 2 x 2 positions: flattening the
    channels-first view instead would give other logits (checked)."""
    x, ref, variables, model = _models(size)
    want = np.asarray(jax.jit(lambda v, b: ref.apply(v, b, train=False))(
        variables, jnp.asarray(x)))
    got = th.make_infer_fn(model)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 10) and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOLERANCE * scale)
    if size == 64:
        # fc1's rows permuted to (c, h, w): what an NCHW flatten would read
        fc1 = model.fc1.weight.detach()
        chw = fc1.reshape(4096, 2, 2, 512).permute(0, 3, 1, 2).reshape(
            4096, -1)
        with torch.no_grad():
            model.fc1.weight.copy_(chw)
        wrong = th.make_infer_fn(model)(torch.from_numpy(x)).numpy()
        assert np.abs(wrong - want).max() > 100 * TOLERANCE * scale


def test_dropout_keeps_half_and_scales_by_two():
    """Flax's nn.Dropout(0.5): each unit kept with probability 1/2 and
    scaled by 1 / (1 - 0.5); the same seed gives the same mask; no
    generator, no dropout."""
    x = torch.rand(200_000) + 0.5
    g = torch.Generator().manual_seed(0)
    y = tvgg.dropout(x, tvgg.DROPOUT_RATE, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.005
    torch.testing.assert_close(y[kept], 2 * x[kept])
    again = tvgg.dropout(x, tvgg.DROPOUT_RATE, g.manual_seed(0))
    assert torch.equal(y, again)
    assert torch.equal(tvgg.dropout(x, tvgg.DROPOUT_RATE, None), x)


class _Masked(torch.nn.Module):
    """A linear layer with dropout after it, keeping the masks it drew."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(64, 64)
        self.masks = []

    def forward(self, x, dropout_generator=None):
        y = tvgg.dropout(self.lin(x), 0.5, dropout_generator)
        self.masks.append(y != 0)
        return y


def test_train_step_reseeds_dropout_every_step():
    """make_train_fn(has_dropout=True) draws one mask, re-seeded every step
    as the JAX step re-seeds its dropout key; without has_dropout the
    model gets no generator."""
    model = _Masked()
    x = torch.randn(8, 64) + 3.0
    labels = torch.zeros(8, dtype=torch.long)
    step = th.make_train_fn(model, th.sgd(model), has_dropout=True)
    state = th.init_train_state(model)
    for _ in range(3):
        state, _ = step(state, x, labels)
    first, *rest = model.masks
    assert all(torch.equal(first, m) for m in rest)
    assert 0.3 < first.float().mean().item() < 0.7
    step = th.make_train_fn(model, th.sgd(model))
    step(state, x, labels)
    assert model.masks[-1].all()


class _NoDropout:
    """The Flax VGG in a train step with dropout off: VGG has no
    BatchNorm, so train=False differs from train=True only there."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, train, rngs=None):
        return self.model.apply(variables, batch, train=False)


def test_vgg16_train_steps_match_flax_without_dropout():
    """Two SGD-momentum steps (optax.sgd(1e-3, 0.9)) at batch 2 @ 32, fp32,
    dropout off on both sides: the losses at 1e-5, each parameter's update
    p2 - p0 within 1e-4 of its largest magnitude plus 2 fp32 ulps of the
    weights: conv1's updates are ~1e-6, and the weights' own rounding
    (~3e-8 at 0.3, on each side once a step) is larger than 1e-4 of
    that."""
    x, ref, variables, model = _models(32)
    labels = np.random.default_rng(2).integers(0, 10, (2,))
    _, state, losses = _jax_steps(
        _NoDropout(ref), jnp.asarray(x), jnp.asarray(labels),
        jh.cross_entropy, 2, init={"params": variables["params"],
                                   "batch_stats": {}})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = _torch_steps(model, torch.from_numpy(x), torch.from_numpy(labels),
                       th.cross_entropy, 2)
    np.testing.assert_allclose(got, losses, rtol=1e-5, atol=1e-5)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": state["params"]}))
    after = model.state_dict()
    assert len(want) == 32  # 13 convs, fc1, fc2, head: weight and bias
    for name, w in want.items():
        p0 = before[name].numpy()
        d_got, d_want = after[name].numpy() - p0, w.numpy() - p0
        scale = np.abs(d_want).max()
        assert scale > 0, name
        floor = 2 * np.finfo(np.float32).eps * np.abs(p0).max()
        np.testing.assert_allclose(d_got, d_want, rtol=0,
                                   atol=1e-4 * scale + floor, err_msg=name)
