"""DeepLab-v3: the PyTorch port against the Flax reference on the CPU.

The same seeded numpy weights (drawn into the Flax tree by
``torch_support``, with non-trivial BatchNorm statistics, carried across by
``convert.flax_to_state_dict``) and batch go through both: the whole model
at the JAX tests' size (``backbone_blocks=((16, 1, 1), (32, 1, 2))``,
5 classes, 64 x 64) in fp32; ASPP alone on a 40 x 40 map, where every tap
of the rate-18 branch reaches data (at 64 x 64 the model's ASPP sees 4 x 4,
where rates 12 and 18 touch only padding); the bilinear resize against
``jax.image.resize``; and one train step in fp64 at the runner's train
batch of 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import deeplab as tdl
from k8s_device_plugin_torch.workloads import harness as th
from k8s_device_plugin_tpu.workloads import harness as jh
from k8s_device_plugin_tpu.workloads.deeplab import ASPP, DeepLabV3
from test_torch_train_models import _jax_steps, _torch_steps
from torch_support import (one_torch_thread, seeded_tree,  # noqa: F401
                           seeded_variables)

BLOCKS = ((16, 1, 1), (32, 1, 2))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_deeplab_logits_match_flax():
    """Eval-mode logits [2, 64, 64, 5] within 1e-4 of the largest."""
    x = _x((2, 64, 64, 3), seed=0)
    ref = DeepLabV3(num_classes=5, dtype=jnp.float32, backbone_blocks=BLOCKS)
    variables = seeded_variables(ref, jnp.asarray(x), seed=0, train=False)
    want = np.asarray(jax.jit(lambda v, b: ref.apply(v, b, train=False))(
        variables, jnp.asarray(x)))
    model = tdl.DeepLabV3(num_classes=5, backbone_blocks=BLOCKS,
                          dtype=torch.float32)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    got = th.make_infer_fn(model.eval())(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 5)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_aspp_matches_flax_where_every_tap_reaches_data():
    """ASPP (16 features, rates 6, 12, 18) on [1, 40, 40, 8]: each output
    within 1e-5 of the largest. 40 > 2 x 18 + 1, so the rate-18 branch
    reads data, not only padding, and a wrong dilation or padding shows."""
    x = _x((1, 40, 40, 8), seed=1)
    ref = ASPP(features=16, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda b: ref.init(jax.random.PRNGKey(0), b), jnp.asarray(x))
    variables = seeded_tree(shapes, seed=1)
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))
    aspp = tdl.ASPP(8, features=16, param_dtype=torch.float32)
    aspp.load_state_dict(convert.flax_to_state_dict(variables))
    with torch.no_grad():
        got = aspp(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("src,dst", [((4, 5), (64, 80)), ((4, 4), (64, 64)),
                                     ((3, 7), (9, 14))])
def test_resize_matches_jax_image_resize(src, dst):
    """The bilinear upsample against jax.image.resize on a non-constant
    map, edges included, at 1e-6: the model's 16x, and uneven factors."""
    x = _x((2, *src, 3), seed=2)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                       method="bilinear"))
    got = tdl.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                              dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_deeplab_train_step_matches_flax_in_fp64():
    """One SGD-momentum step on seg_cross_entropy at batch 1 @ 64 (the
    runner's train batch), both sides in fp64 but the fp32 classifier and
    resize, as ResNet-50's step is held (tests/test_torch_train_models.py:
    in fp32 a ReLU mask flipped by rounding moves a channel's gradient at
    this batch): the loss at 1e-6, each parameter's update within 1e-4 of
    its L2 norm, each BatchNorm running statistic within 1e-6 of its
    largest magnitude."""
    x = np.random.default_rng(3).standard_normal((1, 64, 64, 3))
    labels = np.random.default_rng(4).integers(0, 5, (1, 64, 64))
    with jax.enable_x64(True):
        ref = DeepLabV3(num_classes=5, dtype=jnp.float64,
                        backbone_blocks=BLOCKS)
        init, state, losses = _jax_steps(
            ref, jnp.asarray(x), jnp.asarray(labels), jh.seg_cross_entropy,
            1, dtype=jnp.float64, init=seeded_variables(ref, x, seed=0))
    model = tdl.DeepLabV3(num_classes=5, backbone_blocks=BLOCKS,
                          dtype=torch.float64).double()
    model.load_state_dict(convert.flax_to_state_dict(init))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = _torch_steps(model, torch.from_numpy(x), torch.from_numpy(labels),
                       th.seg_cross_entropy, 1)
    np.testing.assert_allclose(got, losses, rtol=1e-6, atol=1e-6)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": state["params"],
                     "batch_stats": state["batch_stats"]}))
    after = model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len([n for n in want if n.endswith(
        ("weight", "bias"))]) > 30
    for name in names:
        d_got = after[name].double() - before[name].double()
        d_want = want[name].double() - before[name].double()
        assert d_want.norm() > 0, name
        assert (d_got - d_want).norm() <= 1e-4 * d_want.norm(), name
    stats = [n for n in want if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 6  # two blocks of three BatchNorms
    for name in stats:
        w = want[name].numpy()
        np.testing.assert_allclose(after[name].numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
