"""ResNet-V2-50 parity: the PyTorch port against the Flax reference on CPU.

The same seeded numpy weights (the Flax model's own init, transferred by
``convert.flax_to_state_dict``) and the same seeded numpy batch go through
both models in eval mode at batch 2 @ 32x32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.workloads import convert, harness
from k8s_device_plugin_torch.workloads import resnet as tresnet
from k8s_device_plugin_tpu.workloads.resnet import ResNetV2

# fp32: both sides sum convolutions in other orders over 50 layers; the
# gap is ~1e-6 relative, so 1e-4 of the largest logit leaves margin.
# bf16: each side rounds activations to bf16 after every conv at its own
# places (XLA fuses, PyTorch does not), so errors of ~2^-8 per layer
# compound; the bound is 5e-2 of the largest logit.
TOLERANCE = {"float32": 1e-4, "bfloat16": 5e-2}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(autouse=True)
def _no_tf32():
    # fp32 parity is claimed: keep every fp32 product in full precision
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_logits_match_flax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = ResNetV2(depth=50, num_classes=16, dtype=getattr(jnp, dtype))
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    # non-trivial BatchNorm statistics, so the transfer of mean/var counts
    def stat(path, a):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])
    variables = {"params": _numpy_tree(variables["params"]),
                 "batch_stats": stats}
    want = np.asarray(ref.apply(variables, jnp.asarray(x), train=False),
                      np.float32)

    model = tresnet.ResNetV2(depth=50, num_classes=16,
                             dtype=getattr(torch, dtype))
    model.load_state_dict(convert.flax_to_state_dict(variables))
    model.eval()
    got = harness.make_infer_fn(model)(torch.from_numpy(x)).numpy()

    assert got.shape == want.shape == (2, 16)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0.1  # the comparison is not between two zero vectors
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOLERANCE[dtype] * scale)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (32, 3, 2, (0, 1)),    # even input, stride 2: Flax pads after only
    (173, 3, 2, (1, 1)),   # odd input (346 after the root conv)
    (16, 3, 1, (1, 1)),
    (16, 1, 2, (0, 0)),
])
def test_same_padding_matches_flax_split(size, kernel, stride, want):
    assert tresnet._same_pad(size, kernel, stride) == want
    # cross-check against lax's own SAME rule
    assert tuple(jax.lax.padtype_to_pads((size,), (kernel,), (stride,),
                                         "SAME")[0]) == want


def test_flops_count_is_two_per_multiply_add():
    # ResNet-50 at 224x224 is ~4.1 G multiply-adds per image
    model = harness.init_model(tresnet.resnet50(dtype=torch.float32), 0,
                               "cpu")
    flops = harness.count_flops(model, torch.ones(1, 224, 224, 3))
    assert 8.0e9 < flops < 8.4e9
