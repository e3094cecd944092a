"""The fused eval BatchNorm + ReLU passes (``workloads/bn_relu.py``) on the
CPU: their plain versions against the modules' own path, the ResNet's loop
that carries (sum, pre-activation), in eval and in training, against its
blocks run one by one, and the kernel wrappers: the plain versions on
CPU tensors and dtypes other than bf16, and the refusals of a layout or a
width, which come before any build. The kernels themselves run only on
the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.workloads import bn_relu, harness, resnet
from torch_support import one_torch_thread  # noqa: F401

#: every width a BatchNorm of ResNet-V2-50 normalizes: bn1 and bn2 at each
#: stage's width, the preact and final BatchNorms at four times it
CHANNELS = [64, 128, 256, 512, 1024, 2048]
DTYPES = [torch.float32, torch.bfloat16]


def _bn(channels: int, seed: int) -> resnet.BatchNorm:
    """An eval BatchNorm with drawn running statistics, weight and bias."""
    rng = np.random.default_rng(seed)
    bn = resnet.BatchNorm(channels)
    with torch.no_grad():
        for t, (lo, hi) in ((bn.running_mean, (-0.3, 0.3)),
                            (bn.running_var, (0.5, 1.5)),
                            (bn.weight, (0.8, 1.2)),
                            (bn.bias, (-0.3, 0.3))):
            t.copy_(torch.from_numpy(rng.uniform(lo, hi, channels)
                                     .astype(np.float32)))
    return bn.eval()


def _activation(channels: int, dtype, seed: int, shape=(2, 3, 5)):
    """A channels-last [N, C, H, W] activation in ``dtype``."""
    n, h, w = shape
    a = np.random.default_rng(seed).standard_normal((n, h, w, channels))
    return torch.from_numpy(a.astype(np.float32)).to(dtype).permute(
        0, 3, 1, 2)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels", CHANNELS)
def test_plain_bn_relu_is_the_modules_path(channels, dtype):
    bn = _bn(channels, seed=channels)
    x = _activation(channels, dtype, seed=1)
    _same(bn_relu.bn_relu_reference(x, bn), F.relu(bn(x)))


@pytest.mark.parametrize("keep_sum", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels", CHANNELS)
def test_plain_add_bn_relu_is_the_modules_path(channels, dtype, keep_sum):
    bn = _bn(channels, seed=channels)
    a = _activation(channels, dtype, seed=2)
    b = _activation(channels, dtype, seed=3)
    s, y = bn_relu.add_bn_relu_reference(a, b, bn, keep_sum=keep_sum)
    if keep_sum:
        _same(s, a + b)
    else:
        assert s is None
    _same(y, F.relu(bn(a + b)))


def _blocks_one_by_one(model, x):
    """ResNetV2's eval logits as its blocks' own ``forward`` gives them."""
    x = x.to(model.dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    x = model.conv_root(x)
    x, pad = resnet._pad_same(x, 3, 2, value=float("-inf"))
    x = F.max_pool2d(x, 3, stride=2, padding=pad)
    for name in model.block_names:
        x = getattr(model, name)(x)
    x = F.relu(model.final_bn(x)).mean(dim=(2, 3))
    return model.head(x.float())


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_loop_is_the_blocks_path_and_launches_no_kernel_on_the_cpu(
        dtype):
    model = harness.init_model(
        resnet.ResNetV2(depth=50, num_classes=16, dtype=dtype), 0, "cpu")
    for k, m in enumerate(model.modules()):
        if isinstance(m, resnet.BatchNorm):
            m.load_state_dict(_bn(m.num_features, seed=k).state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    counts = _counts()
    got = harness.make_infer_fn(model)(x)
    assert _counts() == counts == (0, 0)
    with torch.inference_mode():
        want = _blocks_one_by_one(model, x)
    _same(got, want)


def test_train_loop_is_the_blocks_path():
    """In training the carried loop runs the modules' own ops in the
    blocks' order: the same logits and the same running statistics."""
    import copy
    model = harness.init_model(
        resnet.ResNetV2(depth=50, num_classes=16, dtype=torch.float32),
        0, "cpu").train()
    twin = copy.deepcopy(model)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        _same(model(x), _blocks_one_by_one(twin, x))
    for (name, got), want in zip(model.named_buffers(), twin.buffers()):
        assert torch.equal(got, want), name
    assert _counts() == (0, 0)


def _counts() -> tuple[int, int]:
    return _build.launches["bn_relu"], _build.launches["add_bn_relu"]


@pytest.mark.parametrize("case,match", [
    ("float32", None),
    ("nchw", "channels-last"),
    ("channels", "12 channels"),
    ("cpu", None),
])
def test_kernel_wrappers_refuse_before_building(case, match, monkeypatch):
    """A float32 or a CPU input is the plain versions', with no build and
    no count; on input the wrappers take for the kernel (bf16 on a card,
    made to hold here), a layout or a width it cannot read raises before
    any build."""
    def no_build(*_):
        raise AssertionError("the wrapper built the kernel")
    monkeypatch.setattr(bn_relu._build, "_library", no_build)
    channels = 12 if case == "channels" else 16
    bn = _bn(channels, seed=0)
    x = _activation(channels, torch.bfloat16, seed=0)
    if case == "float32":
        x = x.float()
    elif case == "nchw":
        x = x.contiguous()
    counts = _counts()
    if match is None:
        _same(bn_relu.bn_relu(x, bn), bn_relu.bn_relu_reference(x, bn))
        s, y = bn_relu.add_bn_relu(x, x, bn, keep_sum=False)
        assert s is None
        _same(y, bn_relu.add_bn_relu_reference(x, x, bn)[1])
    else:
        monkeypatch.setattr(bn_relu, "_kernel_takes", lambda *_: True)
        with pytest.raises(ValueError, match=match):
            bn_relu.bn_relu(x, bn)
        with pytest.raises(ValueError, match=match):
            bn_relu.add_bn_relu(x, x, bn, keep_sum=False)
    assert _counts() == counts == (0, 0)
