"""The plain references against the port, at small sizes on the CPU, on
the same seeded weights; and the weights' layout against the port's."""

import pytest
import torch

import rehearse  # noqa: F401  (puts the repository on the path)
from rehearse import config
from vgpu_bench import check, tenant, weights
from vgpu_bench.reference import rounded


def port_and_reference(cfg, seed):
    model = tenant.build(cfg, seed, torch.device("cpu"))
    w = weights.make(cfg, seed, "cpu")
    x = weights.inputs(cfg, seed, 0, 0, "cpu")
    with torch.inference_mode():
        port = model(x).float()
    ref = weights.reference(cfg).forward(w, x, cfg)
    return port, ref


@pytest.mark.parametrize("name", ["resnet-tiny", "lstm-tiny"])
def test_reference_matches_port_in_fp32(name):
    """In fp32 the port and the reference compute the same function: a
    wrong padding, stride, gate order or BatchNorm would show far above
    rounding."""
    cfg = {**config(name), "dtype": "float32"}
    port, ref = port_and_reference(cfg, 12345)
    gap = (port - ref).abs().max() / ref.abs().max()
    assert gap < 1e-4, gap


@pytest.mark.parametrize("name", ["resnet-tiny", "lstm-tiny"])
def test_reference_matches_port_in_bf16(name):
    """The served dtype: the port's bf16 logits within the limit that the
    configuration states."""
    cfg = config(name)
    port, ref = port_and_reference(cfg, 2 ** 40 + 3)
    gap = ((port - ref).abs().max() / ref.abs().max()).item()
    assert gap < cfg["limits"]["logit_err"], gap


def test_resnet_at_image_size_64_matches_port():
    cfg = {**config("resnet-tiny"), "dtype": "float32", "image_size": 64,
           "runner_size": 64, "input_shape": [1, 64, 64, 3]}
    port, ref = port_and_reference(cfg, 7)
    assert ((port - ref).abs().max() / ref.abs().max()) < 1e-4


@pytest.mark.parametrize("name", ["resnet50-v2.case1.1", "lstm.case5.1"])
def test_layout_is_the_ports(name):
    """The benchmark's weights fill every tensor of the port's model at
    the configuration's own widths, with its shape and dtype."""
    cfg = config(name)
    with torch.device("meta"):
        from k8s_device_plugin_torch.workloads import run as runner
        model = runner.build_model(cfg["model"], getattr(torch, cfg["dtype"]),
                                   cfg["runner_size"], on_card=True)
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    layout = weights.reference(cfg).layout(cfg)
    assert sorted(state) == sorted(layout)
    for k, (shape, dtype, _) in layout.items():
        assert tuple(state[k].shape) == shape and state[k].dtype == dtype, k


def test_weights_and_inputs_repeat_from_the_seed():
    cfg = config("lstm-tiny")
    seed = 2 ** 33 + 1
    a, b = weights.make(cfg, seed, "cpu"), weights.make(cfg, seed, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = weights.make(cfg, seed + 1, "cpu")
    assert not torch.equal(a["cell.wx"], c["cell.wx"])
    x = weights.inputs(cfg, seed, 1, 0, "cpu")
    assert torch.equal(x, weights.inputs(cfg, seed, 1, 0, "cpu"))
    assert not torch.equal(x, weights.inputs(cfg, seed, 1, 1, "cpu"))
    assert not torch.equal(x, weights.inputs(cfg, seed, 0, 0, "cpu"))


def test_fp8_rounding():
    t = torch.linspace(-3, 3, 101)
    r = rounded(t, "fp8")
    assert torch.equal(rounded(t, "fp32"), t)
    assert 0 < (r - t).abs().max() <= 3 * 2 ** -3
    with pytest.raises(ValueError):
        rounded(t, "int3")


@pytest.mark.parametrize("name,batch,extra", [
    ("resnet50-v2.case1.1", 2, {"image_size": 96, "runner_size": 96,
                                "input_shape": [2, 96, 96, 3]}),
    ("lstm.case5.1", 4, {"time_steps": 16, "input_shape": [4, 16, 300]}),
])
def test_control_fails_the_limit(name, batch, extra):
    """The control, the reference computed in float8 in the program's
    place, reads above the configuration's limit at the configuration's
    widths (a smaller batch, image and sequence, to fit a test)."""
    cfg = {**config(name), **extra, "batch": batch}
    samples = {0: [(0, torch.zeros(1)), (1, torch.zeros(1))]}
    err, compared = check.logit_err(cfg, 99, samples, "cpu", control=True)
    assert compared == 2
    assert err > cfg["limits"]["logit_err"], err
