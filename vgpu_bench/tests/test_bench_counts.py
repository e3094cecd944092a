"""The benchmark's operation and byte counts."""

import torch

import rehearse  # noqa: F401
from rehearse import config
from vgpu_bench import tenant, weights
from vgpu_bench.counts import lstm, resnet50


def test_resnet_count_is_the_ports_count_flops():
    from k8s_device_plugin_torch.workloads import harness
    for size in (32, 45):
        cfg = {**config("resnet-tiny"), "dtype": "float32",
               "image_size": size, "runner_size": size,
               "input_shape": [1, size, size, 3]}
        model = tenant.build(cfg, 1, torch.device("cpu"))
        x = weights.inputs(cfg, 1, 0, 0, "cpu")
        assert resnet50.flops_per_item(cfg) == harness.count_flops(model, x)


def test_resnet_case_1_1():
    assert resnet50.flops_per_item(config("resnet50-v2.case1.1")) \
        == 20_083_828_096


def test_k2_at_case_5_1():
    """One step of the cell at case 5.1 reads and writes 11.7 MB (the
    kernel's table in PERF.md) and computes 2 x 100 x 4096 x 1324 FLOP."""
    flops, nbytes = lstm.kernel_cost(config("lstm.case5.1"))["lstm_cell"]
    assert nbytes == 11_733_600
    assert flops == 2 * 100 * 4096 * 1324
    assert lstm.flops_per_item(config("lstm.case5.1")) \
        == 1024 * 2 * 4096 * 1324 + 2 * 1024 * 2
