"""The port's runner and bench, driven on the CPU at tiny sizes.

The runner must print the same JSON keys as the JAX package's runner, so
whatever reads one reads the other. Timings from a CPU run say nothing
about a card; only the keys and the control flow are checked here.
"""

import json

import pytest
import torch

from k8s_device_plugin_torch import bench as tbench
from k8s_device_plugin_torch.entry import entry
from k8s_device_plugin_torch.workloads import run as trun
from k8s_device_plugin_tpu.workloads import run as jrun


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_runner_prints_the_jax_runners_keys(monkeypatch, capsys):
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    tiny = ["--model", "lstm", "--batch", "2", "--size", "8", "--steps", "1"]
    assert jrun.main(tiny) == 0
    want = _last_json(capsys)
    before = _lstm_launches()
    assert trun.main(tiny + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert sorted(got) == sorted(want)
    assert (got["model"], got["mode"], got["batch"]) == ("lstm", "infer", 2)
    assert got["hbm_violations"] == 0
    assert _lstm_launches() == before  # the CPU ran the plain version


def _lstm_launches():
    from k8s_device_plugin_torch.workloads.pallas_ops import lstm_cell
    return lstm_cell.launches


@pytest.mark.parametrize("model", ["resnet50", "resnet152"])
def test_runner_runs_the_resnets(model, monkeypatch, capsys, tmp_path):
    # under the contract: the limiter installs and its throttle runs
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", str(tmp_path))
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_LIMIT_0", str(1 << 30))
    monkeypatch.setenv("VTPU_DEVICE_CORE_LIMIT", "100")
    from k8s_device_plugin_torch.shm import limiter
    monkeypatch.setattr(limiter, "_limiter", None)
    try:
        assert trun.main(["--model", model, "--batch", "1", "--size", "32",
                          "--steps", "1", "--device", "cpu"]) == 0
    finally:
        if limiter.get() is not None:
            limiter.get().uninstall()
    out = _last_json(capsys)
    assert out["model"] == model and out["items_per_s"] > 0


@pytest.mark.parametrize("argv", [
    ["--model", "vgg16"],
    ["--model", "lm"],
    ["--model", "resnet50", "--mode", "train"],
    ["--model", "lstm", "--multichip"],
])
def test_runner_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        trun.main(argv + ["--device", "cpu"])


def test_entry_defaults_to_cuda_and_runs_on_the_cpu_when_asked():
    import inspect
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    assert tbench.parse_args([]).device == "cuda"
    fn, args = entry("cpu")
    out = fn(*args)
    assert out.shape == (8, 1000) and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def test_bench_assembles_the_share_result(tmp_path):
    args = tbench.parse_args(["--device", "cpu", "--batch", "1",
                              "--image-size", "32", "--iters", "3",
                              "--share-procs", "2", "--share", "2"])
    result = tbench.measure(args, str(tmp_path))
    extra = result["extra"]
    assert result["metric"] == "resnet50_infer_img_per_s_2way_vtpu_cpu"
    # every image over the shared window: never more than the children's
    # own rates summed, each over a window no longer than the shared one
    assert result["value"] == pytest.approx(
        extra["images"] / extra["window_s"])
    assert extra["images"] == 2 * 1 * 3 * tbench.PASSES
    assert result["value"] <= sum(extra["per_proc_img_per_s"]) * (1 + 1e-9)
    assert len(extra["per_proc_best_pass_img_per_s"]) == 2
    assert extra["share_procs"] == 2 and extra["hbm_limit_violations"] == 0
    assert extra["platform"] == "cpu" and extra["mfu"] == 0.0
    assert 0.0 < extra["probe"]["availability"] <= 1.0
    assert extra["probe"]["samples"] >= 1
