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
from torch_support import one_torch_thread  # noqa: F401 (autouse)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _small_jax_models(monkeypatch):
    """The JAX runner only gives the keys to compare, and they depend on
    neither depth nor width: its ResNet-50 keeps one bottleneck and its
    LSTM 16 hidden units (at full size their steps cost the CPU tens of
    seconds)."""
    from k8s_device_plugin_tpu.workloads import resnet as jresnet
    from k8s_device_plugin_tpu.workloads.lstm import LSTMClassifier
    build = jrun.build_model

    def small(name, dtype, on_tpu=False):
        if name == "lstm":
            return LSTMClassifier(hidden=16, dtype=dtype, use_pallas=on_tpu)
        return build(name, dtype, on_tpu=on_tpu)
    monkeypatch.setitem(jresnet.DEPTHS, 50, (1, 0, 0, 0))
    monkeypatch.setattr(jrun, "build_model", small)


def test_runner_prints_the_jax_runners_keys(monkeypatch, capsys):
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    tiny = ["--model", "lstm", "--batch", "2", "--size", "8", "--steps", "1"]
    with monkeypatch.context() as patch:
        _small_jax_models(patch)
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


@pytest.mark.parametrize("mode", ["infer", "decode"])
def test_runner_runs_the_lm_with_the_jax_runners_keys(mode, monkeypatch,
                                                      capsys):
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    tiny = ["--model", "lm", "--mode", mode, "--batch", "2", "--size", "16",
            "--steps", "1"]
    assert jrun.main(tiny) == 0
    want = _last_json(capsys)
    from k8s_device_plugin_torch.workloads.flash import flash_absorb
    before = flash_absorb.launches
    assert trun.main(tiny + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert sorted(got) == sorted(want)
    assert (got["model"], got["mode"], got["batch"]) == ("lm", mode, 2)
    if mode == "infer":
        assert (got["seq"], got["sp"]) == (16, 1) and got["tokens_per_s"] > 0
    else:
        assert got["prompt"] == 16 and got["gen_tokens_per_s"] > 0
        assert got["prefill_s"] >= 0 and got["prefill_compile_s"] >= 0
    assert flash_absorb.launches == before  # the CPU ran no kernel
    assert trun.LM_CONFIG == jrun.LM_CONFIG
    assert trun.CASES["lm"] == jrun.CASES["lm"]


@pytest.mark.parametrize("model", ["lm", "resnet50", "lstm"])
def test_runner_trains_with_the_jax_runners_keys(model, monkeypatch,
                                                 capsys):
    """--mode train at tiny sizes: the JAX runner's keys (from its small
    models), the train batch when --batch is not given (the LM's 4), and
    no kernel launched on the CPU."""
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    tiny = ["--model", model, "--mode", "train", "--size", "16", "--steps",
            "1"] + (["--batch", "2"] if model != "lm" else [])
    with monkeypatch.context() as patch:
        _small_jax_models(patch)
        assert jrun.main(tiny) == 0
    want = _last_json(capsys)
    from k8s_device_plugin_torch.workloads.flash import flash_absorb
    before = (flash_absorb.launches, _lstm_launches())
    assert trun.main(tiny + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert sorted(got) == sorted(want)
    assert (got["model"], got["mode"]) == (model, "train")
    assert got["batch"] == want["batch"] == (
        trun.CASES["lm"][1] if model == "lm" else 2)
    assert got["items_per_s"] > 0
    if model == "lm":
        assert (got["seq"], got["sp"]) == (16, 1) and got["tokens_per_s"] > 0
    assert (flash_absorb.launches, _lstm_launches()) == before
    assert trun.CASES[model] == jrun.CASES[model]


@pytest.mark.parametrize("argv", [
    ["--model", "vgg16"],
    ["--model", "moe-lm"],
    ["--model", "vgg16", "--mode", "train"],
    ["--model", "deeplab", "--mode", "train"],
    ["--model", "lstm", "--multichip"],
])
def test_runner_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        trun.main(argv + ["--device", "cpu"])


def test_runner_refuses_decode_for_a_model_without_a_cache():
    with pytest.raises(SystemExit, match="decode supports"):
        trun.main(["--model", "resnet50", "--mode", "decode", "--device",
                   "cpu"])


def test_entry_defaults_to_cuda_and_runs_on_the_cpu_when_asked():
    import inspect
    from k8s_device_plugin_torch.workloads.attention import init_lm_params
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    assert inspect.signature(init_lm_params).parameters[
        "device"].default == "cuda"
    assert tbench.parse_args([]).device == "cuda"
    fn, args = entry("cpu")
    out = fn(*args)
    assert out.shape == (8, 1000) and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def test_bench_assembles_the_share_result(tmp_path, monkeypatch):
    # the bench's child processes inherit the environment: one thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
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


def test_runner_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        trun.main(["--model", "lm"])
