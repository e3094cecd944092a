"""The port's runner and bench, driven on the CPU at tiny sizes.

The runner must print the same JSON keys as the JAX package's runner, so
whatever reads one reads the other. Timings from a CPU run say nothing
about a card; only the keys and the control flow are checked here.
"""

import contextlib
import copy
import functools
import io
import json

import jax
import pytest
import torch

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch import bench as tbench
from k8s_device_plugin_torch.entry import entry
from k8s_device_plugin_torch.workloads import run as trun
from k8s_device_plugin_tpu.workloads import harness as jh
from k8s_device_plugin_tpu.workloads import run as jrun
from torch_support import one_torch_thread  # noqa: F401 (autouse)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


#: the LM shape of the JAX runner's lines that the LM tests read keys from:
#: its line's keys do not depend on it, and a small LM compiles in a
#: fraction of the CPU time of ``LM_CONFIG``'s
JAX_KEYS_LM = (2, 16, 64, 1)


@functools.lru_cache
def _jax_lm_line(*argv) -> dict:
    """The JAX runner's last line for ``argv`` (an ``lm`` or ``moe-lm``
    case) at ``JAX_KEYS_LM``."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as patch, \
            contextlib.redirect_stdout(out):
        patch.setattr(jrun, "LM_CONFIG", JAX_KEYS_LM)
        assert jrun.main(list(argv)) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_runner_prints_the_jax_runners_keys(monkeypatch, capsys):
    """The LSTM's line: the keys of the JAX runner's line, which one
    ``_bench_loop`` prints for every model but the LMs (read once from
    its small DeepLab, ``_jax_conv_model_keys``)."""
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    tiny = ["--model", "lstm", "--batch", "2", "--size", "8", "--steps", "1"]
    want = _jax_conv_model_keys("infer")
    before = _lstm_launches()
    assert trun.main(tiny + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert sorted(got) == want
    assert (got["model"], got["mode"], got["batch"]) == ("lstm", "infer", 2)
    assert got["hbm_violations"] == 0
    assert _lstm_launches() == before  # the CPU ran the plain version


def _lstm_launches():
    return _build.launches["lstm_cell"]


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
    want = _jax_lm_line(*tiny)
    before = _build.launches["flash_absorb"]
    assert trun.main(tiny + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert sorted(got) == sorted(want)
    assert (got["model"], got["mode"], got["batch"]) == ("lm", mode, 2)
    if mode == "infer":
        assert (got["seq"], got["sp"]) == (16, 1) and got["tokens_per_s"] > 0
    else:
        assert got["prompt"] == 16 and got["gen_tokens_per_s"] > 0
        assert got["prefill_s"] >= 0 and got["prefill_compile_s"] >= 0
    assert _build.launches["flash_absorb"] == before  # the CPU ran no kernel
    assert trun.LM_CONFIG == jrun.LM_CONFIG
    assert trun.CASES["lm"] == jrun.CASES["lm"]


@pytest.mark.parametrize("model", ["lm", "resnet50", "lstm"])
def test_runner_trains_with_the_jax_runners_keys(model, monkeypatch,
                                                 capsys):
    """--mode train at tiny sizes: the JAX runner's keys (the LM's from
    its LM runner, the others' from ``_jax_conv_model_keys``), the train
    batch when --batch is not given (the LM's 4), and no kernel launched
    on the CPU."""
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    tiny = ["--model", model, "--mode", "train", "--size", "16", "--steps",
            "1"] + (["--batch", "2"] if model != "lm" else [])
    if model == "lm":
        want = _jax_lm_line(*tiny)
        assert want["batch"] == trun.CASES["lm"][1]
        want = sorted(want)
    else:
        want = _jax_conv_model_keys("train")
    before = (_build.launches["flash_absorb"], _lstm_launches())
    assert trun.main(tiny + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert sorted(got) == want
    assert (got["model"], got["mode"]) == (model, "train")
    assert got["batch"] == (trun.CASES["lm"][1] if model == "lm" else 2)
    assert got["items_per_s"] > 0
    if model == "lm":
        assert (got["seq"], got["sp"]) == (16, 1) and got["tokens_per_s"] > 0
    assert (_build.launches["flash_absorb"], _lstm_launches()) == before
    assert trun.CASES[model] == jrun.CASES[model]


@pytest.mark.parametrize("mode", ["infer", "train", "decode"])
def test_runner_runs_the_moe_lm_with_the_jax_runners_keys(mode, monkeypatch,
                                                          capsys):
    """moe-lm in every mode, both runners at a tiny LM_CONFIG: the JAX
    runner's keys, the sequence padded to a whole 1024-token routing block
    to infer and train (seq 1024 from --size 16, as JAX reports it), the
    prompt as given to decode, and no kernel launched on the CPU."""
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    tiny = ["--model", "moe-lm", "--mode", mode, "--batch", "2", "--size",
            "16", "--steps", "1"]
    want = _jax_lm_line(*tiny)
    with monkeypatch.context() as patch:
        patch.setattr(trun, "LM_CONFIG", JAX_KEYS_LM)
        before = _build.launches["flash_absorb"]
        assert trun.main(tiny + ["--device", "cpu"]) == 0
        got = _last_json(capsys)
    assert sorted(got) == sorted(want)
    assert (got["model"], got["mode"], got["batch"]) == ("moe-lm", mode, 2)
    if mode == "decode":
        assert got["prompt"] == want["prompt"] == 16
        assert got["gen_tokens_per_s"] > 0
    else:
        assert (got["seq"], got["sp"]) == (want["seq"], want["sp"]) == (1024,
                                                                         1)
        assert got["tokens_per_s"] > 0
    assert _build.launches["flash_absorb"] == before
    assert trun.CASES["moe-lm"] == jrun.CASES["moe-lm"]
    assert (trun.MOE_EXPERTS, trun.MOE_GROUP) == (8, 1024)


@functools.lru_cache
def _jax_conv_model_keys(mode):
    """The JAX runner's keys for a convolutional model in ``mode``, read
    once: they come from one ``_bench_loop`` line whatever the model, so
    its DeepLab with two small stages gives them (with its Flax init
    traced once: run eagerly, the init alone costs VGG ~15 CPU-s)."""
    from k8s_device_plugin_tpu.workloads.deeplab import DeepLabV3
    init = jh.init_model

    def small(name, dtype, on_tpu=False):
        return DeepLabV3(dtype=dtype, backbone_blocks=((16, 1, 1),
                                                       (32, 1, 2)))

    def jit_init(model, sample, rng=None, train=False):
        return jax.jit(lambda b: init(model, b, rng, train))(sample)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as patch, \
            contextlib.redirect_stdout(out):
        patch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
        patch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
        patch.setattr(jrun, "build_model", small)
        patch.setattr(jh, "init_model", jit_init)
        assert jrun.main(["--model", "deeplab", "--mode", mode, "--batch",
                          "1", "--size", "32", "--steps", "1"]) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert (line["model"], line["mode"]) == ("deeplab", mode)
    return sorted(line)


@pytest.mark.parametrize("model,mode", [("vgg16", "infer"),
                                        ("vgg16", "train"),
                                        ("deeplab", "infer"),
                                        ("deeplab", "train")])
def test_runner_runs_vgg16_and_deeplab_with_the_jax_runners_keys(
        model, mode, monkeypatch, capsys):
    """Cases 3.x and 4.x at full width, batch 1 @ 32 on the CPU (VGG trains
    with its dropout, DeepLab on per-pixel labels): the JAX runner's keys,
    and no port kernel launched."""
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    monkeypatch.delenv("VTPU_COMPILE_CACHE_DIR", raising=False)
    want = _jax_conv_model_keys(mode)
    before = (_build.launches["flash_absorb"], _lstm_launches())
    assert trun.main(["--model", model, "--mode", mode, "--batch", "1",
                      "--size", "32", "--steps", "1", "--device",
                      "cpu"]) == 0
    got = _last_json(capsys)
    assert sorted(got) == want
    assert (got["model"], got["mode"], got["batch"]) == (model, mode, 1)
    assert got["items_per_s"] > 0
    assert (_build.launches["flash_absorb"], _lstm_launches()) == before
    assert trun.CASES[model] == jrun.CASES[model]


@pytest.mark.parametrize("argv", [
    ["--model", "moe-lm", "--mode", "decode", "--multichip"],
    ["--model", "vgg16", "--mode", "decode"],
])
def test_runner_refuses_what_is_not_ported(argv):
    """Every model and mode of the JAX runner is ported, ``moe-lm
    --multichip`` too; what stays refused is what the JAX runner refuses:
    decode across devices, and decode of a model without a cache."""
    with pytest.raises(SystemExit, match="--mode decode"):
        trun.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_runner_runs_the_moe_lm_multichip_at_world_one(mode, monkeypatch,
                                                       capsys):
    """``moe-lm --multichip`` on a world of one CPU rank, at a tiny
    LM_CONFIG: the JAX runner's keys (its line is the same dict with a mesh
    and without), the sequence not padded to a routing block (JAX routes
    each rank's whole block under a mesh), and its first calls (the
    logits; two steps' losses) against ``moe_lm_forward`` /
    ``moe_lm_loss`` without a mesh and with ``shard_shape=(1, 1)``, the
    oracle with the mesh's block boundaries, on the same weights, at the
    repo's bf16 bound of 2e-2 of the largest magnitude (the ring's absorb
    in place of dense attention)."""
    from k8s_device_plugin_torch.workloads import moe as tmoe
    monkeypatch.setattr(trun, "LM_CONFIG", JAX_KEYS_LM)
    tiny = ["--model", "moe-lm", "--mode", mode, "--batch", "2", "--size",
            "16", "--steps", "1"]
    argv = tiny + ["--device", "cpu", "--multichip"]
    assert trun.main(argv) == 0
    line = _last_json(capsys)
    assert sorted(line) == sorted(_jax_lm_line(*tiny))
    assert (line["seq"], line["sp"], line["batch"]) == (16, 1, 2)
    assert not torch.distributed.is_initialized()
    calls = 2 if mode == "train" else 1
    with trun.world(torch.device("cpu")) as device:
        call, _, _ = trun.build_call(trun.parse_args(argv), device)
        model, tokens = copy.deepcopy(call.model), call.tokens
        got = [call() for _ in range(calls)]
    assert model.layers[0].moe.w_in.shape[0] == trun.MOE_EXPERTS
    if mode == "infer":
        with torch.no_grad():
            want = [tmoe.moe_lm_forward(model, tokens, shard_shape=(1, 1))[0]]
    else:
        optimizer = torch.optim.SGD(model.parameters(), lr=1e-3)
        want = []
        for _ in range(calls):
            optimizer.zero_grad()
            loss = tmoe.moe_lm_loss(model, tokens, shard_shape=(1, 1))
            loss.backward()
            optimizer.step()
            want.append(loss.detach())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2 * w.float().abs().max().item())


@pytest.mark.parametrize("argv,rel", [
    (["--model", "lm", "--batch", "2", "--size", "16"], 2e-2),
    (["--model", "lm", "--mode", "train", "--batch", "2", "--size", "16"],
     2e-2),
    (["--model", "resnet50", "--batch", "2", "--size", "32"], 1e-6),
    (["--model", "vgg16", "--mode", "train", "--batch", "1", "--size",
      "32"], 2e-2),
    (["--model", "lstm", "--batch", "2", "--size", "8"], 1e-6),
])
def test_runner_runs_multichip_at_world_one(argv, rel, capsys):
    """--multichip on the CPU without a launcher: a world of one over gloo,
    (dp, mp) = (1, 1) for the convolutional models and the LSTM, (dp, sp)
    = (1, 1) for the LM, whose attention is then the ring's plain absorb.
    The runner prints its line, and one call of the path (the logits to
    infer, two steps' losses to train) matches the same path without a
    mesh on the same weights: the same arithmetic for the convolutional
    models and the LSTM to infer (1e-6); in bf16, at the repo's bf16 bound
    of 2e-2 of the largest magnitude, where the LM attends through the
    ring's absorb in place of dense attention and, to train, BatchNorm
    takes the batch's statistics through the sum over dp."""
    argv = argv + ["--steps", "1", "--device", "cpu"]
    assert trun.main(argv + ["--multichip"]) == 0
    line = _last_json(capsys)
    assert line["items_per_s"] > 0 and line["hbm_violations"] == 0
    if "lm" in argv:
        assert line["sp"] == 1
    assert not torch.distributed.is_initialized()
    calls = 2 if "train" in argv else 1
    want_call, _, _ = trun.build_call(trun.parse_args(argv),
                                      torch.device("cpu"))
    want = [want_call() for _ in range(calls)]
    with trun.world(torch.device("cpu")) as device:
        got_call, _, _ = trun.build_call(
            trun.parse_args(argv + ["--multichip"]), device)
        got = [got_call() for _ in range(calls)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rel,
                                   atol=rel * w.float().abs().max().item())


def test_runner_refuses_decode_across_devices():
    with pytest.raises(SystemExit, match="single-device"):
        trun.main(["--model", "lm", "--mode", "decode", "--multichip",
                   "--device", "cpu"])


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
    monkeypatch.setenv("VTPU_BENCH_OVERSUB_REPLICAS", "1")
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
    # the oversubscribe phase at the pinned shapes (no device memory to
    # spill on the CPU) and the duty check's two legs
    assert extra["oversubscribe"]["replicas"] == 1
    assert extra["oversubscribe"]["violations"] == 0
    assert extra["oversubscribe"]["img_per_s"] > 0
    duty = extra["duty_check"]
    assert duty["ratio"] == pytest.approx(duty["capped50_img_per_s"]
                                          / duty["uncapped_img_per_s"])
    # plain children on the CPU: no shim, so no device code charged
    assert extra["module_bytes"] == {"share": [0, 0], "oversubscribe": [0],
                                     "duty_check": [0, 0]}


def test_runner_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        trun.main(["--model", "lm"])
