#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``k8s_device_plugin_torch``).

Run from the repo root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. card: the card's name and power limit, as nvidia-smi reports them;
2. build: every kernel under ``k8s_device_plugin_torch/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, and its time beside the plain version's,
   a library call's (where one exists) and the card's bound;
4-6. the main path, with every launch counter set to 0 just before it:
   ResNet-50 bf16 at ai-benchmark case 1.1 (batch 50 @ 346) natively and
   as a 4-way share under the cooperative limiter with the duty probe
   sampling beside it (``bench.measure``), then LSTM case 5.1 inference
   through the runner; the counters are read just after;
7. correctness: the models on the card against the same weights on the
   CPU at small inputs;
then a ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.

Needs no network; builds into ``build/kernels`` (git-ignored).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s,
#: bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
#: ai-benchmark case 5.1: batch 100, 300 features, 1024 hidden
LSTM_CASE = (100, 300, 1024)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Time per call between CUDA events around ``iters`` back-to-back
    calls: device time plus any gap the host leaves between launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> tuple[float, str]:
    """Device time of one ``fn`` call: the CUDA kernels' own time summed
    over ``iters`` calls under torch.profiler (CUPTI), per call. Where the
    profiler reports no device time, CUDA events around the calls instead
    (then host launch gaps count too). Returns (ms, method); the method
    goes into the ``kernels`` line as ``timing``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us > 0:
        return total_us / 1e3 / iters, "profiler"
    return cuda_ms(fn, iters, warmup), "events"


def max_abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_close(what: str, got, want, tol: float) -> float:
    """max |got - want|; raises unless every element is within
    tol + tol * |want|."""
    import torch
    err = max_abs_err(got, want)
    if not torch.isfinite(got.float()).all() or not torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max abs err {err} over tol {tol}")
    return err


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit("card", nvidia_smi=line)
    return line


def phase_build() -> None:
    from k8s_device_plugin_torch import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    seconds = time.perf_counter() - t0
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.BUILD_DIR, "ptxas.log"), "w") as f:
        for name, log in reports.items():
            f.write(f"== {name}\n{log}\n")
    usage = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in reports.items()}
    emit("build", seconds=seconds, kernels=sorted(reports), ptxas=usage)


def phase_probe_kernel() -> dict:
    """K1 against its plain chain: elementwise at 16 steps, and at the
    calibrated steps by norm preservation (W is orthogonal, so
    ||x W^s|| = ||x||; fp32 rounding over s steps moves the ratio by far
    less than the 1e-3 allowed)."""
    import torch
    from k8s_device_plugin_torch.monitor import dutyprobe
    dev = torch.device("cuda")
    runner = dutyprobe.TorchProbe(device="cuda")
    runner()  # builds, calibrates steps to ~5 ms on this idle card
    x, w = runner._x, runner._w
    n, steps = runner.size, runner.steps
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    err16 = check_close(
        "probe_chain 16 steps", dutyprobe.probe_chain(x, w, 16),
        dutyprobe.probe_chain_reference(x, w, 16), 1e-4)
    y = dutyprobe.probe_chain(x, w, steps)
    ratio = (y.norm() / x.norm()).item()
    if not abs(ratio - 1.0) <= 1e-3:
        raise AssertionError(f"probe_chain {steps} steps: norm ratio {ratio}")
    err_cal = max_abs_err(y, dutyprobe.probe_chain_reference(x, w, steps))
    ms, timing = device_ms(lambda: dutyprobe.probe_chain(x, w, steps), 20)
    plain_ms, _ = device_ms(
        lambda: dutyprobe.probe_chain_reference(x, w, steps), 5)
    wall_ms = cuda_ms(lambda: dutyprobe.probe_chain(x, w, steps), 20)
    flops = 2 * n ** 3 * steps * grid  # every SM runs the whole chain
    result = {
        "name": "probe_chain", "route": "cuda",
        "source": "k8s_device_plugin_torch/csrc/probe_chain.cu",
        "replaces": "k8s_device_plugin_tpu/monitor/dutyprobe.py:70",
        "max_abs_err": err16, "ms": ms, "kernel_ms": ms, "timing": timing,
        "plain_ms": plain_ms, "bound_ms": flops / FP32_FLOPS * 1e3,
        "bound_by": "operations", "library_ms": None,
    }
    emit("kernel_probe_chain", size=n, steps=steps, grid=grid,
         max_abs_err_16_steps=err16, norm_ratio=ratio,
         max_abs_err_calibrated=err_cal, ms=ms, plain_ms=plain_ms,
         bound_ms=result["bound_ms"], timing=timing, wall_ms=wall_ms)
    return result


def _lstm_args(batch, features, hidden, dtype, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shapes = [(batch, features), (batch, hidden), (batch, hidden),
              (features, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,)]
    scales = [1.0, 0.5, 1.0, 0.05, 0.05, 0.1]
    return [torch.from_numpy((rng.standard_normal(s) * k).astype(np.float32)
                             ).to("cuda", dtype)
            for s, k in zip(shapes, scales)]


def phase_lstm_kernel() -> dict:
    """K2 against its plain version: case 5.1 in bf16 (tolerance 2e-2, as
    tests/test_pallas_ops.py) and a small fp32 shape (1e-5)."""
    import torch
    from k8s_device_plugin_torch.workloads import pallas_ops
    small = _lstm_args(8, 128, 128, torch.float32, seed=1)
    err32 = max(check_close(f"lstm_cell fp32 {name}", g, w, 1e-5)
                for name, g, w in zip(
                    "hc", pallas_ops.lstm_cell(*small),
                    pallas_ops.lstm_cell_reference(*small)))
    args = _lstm_args(*LSTM_CASE, torch.bfloat16)
    err = max(check_close(f"lstm_cell bf16 {name}", g, w, 2e-2)
              for name, g, w in zip("hc", pallas_ops.lstm_cell(*args),
                                    pallas_ops.lstm_cell_reference(*args)))
    x, h, c, wx, wh, b = args
    ms, timing = device_ms(lambda: pallas_ops.lstm_cell(*args), 200)
    plain_ms, _ = device_ms(lambda: pallas_ops.lstm_cell_reference(*args),
                            200)
    wall_ms = cuda_ms(lambda: pallas_ops.lstm_cell(*args), 200)
    # yardstick only: the same cell as one PyTorch call ([i|f|g|o] order,
    # weights transposed, b_hh = 0); the port never calls it
    wx_t, wh_t = wx.t().contiguous(), wh.t().contiguous()
    zero = torch.zeros_like(b)
    library_ms, _ = device_ms(
        lambda: torch.lstm_cell(x, (h, c), wx_t, wh_t, b, zero), 200)
    batch, features, hidden = LSTM_CASE
    nbytes = 2 * (batch * features + 2 * batch * hidden
                  + (features + hidden + 1) * 4 * hidden
                  + 2 * batch * hidden)
    flops = 2 * batch * (features + hidden) * 4 * hidden
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
    result = {
        "name": "lstm_cell", "route": "cuda",
        "source": "k8s_device_plugin_torch/csrc/lstm_cell.cu",
        "replaces": "k8s_device_plugin_tpu/workloads/pallas_ops.py:25",
        "max_abs_err": err, "ms": ms, "kernel_ms": ms, "timing": timing,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS
                     else "operations"),
        "library_ms": library_ms,
    }
    emit("kernel_lstm_cell", shape=LSTM_CASE, dtype="bfloat16",
         max_abs_err=err, max_abs_err_fp32_small=err32, ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_s * 1e3,
         bytes=nbytes, flops=flops, timing=timing, wall_ms=wall_ms)
    return result


def phase_main_path() -> dict:
    """ResNet-50 native + 4-way share with the probe, then LSTM case 5.1
    through the runner; returns each kernel's launches in this run."""
    from k8s_device_plugin_torch import bench
    from k8s_device_plugin_torch.monitor import dutyprobe
    from k8s_device_plugin_torch.workloads import pallas_ops, run

    counters = {"probe_chain": dutyprobe.probe_chain,
                "lstm_cell": pallas_ops.lstm_cell}
    for fn in counters.values():
        fn.launches = 0

    args = bench.parse_args([])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as workdir:
        result = bench.measure(args, workdir)
    extra = result["extra"]
    emit("resnet50_native", img_per_s=extra["native_img_per_s"],
         best_pass_img_per_s=extra["native_best_pass_img_per_s"],
         batch=extra["batch"], image_size=extra["image_size"],
         flops_per_img=extra["flops_per_img"], device=extra["device"])
    emit("resnet50_share", share_procs=extra["share_procs"],
         img_per_s=result["value"], vs_baseline=result["vs_baseline"],
         images=extra["images"], window_s=extra["window_s"],
         per_proc_img_per_s=extra["per_proc_img_per_s"],
         per_proc_best_pass_img_per_s=extra[
             "per_proc_best_pass_img_per_s"],
         hbm_cap_bytes=extra["hbm_cap_bytes"],
         hbm_used_bytes=extra["hbm_used_bytes"],
         violations=extra["hbm_limit_violations"],
         achieved_tflops=extra["achieved_tflops"], mfu=extra["mfu"],
         probe=extra["probe"], seconds=time.perf_counter() - t0)
    if extra["platform"] != "gpu" or extra["share_procs"] != 4:
        raise AssertionError(f"share ran as {extra['platform']} x "
                             f"{extra['share_procs']}")
    if extra["hbm_limit_violations"] != 0:
        raise AssertionError(f"{extra['hbm_limit_violations']} violations")
    if extra["probe"]["availability"] is None:
        raise AssertionError("the duty probe took no sample in the share")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--model", "lstm"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or not line["items_per_s"] > 0:
        raise AssertionError(f"lstm runner: rc={rc} {line}")
    emit("lstm_case_5_1", **line)

    launches = {name: fn.launches for name, fn in counters.items()}
    emit("main_path_launches", **launches)
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return launches


def phase_correctness() -> None:
    """The models on the card against the same weights on the CPU: fp32
    with TF32 off (ResNet to 1e-3 of its largest logit, the LSTM to 1e-4)
    and bf16 (to 5e-2 of the largest logit, the bound of the CPU parity
    test against Flax)."""
    import copy

    import numpy as np
    import torch
    from k8s_device_plugin_torch.workloads import harness
    from k8s_device_plugin_torch.workloads.lstm import LSTMClassifier
    from k8s_device_plugin_torch.workloads.resnet import resnet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    report = {}
    cases = [
        ("resnet50", lambda dt: resnet50(dtype=dt),
         rng.standard_normal((2, 64, 64, 3)), 1e-3),
        ("lstm", lambda dt: LSTMClassifier(LSTM_CASE[1], dtype=dt),
         rng.standard_normal((4, 8, LSTM_CASE[1])), 1e-4),
    ]
    for name, build, x, tol32 in cases:
        x = torch.from_numpy(x.astype(np.float32))
        ref = harness.init_model(build(torch.float32), 0, "cpu")
        want = harness.make_infer_fn(ref)(x)
        scale = want.abs().max().item()
        for dtype, tol in ((torch.float32, tol32), (torch.bfloat16, 5e-2)):
            model = build(dtype)
            model.load_state_dict(ref.state_dict())
            model = model.to("cuda").eval()
            got = harness.make_infer_fn(model)(x.to("cuda")).cpu()
            err = check_close(f"{name} {dtype}", got / scale, want / scale,
                              tol)
            report[f"{name}_{str(dtype).split('.')[1]}_rel_err"] = err
        report[f"{name}_max_logit"] = scale
    emit("correctness", **report)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import k8s_device_plugin_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(k8s_device_plugin_torch.__file__)))
    if pkg_root != HERE:
        print(f"chip_smoke: imported the port from {pkg_root}, not {HERE}",
              file=sys.stderr)
        return 2
    os.chdir(HERE)  # the bench's children import the port from here

    t0 = time.perf_counter()
    phase_card()
    phase_build()
    kernels = {"probe_chain": phase_probe_kernel(),
               "lstm_cell": phase_lstm_kernel()}
    launches = phase_main_path()
    phase_correctness()
    for name, k in kernels.items():
        k["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
