#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``k8s_device_plugin_torch``).

Run from the repo root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. card: the card's name and power limit, as nvidia-smi reports them;
2. build: every kernel under ``k8s_device_plugin_torch/csrc`` with nvcc,
   the host libraries (the enforcement shim ``libvtpu_cuda.so``, the
   region's primitives, the mock driver) with cc, and the check that
   holds ``csrc/cuda_driver_abi.h`` equal to the toolkit's ``cuda.h``;
   then the compile cache: the runner twice in fresh processes with
   ``VTPU_COMPILE_CACHE_DIR`` set, cold (builds K2 into the cache) and
   warm (builds nothing), and the key in the manifest;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (and, for the flash absorb, every mask
   kind on a carried state, an odd T and a head dim of 16, each check
   naming the route that ran), and its time beside the plain version's,
   a library call's (where one exists) and the card's bound; for the
   flash absorb also its mma.sync route and its rounded-P variant; K2's
   sequence route at case 5.1 x 1024 steps and at the runner's 100 x 64
   against a loop of the plain cell, and at case 5.1 against a loop of
   per-step K2 launches (``kernel_lstm_sequence``: ms a call, us a step,
   the plain loop's, the K2 loop's and cuDNN's LSTM's device time, and
   the call's bound); K3 at Trinity-Mini's shape ([1, 16384, 32, 128]
   bf16, K and V expanded from 4 heads, ``mma_sync``) under its window of
   2048 (``flash_window_kernel``) and causal, each against the plain
   absorb computed in query blocks and timed against its bound
   (``kernel_flash_window``);
4. gradients: the flash absorb's ``autograd.Function`` (K3 forward,
   recompute backward) against dense attention's gradients, in fp32, and
   in bf16 at the LM's train chunking and at the MoE LM's whole-sequence
   absorbs, with forward and forward + backward times beside dense
   attention's and SDPA's; the LSTM's gradients through K2 against the
   plain cell's at case 5.2;
4b. enforcement (``enforcement_card``): the shim on the card, in fresh
   processes under it with a 5 GiB cap: 512 MiB tensors until it refuses
   one (``used`` = reserve + context + device code), the same past the
   cap under ``VTPU_OVERSUBSCRIBE=1``, a K2 launch loop at core limit 50
   against 0 (the ratio in the duty band), K1, K2 and K3 under it against
   their plain versions, K2's sequence route charged as one launch of its
   own length (``enforcement_sequence``), the kill switch, and the
   module-memory charge
   (``enforcement_module``): the loads the shim saw and the bytes it
   charged by library, at each point of the main child and after a cuBLAS
   product beside cuBLAS's own allocations, against the free bytes the
   card lost under ``CUDA_MODULE_LOADING=EAGER``, and K3's load refused
   at a cap just above what its child holds; every line with the card's
   name and power limit;
5-12. the main paths, each with every launch counter set to 0 just before
   it and read just after: ResNet-50 bf16 at ai-benchmark case 1.1
   (batch 50 @ 346) natively and as a 4-way share under the enforcement
   shim with the duty probe sampling beside it (each child's device code
   charged, in every bench phase's line), then the bench's
   oversubscribe phase (10 replicas at 8 @ 64 past a 64 MiB cap under
   ``VTPU_OVERSUBSCRIBE=1``: spill above 0, no violation) and its duty
   check (case 1.1 at core limit 0 and 50: the ratio in [0.35, 0.65]),
   all wrapped (``bench.measure``), and the share once more under the
   cooperative limiter, beside it;
   LSTM case 5.1 inference through the runner (one launch of K2's
   sequence route a call); the long-context LM
   (``LM_CONFIG``, batch 8 x 2048, bf16) through the runner in
   ``--mode infer`` (attention through the flash absorb) and in
   ``--mode decode`` (prompt 2048, 32 tokens a call); then ``--mode
   train``: the LM (batch 4 x 2048, 12 flash absorbs a step), ResNet-50
   at case 1.2 (batch 20 @ 346), ResNet-152 at case 2.2 (batch 10 @ 256)
   and the LSTM at case 5.2 (batch 10, 64 cell launches a step); then the
   Switch-MoE LM (8 experts, 1024-token routing blocks) in ``--mode
   infer`` (8 x 2048: one whole-sequence K3 absorb a layer), ``train`` (4
   x 2048, the same) and ``decode`` (no port kernel), and VGG-16 (cases
   3.1, 3.2) and DeepLab-v3 (case 4.1, and batch 1 @ 512 to train) in
   ``--mode infer`` and ``train`` (no port kernel: cuDNN convolutions);
   then ``--multichip`` at world 1 over NCCL (``multichip_card``): ResNet-50
   and the LM in ``--mode infer`` and ``train`` through the runner, each
   against the same path without a mesh, and the ring attention with
   ``use_flash`` through K3 at the LM's shape, forward and gradients
   against the ring's plain absorb (one card cannot hold a multi-rank NCCL
   group: the multi-rank legs are checked on CPU ranks in the tests);
   then ``moe-lm --multichip`` in ``--mode infer`` (8 x 2048) and
   ``train`` (4 x 2049) at full width on a (1, 1) (dp, sp) mesh
   (``multichip_moe``), each against the oracle with the mesh's block
   boundaries (``moe_lm_forward`` / ``moe_lm_loss`` without a mesh,
   ``shard_shape=(1, 1)``), the logits on the positions routed alike and
   in fp32 too, and the same forward with ``use_flash`` (K3 in the ring,
   one launch a layer); the pipeline's loss and gradients at world 1
   against its sequential reference (``pipeline_card``); and a checkpoint
   of ResNet-50's train state at case 1.2 under ``shard_train_step``,
   saved, restored into a fresh model and resumed, bit-equal and on the
   same losses, with the bytes and seconds it took
   (``checkpoint_card``);
13. the LM's forward, decode step and train step, a train step of
   ResNet-50 (case 1.2) and of the LSTM (case 5.2), and the MoE LM's
   forward and train step, under torch.profiler: device time by kernel
   family and the device's idle share; then LFM2-8B-A1B at its published
   widths (``lfm2_moe``), as the benchmark's tenant builds and serves it
   (4 prompts of 4096 embeddings): K3 at that shape against the plain
   absorb, 18 short convs, 22 grouped expert applies, 6 K3 absorbs and
   24 K6 passes a forward (else it fails), K3 on its ``wgmma`` route, the
   forward's profile and most loaded expert, its logits bit-equal with
   the SwiGLUs forced through the ATen chain, and one expert layer's
   grouped products against the plain ones on the CPU on the same routed
   tokens; then Trinity-Mini (``afmoe``) as its cell's tenant builds
   and serves it (rank 0 of 4-way expert parallelism, one prompt of
   16,384 embeddings): 24 windowed K3 absorbs, 8 causal ones, 30 grouped
   expert applies and 62 K6 passes a forward (else it fails), the
   windowed launches as ``tc::flash_window_kernel<128>`` and the causal
   ones as ``tc::flash_kernel<128>`` in the trace, and the forward's
   profile;
14. correctness: the models on the card against the same weights on the
   CPU at small inputs (the MoE LM with its count of routing decisions
   that differ), greedy decoding of the LM and the MoE LM on the card
   token for token against their from-scratch recompute, and one train
   step of the LM, the ResNet, the LSTM, the MoE LM, VGG-16 and DeepLab-v3
   on the card against the same step on the CPU;
then a ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.

Needs no network; builds into ``build/kernels`` (git-ignored).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
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
#: case 5.1's time steps (the benchmark's sequence; the runner takes 64)
LSTM_CASE_STEPS = 1024
#: ResNet-V2-50's stages at case 1.1 (batch 50 @ 346: 87 x 87 after the
#: root and the pool), (width, side): ``bn_relu`` runs at [50, width, side,
#: side] (bn1, bn2; the stem's preact at stage 1's), ``add_bn_relu`` at
#: four times the width. Stage 1's are each pass's largest input.
RESNET_STAGES = ((64, 87), (128, 44), (256, 22), (512, 11))
#: K6's shapes in LFM2-8B-A1B's cell (4 x 4096 tokens), (rows, hidden,
#: gated): an MoE layer's 65,536 token-expert pairs at 1792 with their
#: gates (22 a forward), a dense layer's 16,384 tokens at 7168 (2)
SWIGLU_SHAPES = {"moe": (65536, 1792, True), "dense": (16384, 7168, False)}
#: steps of each train path through the runner (after its 2 warm-up calls)
TRAIN_STEPS = {"lm": 3, "resnet50": 10, "resnet152": 5, "lstm": 5,
               "moe-lm": 3, "vgg16": 5, "deeplab": 3}
#: calls per timed round of the MoE LM and the segmentation and VGG paths'
#: inference (after 2 warm-up calls)
INFER_STEPS = {"moe-lm": 5, "vgg16": 10, "deeplab": 5, "lstm": 50}


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


@contextlib.contextmanager
def no_tf32():
    """fp32 products in full fp32 (a parity claim), restored after."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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


def err_of_largest(what: str, got, want, bound: float) -> float:
    """max |got - want| over max |want|; raises above ``bound`` or on a
    value that is not finite."""
    import torch
    err = max_abs_err(got, want) / want.float().abs().max().item()
    if not (torch.isfinite(got.float()).all() and err <= bound):
        raise AssertionError(f"{what}: {err} of the largest, bound {bound}")
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
    """Every kernel with nvcc, the host libraries (the enforcement shim, the
    region's primitives, the mock driver) with cc, and the check that
    holds ``csrc/cuda_driver_abi.h`` equal to the toolkit's ``cuda.h``."""
    from k8s_device_plugin_torch import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    hosts = {name: os.path.basename(_build.host_library(name))
             for name in _build.HOST_LIBRARIES}
    abi_header = _build.check_cuda_abi()
    seconds = time.perf_counter() - t0
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.BUILD_DIR, "ptxas.log"), "w") as f:
        for name, log in reports.items():
            f.write(f"== {name}\n{log}\n")
    usage = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "warning" in ln.lower()]
             for name, log in reports.items()}
    emit("build", seconds=seconds, kernels=sorted(reports), ptxas=usage,
         host_libraries=hosts, cuda_abi_checked_against=abi_header)


def _libraries(cache_dir: str) -> dict:
    """{library file: (inode, mtime)} under the cache's kernel dir."""
    kernels = os.path.join(cache_dir, "kernels")
    if not os.path.isdir(kernels):
        return {}
    return {f: (os.stat(os.path.join(kernels, f)).st_ino,
                os.stat(os.path.join(kernels, f)).st_mtime_ns)
            for f in os.listdir(kernels) if f.endswith(".so")}


def phase_compile_cache() -> None:
    """The compile-cache contract on the card: the runner twice, each in a
    fresh process (``--model lstm --steps 2``), with
    ``VTPU_COMPILE_CACHE_DIR`` at a fresh directory and
    ``VTPU_COMPILE_CACHE_KEY`` set. The first (cold) must build K2 into
    the cache, the second (warm) must build nothing and report a smaller
    ``compile_s``; the manifest must hold the key afterwards."""
    from k8s_device_plugin_torch.api import COMPILE_CACHE_MANIFEST
    key = "chip-smoke-lstm"
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cache-") as cache:
        env = dict(os.environ, VTPU_COMPILE_CACHE_DIR=cache,
                   VTPU_COMPILE_CACHE_KEY=key)
        for label in ("cold", "warm"):
            before = _libraries(cache)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "k8s_device_plugin_torch.workloads.run",
                 "--model", "lstm", "--steps", "2"], cwd=HERE, env=env,
                capture_output=True, text=True, timeout=600)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"{label} runner rc={proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            after = _libraries(cache)
            runs.append({"run": label, "compile_s": line["compile_s"],
                         "warmup_step_s": line["warmup_step_s"],
                         "items_per_s": line["items_per_s"],
                         "seconds": seconds,
                         "built": sorted(f for f in after
                                         if after[f] != before.get(f))})
        with open(os.path.join(cache, COMPILE_CACHE_MANIFEST)) as f:
            keys = sorted(json.load(f)["keys"])
    cold, warm = runs
    emit("compile_cache", runs=runs, manifest_keys=keys)
    if not any(f.startswith("liblstm_cell-") for f in cold["built"]):
        raise AssertionError(f"the cold run built {cold['built']}, not K2")
    if warm["built"]:
        raise AssertionError(f"the warm run built {warm['built']}")
    if keys != [key]:
        raise AssertionError(f"manifest keys {keys}")
    if not warm["compile_s"] < cold["compile_s"]:
        raise AssertionError(f"warm compile_s {warm['compile_s']} >= cold "
                             f"{cold['compile_s']}")


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
    tests/test_pallas_ops.py; the ring route: cp.async ring, wgmma, block
    pairs splitting K) and a small fp32 shape (1e-5); its time beside
    torch.lstm_cell's and the bound."""
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
        "kernel_route": pallas_ops.cell_route(x, h, wx, wh),
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
         route=result["kernel_route"], max_abs_err=err,
         max_abs_err_fp32_small=err32, ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, ms_over_library=ms / library_ms,
         share_of_bound=bound_s * 1e3 / ms, bound_ms=bound_s * 1e3,
         bytes=nbytes, flops=flops, timing=timing, wall_ms=wall_ms)
    return result


def sequence_args(batch, steps, device="cuda", seed=0,
                  features=LSTM_CASE[1], hidden=LSTM_CASE[2]):
    """K2's sequence route's inputs in bf16 on ``device``: xs [T, B, F],
    h0, c0, and the cell's weights at the classifier's scale (wh about
    orthogonal in size), so 1024 steps stay in range. The card tests take
    the same inputs."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def t(shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(device,
                                                            torch.bfloat16)
    return (t((steps, batch, features), 1.0), t((batch, hidden), 0.5),
            t((batch, hidden), 1.0), t((features, 4 * hidden), 0.03),
            t((hidden, 4 * hidden), hidden ** -0.5 / 2), t((4 * hidden,), 0.1))


def _plain_sequence(xs, h0, c0, wx, wh, b):
    """The plain version of K2's sequence route on the card's tensors: a
    loop of ``lstm_cell_reference`` (fp32 products, h and c rounded to
    bf16 each step)."""
    from k8s_device_plugin_torch.workloads import pallas_ops
    h, c = h0, c0
    for x_t in xs:
        h, c = pallas_ops.lstm_cell_reference(x_t, h, c, wx, wh, b)
    return h, c


def phase_lstm_sequence_kernel() -> dict:
    """K2's sequence route against its plain version, a loop of
    ``lstm_cell_reference`` on the same card tensors (h_T and c_T within
    2e-2 of their largest magnitude, the bf16 cell's bound), at case 5.1 x
    1024 steps and at the runner's 100 x 64; at case 5.1 also against a
    loop of 1024 per-step K2 launches. Its time a call and a step beside
    the plain loop's (``plain_ms``), the per-step K2 loop's, cuDNN's
    multi-step LSTM's (``library_ms``: the same cell over the whole
    sequence in one PyTorch call, which the port never calls) and the
    call's bound (1024 steps' products at the bf16 peak: the weights are
    read once a call)."""
    import torch
    from k8s_device_plugin_torch.workloads import pallas_ops
    batch, features, hidden = LSTM_CASE
    steps = LSTM_CASE_STEPS
    runner = sequence_args(batch, 64, seed=7)
    args = sequence_args(batch, steps, seed=5)
    xs, h0, c0, wx, wh, b = args
    if not pallas_ops.sequence_route(*args):
        raise AssertionError("lstm_sequence: no sequence route at case 5.1")

    def k2_loop():
        h, c = h0, c0
        for x_t in xs:
            h, c = pallas_ops.lstm_cell(x_t, h, c, wx, wh, b)
        return h, c

    # yardstick only: cuDNN's LSTM over the whole sequence ([i|f|g|o]
    # order, weights transposed, b_hh = 0)
    library = torch.nn.LSTM(features, hidden).to("cuda", torch.bfloat16)
    with torch.no_grad():
        for name, w in (("weight_ih_l0", wx.t()), ("weight_hh_l0", wh.t()),
                        ("bias_ih_l0", b), ("bias_hh_l0", torch.zeros_like(b))):
            getattr(library, name).copy_(w)

    def cudnn():
        _, (h, c) = library(xs, (h0[None], c0[None]))
        return h[0], c[0]
    with torch.inference_mode():
        err64 = max(err_of_largest(f"lstm_sequence 100 x 64 {name}", g, w,
                                   2e-2)
                    for name, g, w in zip("hc",
                                          pallas_ops.lstm_sequence(*runner),
                                          _plain_sequence(*runner)))
        got = pallas_ops.lstm_sequence(*args)
        err = max(err_of_largest(f"lstm_sequence {name}", g, w, 2e-2)
                  for name, g, w in zip("hc", got, _plain_sequence(*args)))
        err_k2 = max(err_of_largest(f"lstm_sequence vs K2 {name}", g, w,
                                    2e-2)
                     for name, g, w in zip("hc", got, k2_loop()))
        library_err = max(max_abs_err(g, w) / w.float().abs().max().item()
                          for g, w in zip(cudnn(), _plain_sequence(*args)))
        padded = (pallas_ops._padded(xs)[0], *args[1:])
        ms, timing = device_ms(lambda: pallas_ops.lstm_sequence(*padded), 20)
        plain_ms, _ = device_ms(lambda: _plain_sequence(*args), 3)
        loop_ms, _ = device_ms(k2_loop, 3)
        library_ms, _ = device_ms(cudnn, 10)
        wall_ms = cuda_ms(lambda: pallas_ops.lstm_sequence(*padded), 20)
    flops = steps * 2 * batch * (features + hidden) * 4 * hidden
    nbytes = 2 * (steps * batch * features + (features + hidden + 1) * 4
                  * hidden + 4 * batch * hidden)
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
    result = {
        "name": "lstm_sequence", "route": "cuda",
        "kernel_route": "sequence",
        "source": "k8s_device_plugin_torch/csrc/lstm_cell.cu",
        "replaces": "k8s_device_plugin_tpu/workloads/pallas_ops.py:25 "
                    "(a loop of its calls)",
        "max_abs_err": err, "ms": ms, "kernel_ms": ms, "timing": timing,
        "plain_ms": plain_ms, "per_step_loop_ms": loop_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / BF16_FLOPS else "operations"),
        "library_ms": library_ms,
    }
    emit("kernel_lstm_sequence", shape=[steps, *LSTM_CASE], dtype="bfloat16",
         err_of_largest=err, err_of_largest_100x64=err64,
         err_of_largest_vs_per_step=err_k2, library_err_of_largest=library_err,
         ms=ms, us_per_step=ms * 1e3 / steps, plain_ms=plain_ms,
         per_step_loop_ms=loop_ms, loop_over_sequence=loop_ms / ms,
         library_ms=library_ms, ms_over_library=ms / library_ms,
         bound_ms=bound_s * 1e3, share_of_bound=bound_s * 1e3 / ms,
         bytes=nbytes, flops=flops, timing=timing, wall_ms=wall_ms)
    return result


def _bf16_ulps(got, want) -> int:
    """The largest distance in bf16 steps between two bf16 tensors (-0
    and +0 are one value)."""
    import torch

    def ordered(t):
        bits = t.view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return int((ordered(got) - ordered(want)).abs().max())


def phase_bn_relu_kernel() -> dict:
    """Both passes of ``csrc/bn_relu.cu`` against their plain versions
    (ATen's BatchNorm, ReLU and add) at each stage's shapes of
    :data:`RESNET_STAGES`, and the add without its sum kept: the largest
    distance in bf16 steps and the share of elements that differ, the
    time beside the plain version's and the bound by bytes, and the bytes
    a second moved. Returns the ``kernels`` entries of both at stage 1's
    shapes, their largest inputs on the path."""
    import torch
    from k8s_device_plugin_torch.workloads import bn_relu, resnet
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def act(c, side):
        return torch.randn((50, c, side, side), generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def norm(c):
        bn = resnet.BatchNorm(c)
        with torch.no_grad():
            for t, lo, hi in ((bn.running_mean, -0.3, 0.3),
                              (bn.running_var, 0.5, 1.5),
                              (bn.weight, 0.8, 1.2), (bn.bias, -0.3, 0.3)):
                t.uniform_(lo, hi)
        return bn.to(dev).eval()

    results = {}
    for stage, (width, side) in enumerate(RESNET_STAGES, 1):
        x, bn = act(width, side), norm(width)
        a, b, bn4 = act(4 * width, side), act(4 * width, side), norm(4 * width)
        cases = {
            "bn_relu": (x, lambda: (None, bn_relu.bn_relu(x, bn)),
                        lambda: (None, bn_relu.bn_relu_reference(x, bn)), 4),
            "add_bn_relu": (
                a, lambda: bn_relu.add_bn_relu(a, b, bn4),
                lambda: bn_relu.add_bn_relu_reference(a, b, bn4), 8),
            "add_bn_relu_no_sum": (
                a, lambda: bn_relu.add_bn_relu(a, b, bn4, keep_sum=False),
                lambda: bn_relu.add_bn_relu_reference(a, b, bn4, False), 6),
        }
        for name, (t, kernel, plain, per_elem) in cases.items():
            got, want = kernel(), plain()
            ulps = max(_bf16_ulps(u, v) for u, v in zip(got, want)
                       if u is not None)
            differ = sum(int((u != v).sum()) for u, v in zip(got, want)
                         if u is not None) / t.numel()
            if ulps > 1:
                raise AssertionError(f"{name} at stage {stage}: {ulps} bf16 "
                                     f"steps from plain")
            del got, want
            ms, timing = device_ms(kernel, 50)
            plain_ms, _ = device_ms(plain, 50)
            nbytes = per_elem * t.numel()
            line = {"max_ulps": ulps, "differ_share": differ, "ms": ms,
                    "kernel_ms": ms, "timing": timing, "plain_ms": plain_ms,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "bytes": nbytes,
                    "tb_per_s": nbytes / ms / 1e9}
            emit(f"kernel_{name}", stage=stage, shape=list(t.shape),
                 dtype="bfloat16", **line,
                 share_of_bound=line["bound_ms"] / ms)
            if stage == 1 and name in ("bn_relu", "add_bn_relu"):
                results[name] = {
                    "name": name, "route": "cuda",
                    "source": "k8s_device_plugin_torch/csrc/bn_relu.cu",
                    "replaces": "none: ATen's BatchNorm, ReLU and add passes",
                    "shape": list(t.shape), **line}
        del x, a, b
    return results


def phase_swiglu_kernel() -> dict:
    """K6 (``csrc/swiglu.cu``) against its plain version, the ATen chain
    it replaces (the SiLU and two multiplies), at both of
    :data:`SWIGLU_SHAPES`: bit-equal (else it fails), the time beside the
    chain's and the bound by bytes (h13 read, a written, the gate read),
    and the bytes a second moved. Returns the ``kernels`` entry at the MoE
    shape, 22 of the 24 launches a forward."""
    import torch
    from k8s_device_plugin_torch.workloads import swiglu
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (rows, hidden, gated) in SWIGLU_SHAPES.items():
        h13 = (torch.randn(rows, 2 * hidden, generator=gen, device=dev)
               * 3).to(torch.bfloat16)
        g = torch.rand(rows, generator=gen, device=dev).to(
            torch.bfloat16) if gated else None

        def kernel():
            return swiglu.swiglu_gate(h13, g)

        def plain():
            return swiglu.swiglu_gate_reference(h13, g)
        got, want = kernel(), plain()
        if not torch.equal(got, want):
            raise AssertionError(
                f"swiglu_gate {name}: {int((got != want).sum())} elements "
                f"differ from the chain, {_bf16_ulps(got, want)} bf16 steps")
        del got, want
        ms, timing = device_ms(kernel, 50)
        plain_ms, _ = device_ms(plain, 50)
        nbytes = 3 * rows * hidden * 2 + (2 * rows if gated else 0)
        line = {"bit_equal": True, "ms": ms, "kernel_ms": ms,
                "timing": timing, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": nbytes,
                "tb_per_s": nbytes / ms / 1e9}
        emit("kernel_swiglu_gate", case=name, shape=[rows, 2 * hidden],
             gated=gated, dtype="bfloat16", **line,
             share_of_bound=line["bound_ms"] / ms)
        if name == "moe":
            results["swiglu_gate"] = {
                "name": "swiglu_gate", "route": "cuda",
                "source": "k8s_device_plugin_torch/csrc/swiglu.cu",
                "replaces": "none: ATen's SiLU and two multiplies",
                "shape": [rows, 2 * hidden], **line}
        del h13, g
    return results


def _flash_args(batch, tq, tk, heads, dim, dtype, seed, identity):
    """q, k, v in ``dtype`` on the card, and the identity state or a
    carried one that is not (m finite, l > 0)."""
    import numpy as np
    import torch
    from k8s_device_plugin_torch.workloads import flash
    rng = np.random.default_rng(seed)

    def t(shape, lo=None):
        a = (rng.uniform(lo, 2.0, shape) if lo is not None
             else rng.standard_normal(shape))
        return torch.from_numpy(a.astype(np.float32)).to("cuda")
    q, k, v = (t((batch, n, heads, dim)).to(dtype) for n in (tq, tk, tk))
    if identity:
        return (q, k, v, *flash.flash_state(q))
    return (q, k, v, t((batch, heads, tq)), t((batch, heads, tq), lo=0.5),
            t((batch, tq, heads, dim)))


def _absorb_checked(what, args, kind, tol) -> dict:
    """K3 against its plain version on the same inputs: kind 2 must pass
    the state through bit for bit; otherwise m, l and o within tol.
    Returns the route that ran and the max abs error."""
    import torch
    from k8s_device_plugin_torch.workloads import flash
    q, k, v, m, l, o = args
    route = flash.absorb_route(q.dtype, q.shape[-1], k.shape[1])
    got = flash.flash_absorb(q, k, v, kind, m, l, o)
    if kind == 2:
        if not all(torch.equal(g, w) for g, w in zip(got, (m, l, o))):
            raise AssertionError(f"{what}: kind 2 changed the state")
        return {"route": route, "max_abs_err": 0.0}
    want = flash._absorb_reference(q, k, v, kind, m, l, o,
                                   q.shape[-1] ** -0.5)
    return {"route": route,
            "max_abs_err": max(check_close(f"{what} {name}", g, w, tol)
                               for name, g, w in zip("mlo", got, want))}


def phase_flash_kernel() -> dict:
    """K3 against its plain version: fp32 at 2 x 128 x 2 heads x 64 on a
    carried state for each kind (tolerance 1e-5, as
    tests/test_attention.py), an odd T (24, 100) and D = 16 in both
    types, T = 1000 in bf16, and the LM case (batch 8 x 2048,
    8 heads of 64, bf16, causal, identity state; tolerance 2e-2, as the
    bf16 kernels of tests/test_pallas_ops.py) on m, o, l and the finalized
    output, on the wgmma route and on the mma.sync one. Every check names
    the route that ran. Times the wgmma route, its variant with P rounded
    to bf16 (measured, and its error reported, never used), the mma.sync
    route, K3 + finalize, the plain absorb and SDPA on the same q, k, v."""
    import torch
    import torch.nn.functional as F
    from k8s_device_plugin_torch.workloads import flash, run
    f32, bf16 = torch.float32, torch.bfloat16
    checks = {}
    for kind in (0, 1, 2):
        checks[f"fp32_kind{kind}"] = _absorb_checked(
            f"flash_absorb fp32 kind {kind}",
            _flash_args(2, 128, 128, 2, 64, f32, kind, False), kind, 1e-5)
    for dtype, tol, shapes in (
            (f32, 1e-5, ((24, 24, 64), (24, 24, 16), (100, 37, 16))),
            # T = 1000 wraps the wgmma route's K/V ring many times
            (bf16, 2e-2, ((24, 24, 64), (24, 24, 16), (100, 37, 16),
                          (1000, 1000, 64)))):
        for tq, tk, dim in shapes:
            for kind in (0, 1):
                name = f"{str(dtype)[6:]}_t{tq}x{tk}_d{dim}_kind{kind}"
                checks[name] = _absorb_checked(
                    f"flash_absorb {name}",
                    _flash_args(2, tq, tk, 3, dim, dtype, 7, False), kind,
                    tol)

    heads, width, _, _ = run.LM_CONFIG
    batch, _, seq = run.CASES["lm"]
    dim = width // heads
    q, k, v, m, l, o = _flash_args(batch, seq, seq, heads, dim, bf16, 11,
                                   True)
    want = flash._absorb_reference(q, k, v, 1, m, l, o, dim ** -0.5)
    want_out = flash.flash_finalize(*want, bf16)
    route = flash.absorb_route(q.dtype, dim, seq)

    def lm_errors(got, strict):
        def err(what, g, w):
            return (check_close(f"flash_absorb LM {what}", g, w, 2e-2)
                    if strict else max_abs_err(g, w))
        return {"m": err("m", got[0], want[0]), "l": err("l", got[1], want[1]),
                "o": err("o", got[2], want[2]),
                "finalized": err("finalized", flash.flash_finalize(*got, bf16),
                                 want_out)}
    lm = {route: lm_errors(flash.flash_absorb(q, k, v, 1, m, l, o), True),
          "mma_sync": lm_errors(flash._absorb_kernel(
              "mma_sync", q, k, v, 1, m, l, o), True),
          # the variant that rounds P to bf16: measured, never used
          "wgmma_round_p": lm_errors(flash._absorb_kernel(
              "wgmma_round_p", q, k, v, 1, m, l, o), False)}
    err = lm[route]["finalized"]
    del want

    ms, timing = device_ms(lambda: flash.flash_absorb(q, k, v, 1, m, l, o),
                           20)
    route_ms = {r: device_ms(lambda r=r: flash._absorb_kernel(
        r, q, k, v, 1, m, l, o), 20)[0]
        for r in ("mma_sync", "wgmma_round_p")}
    wall_ms = cuda_ms(lambda: flash.flash_absorb(q, k, v, 1, m, l, o), 20)
    with_finalize_ms, _ = device_ms(lambda: flash.flash_finalize(
        *flash.flash_absorb(q, k, v, 1, m, l, o), bf16), 20)
    plain_ms, _ = device_ms(lambda: flash._absorb_reference(
        q, k, v, 1, m, l, o, dim ** -0.5), 3)
    # yardstick only: the finalized causal attention as one PyTorch call
    # on the same q, k, v in its [B, H, T, D] layout; the port never calls it
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    library_kernels = [k["kernel"] for k in _profile(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        5)["top"]]
    library_err = max_abs_err(F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True).transpose(1, 2), want_out)

    elem = q.element_size()
    nbytes = (3 * q.numel() * elem          # q, k, v read once
              + 2 * 2 * m.numel() * 4       # m, l in and out
              + 2 * o.numel() * 4)          # o in and out, fp32
    pairs = seq * (seq + 1) // 2            # causal: row >= col
    flops = 4 * batch * heads * dim * pairs  # q.k^T and p.v
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    bound_ms = max(bytes_s, ops_s) * 1e3
    result = {
        "name": "flash_absorb", "route": "cuda",
        "source": "k8s_device_plugin_torch/csrc/flash_absorb.cu",
        "replaces": "k8s_device_plugin_tpu/workloads/flash.py:60",
        "max_abs_err": err, "ms": ms, "kernel_ms": ms, "timing": timing,
        "kernel_route": route, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "library_ms": library_ms,
    }
    emit("kernel_flash_absorb", shape=[batch, seq, heads, dim],
         dtype="bfloat16", kind=1, route=route, max_abs_err=err,
         lm_case_errors=lm, checks=checks, ms=ms, route_ms=route_ms,
         p_split_cost_ms=ms - route_ms["wgmma_round_p"],
         share_of_bound=bound_ms / ms, wall_ms=wall_ms,
         with_finalize_ms=with_finalize_ms, plain_ms=plain_ms,
         library_ms=library_ms, library_max_abs_err=library_err,
         library_kernels=library_kernels,
         bound_ms=bound_ms, bound_by=result["bound_by"],
         bytes=nbytes, flops=flops, timing=timing)
    return result


#: Trinity-Mini's configuration, which ``trinity-mini.solo`` serves
TRINITY_CONFIG = "trinity-mini.ep4-prefill16k.json"


def _config(name: str) -> dict:
    """The benchmark's configuration ``name`` under ``vgpu_bench/configs``."""
    with open(os.path.join(HERE, "vgpu_bench", "configs", name)) as f:
        return json.load(f)


def _blocked_absorb(q, k, v, m, l, o, window: int, block: int = 512):
    """The plain absorb (:func:`flash.absorb_block_reference`) of a causal
    call under ``window`` (0 for none), ``block`` queries at a time over
    the keys they can see, as ``vgpu_bench/reference/afmoe.py`` computes
    attention: at T = 16,384 the whole [H, T, T] fp32 scores would take
    34 GB."""
    import torch
    from k8s_device_plugin_torch.workloads import flash
    t = q.shape[1]
    parts = []
    for q0 in range(0, t, block):
        q1 = min(q0 + block, t)
        k0 = max(0, q0 - window + 1) if window else 0
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(k0, q1, device=q.device)[None, :]
        allowed = cols <= rows
        if window:
            allowed &= rows - cols < window
        parts.append(flash.absorb_block_reference(
            q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], allowed, m[:, :, q0:q1],
            l[:, :, q0:q1], o[:, q0:q1], q.shape[-1] ** -0.5))
    return [torch.cat(ts, dim) for ts, dim in zip(zip(*parts), (2, 2, 1))]


def _launch_ms(fn, kernel: str, iters: int) -> tuple[float, int]:
    """Device ms of one launch of the kernel whose name holds ``kernel``,
    over ``iters`` calls of ``fn`` under torch.profiler, and the launches
    the trace kept. A mean over the launches kept, not a sum over the
    calls as :func:`device_ms` takes: events at the start of a profiled
    window can go missing (:func:`_profile`), and late in this script the
    sum read 3 of 5 launches of K3 at Trinity's shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kept = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in kept)
    if not count:
        raise AssertionError(f"the profiler kept no launch of {kernel}")
    return sum(e.self_device_time_total for e in kept) / 1e3 / count, count


def phase_flash_window_kernel() -> dict:
    """K3 at Trinity-Mini's shape, [1, 16384, 32, 128] bf16 with K and V
    expanded from 4 heads as ``afmoe.attention`` expands them, identity
    state, on its ``mma_sync`` route: under the window of 2048 (one
    ``flash_window_kernel`` launch, counted under ``flash_window``) and
    causal (one ``flash_kernel`` launch), each against the plain absorb
    computed in query blocks (:func:`_blocked_absorb`) on m, l, o and the
    finalized output (tolerance 2e-2, as the LM case), and each timed
    against its bound from ``vgpu_bench/counts/afmoe.py``'s
    ``kernel_cost`` (the larger of its bytes at 3.35 TB/s and its FLOP at
    989 TFLOP/s) by the mean of the launches traced (:func:`_launch_ms`).
    Returns the windowed launch's ``kernels`` entry."""
    import torch
    from k8s_device_plugin_torch import _build
    from k8s_device_plugin_torch.workloads import attention, flash
    from vgpu_bench.counts import afmoe as counts
    cfg = _config(TRINITY_CONFIG)
    batch, seq, _ = cfg["input_shape"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dim, window = cfg["head_dim"], cfg["sliding_window"]
    bf16 = torch.bfloat16
    q, k, v, m, l, o = _flash_args(batch, seq, seq, heads, dim, bf16, 23,
                                   True)
    k, v = (attention.expand_kv(t[:, :, :kv].contiguous(), heads)
            for t in (k, v))
    cost = counts.kernel_cost(cfg)
    lines = {}
    for name, w in (("flash_window", window), ("flash_absorb", 0)):
        route = flash.absorb_route(q.dtype, dim, seq, w)
        _build.launches.clear()
        got = flash.flash_absorb(q, k, v, 1, m, l, o, w)
        launched = {n: _build.launches[n]
                    for n in ("flash_window", "flash_absorb")}
        if launched != {n: int(n == name)
                        for n in ("flash_window", "flash_absorb")}:
            raise AssertionError(f"flash_absorb window {w}: launches "
                                 f"{launched}")
        want = _blocked_absorb(q, k, v, m, l, o, w)
        errs = {part: check_close(f"flash_absorb Trinity window {w} {part}",
                                  g, r, 2e-2)
                for part, g, r in zip("mlo", got, want)}
        errs["finalized"] = check_close(
            f"flash_absorb Trinity window {w} finalized",
            flash.flash_finalize(*got, bf16),
            flash.flash_finalize(*want, bf16), 2e-2)
        del got, want
        ms, traced = _launch_ms(
            lambda w=w: flash.flash_absorb(q, k, v, 1, m, l, o, w),
            "tc::flash_window_kernel<" if w else "tc::flash_kernel<", 5)
        plain_ms, _ = device_ms(
            lambda w=w: _blocked_absorb(q, k, v, m, l, o, w), 1, warmup=1)
        flops, nbytes = cost[name]
        bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        bound_ms = max(bytes_s, ops_s) * 1e3
        lines[name] = {
            "window": w, "route": route, "max_abs_err": errs, "ms": ms,
            "timing": "profiler", "launches_traced": traced,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "share_of_bound": bound_ms / ms, "flops": flops,
            "bytes": nbytes}
    emit("kernel_flash_window", shape=list(q.shape), dtype="bfloat16",
         kind=1, window=lines["flash_window"], causal=lines["flash_absorb"],
         window_over_causal_ms=lines["flash_window"]["ms"]
         / lines["flash_absorb"]["ms"])
    del q, k, v, m, l, o
    torch.cuda.empty_cache()
    line = lines["flash_window"]
    return {"name": "flash_window", "route": "cuda",
            "source": "k8s_device_plugin_torch/csrc/flash_absorb.cu",
            "replaces": "none: the JAX package's absorb takes no window",
            "max_abs_err": line["max_abs_err"]["finalized"],
            "ms": line["ms"], "kernel_ms": line["ms"],
            "timing": line["timing"], "kernel_route": line["route"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": None}


def _grads(fn, inputs, cotangent=None):
    """Gradients of ``fn(*inputs)`` in its inputs: of sum(sin(out)) in
    fp32, or against ``cotangent``."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    if cotangent is None:
        return torch.autograd.grad(torch.sin(out.float()).sum(), leaves)
    return torch.autograd.grad(out, leaves, cotangent)


def phase_flash_grad() -> dict:
    """The flash absorb's autograd.Function on the card: K3 forward and
    the recompute backward (the port of the JAX custom VJP). Gradients of
    sum(sin(flash_attention)) in q, k, v against dense attention's: fp32
    with TF32 off at 2 x 256, 4 heads of 64, whole-sequence and in 64-token
    chunks, causal and not (atol 1e-5, rtol 1e-4, as
    tests/test_attention.py); bf16 at 4 x 2048, 8 heads of 64, causal,
    at the LM's train chunking (seq_block 1024: 3 K3 launches) and at the
    MoE LM's whole-sequence absorb (seq_block None: 1 launch, its backward
    rebuilding one [4, 8, 2048, 2048] fp32 score block), each within 2e-2
    of the largest |grad|. Device times of one layer's attention at that
    shape, for each: the forward alone (K3 and the finalize) and forward +
    backward through the Function; then the same through dense attention,
    and SDPA's forward and forward + backward (a yardstick the port never
    calls)."""
    import torch
    import torch.nn.functional as F
    from k8s_device_plugin_torch import _build
    from k8s_device_plugin_torch.workloads import flash, run
    from k8s_device_plugin_torch.workloads.attention import \
        reference_attention
    fp32 = {}
    with no_tf32():
        q, k, v = _flash_args(2, 256, 256, 4, 64, torch.float32, 21,
                              True)[:3]
        for causal in (True, False):
            for sb in (None, 64):
                got = _grads(lambda *a: flash.flash_attention(
                    *a, causal=causal, seq_block=sb), (q, k, v))
                want = _grads(lambda *a: reference_attention(
                    *a, causal=causal), (q, k, v))
                errs = []
                for name, g, w in zip("qkv", got, want):
                    if not torch.allclose(g, w, atol=1e-5, rtol=1e-4):
                        raise AssertionError(
                            f"flash grad fp32 d{name} causal={causal} "
                            f"seq_block={sb}: {max_abs_err(g, w)}")
                    errs.append(max_abs_err(g, w))
                fp32[f"causal{int(causal)}_block{sb}"] = max(errs)

    heads, width, _, _ = run.LM_CONFIG
    batch, seq = run.CASES["lm"][1], run.CASES["lm"][2]
    dim, block = width // heads, 1024
    q, k, v = _flash_args(batch, seq, seq, heads, dim, torch.bfloat16, 22,
                          True)[:3]
    want = _grads(reference_attention, (q, k, v))
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)
                      ).to("cuda", torch.bfloat16)
    # the LM's train chunking, then the MoE LM's whole-sequence absorbs
    # (moe_lm_loss passes no chunking: one [4, 8, 2048, 2048] fp32 score
    # block rebuilt per backward)
    by_block = {}
    for sb, absorbs in ((block, 3), (None, 1)):
        launches = _build.launches["flash_absorb"]
        got = _grads(lambda *a, sb=sb: flash.flash_attention(
            *a, seq_block=sb), (q, k, v))
        launches = _build.launches["flash_absorb"] - launches
        errs = {}
        for name, g, w in zip("qkv", got, want):
            scale = w.float().abs().max().item()
            errs[name] = max_abs_err(g, w) / scale
            if not errs[name] <= 2e-2:
                raise AssertionError(f"flash grad bf16 seq_block={sb} "
                                     f"d{name}: {errs[name]} of the largest "
                                     f"|grad|")
        del got
        if launches != absorbs:
            raise AssertionError(f"{launches} K3 launches for one layer's "
                                 f"attention at seq_block={sb}, not "
                                 f"{absorbs}")
        with torch.no_grad():
            fwd_ms, timing = device_ms(
                lambda sb=sb: flash.flash_attention(q, k, v, seq_block=sb),
                10)
        fwd_bwd_ms, _ = device_ms(lambda sb=sb: _grads(
            lambda *a: flash.flash_attention(*a, seq_block=sb), (q, k, v),
            cot), 5)
        by_block[sb] = {"err_of_largest": errs, "k3_launches": launches,
                        "fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms,
                        "backward_share": (fwd_bwd_ms - fwd_ms) / fwd_bwd_ms,
                        "timing": timing}
    del want

    dense_fwd_bwd_ms, _ = device_ms(
        lambda: _grads(reference_attention, (q, k, v), cot), 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    cot_t = cot.transpose(1, 2).contiguous()
    sdpa_fwd_bwd_ms, _ = device_ms(lambda: _grads(
        lambda *a: F.scaled_dot_product_attention(*a, is_causal=True),
        (qt, kt, vt), cot_t), 10)
    with torch.no_grad():
        sdpa_fwd_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 10)
    chunked = by_block[block]
    times = {"fwd_ms": chunked["fwd_ms"], "fwd_bwd_ms": chunked["fwd_bwd_ms"],
             "backward_share": chunked["backward_share"],
             "dense_fwd_bwd_ms": dense_fwd_bwd_ms,
             "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
             "timing": chunked["timing"]}
    emit("flash_grad", fp32_max_abs_err=fp32, bf16_shape=[batch, seq, heads,
                                                          dim],
         seq_block=block, bf16_err_of_largest=chunked["err_of_largest"],
         k3_launches_per_fwd_bwd=chunked["k3_launches"],
         whole_sequence=by_block[None], **times)
    return {**times, "whole_sequence": by_block[None]}


def phase_lstm_grad() -> dict:
    """The LSTM's gradients through K2 (the Function's recompute backward)
    against the same model through the plain cell, at case 5.2 (batch 10,
    300 features, 1024 hidden, 64 steps): fp32 with TF32 off within 1e-4
    and bf16 within 5e-2 (the bf16 logits' bound of ``phase_correctness``)
    of each parameter's largest |grad|."""
    import numpy as np
    import torch
    from k8s_device_plugin_torch import _build
    from k8s_device_plugin_torch.workloads import harness, pallas_ops, run
    from k8s_device_plugin_torch.workloads.lstm import LSTMClassifier
    _, batch, features = run.CASES["lstm"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (batch, run.LSTM_STEPS, features)).astype(np.float32)).to("cuda")
    labels = torch.randint(0, 2, (batch,),
                           generator=torch.Generator().manual_seed(5)
                           ).to("cuda")
    report = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        model = harness.init_model(LSTMClassifier(features, dtype=dtype), 0,
                                   "cuda")
        grads = []
        for plain in (False, True):
            if plain:  # the same weights through the plain cell
                model.cell.forward = lambda h, c, x_t: \
                    pallas_ops.lstm_cell_reference(
                        x_t, h, c, model.cell.wx, model.cell.wh,
                        model.cell.b)
            launches = _build.launches["lstm_cell"]
            with no_tf32():
                model.zero_grad(set_to_none=True)
                harness.cross_entropy(model(x), labels).backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
            if not plain and (_build.launches["lstm_cell"] - launches
                              != run.LSTM_STEPS):
                raise AssertionError("the LSTM did not run K2 every step")
        errs = {}
        for name, want in grads[1].items():
            got = grads[0][name]
            if got is None:
                raise AssertionError(f"lstm {dtype}: {name} got no grad")
            scale = want.float().abs().max().item()
            errs[name] = max_abs_err(got, want) / scale
            if not (scale > 0 and errs[name] <= tol):
                raise AssertionError(f"lstm grad {dtype} {name}: "
                                     f"{errs[name]} of {scale}")
        report[str(dtype).split(".")[1]] = errs
    emit("lstm_grad", shape=[batch, run.LSTM_STEPS, features, 1024],
         err_of_largest=report)
    return report


#: the enforcement phase's slice: a 5 GiB cap, filled in 512 MiB tensors;
#: it also holds K3's plain version at the LM case (3 GiB of fp32 scores)
#: beside the context and the device code the child loads
ENFORCE_CAP = 5 << 30
ENFORCE_CHUNK = 512 << 20
#: how far the shim's charge may be from the allocator's reserve plus the
#: context and the device code: one segment of PyTorch's medium pool
#: (kLargeBuffer, 20 MiB)
ENFORCE_SLACK = 20 << 20
#: the refused load: the cap is set this far above what the child holds,
#: below the charge of K3's library
REFUSE_MARGIN = 4 << 10
#: the EAGER child's cap, above the card's memory: cuMemGetInfo then
#: reports the card's free bytes, not the slice's
EAGER_CAP = 1 << 40
#: the EAGER windows large enough to read against the card's free bytes
#: (the driver places device code in pages of its own, so a window of a
#: few hundred KB can lose no free bytes at all) must agree within 2x
EAGER_BAND = (0.5, 2.0)
#: seconds each leg of the K2 duty loop is timed
K2_LOOP_S = 1.0
#: calls of K2's sequence route read one by one under the shim
SEQUENCE_CHARGE_CALLS = 6


def _kill_switch_child(cap: int) -> dict:
    """Under ``VTPU_DISABLE_CONTROL=true``: the driver reached through
    ctypes (dlsym on libcuda.so.1, which the shim passes through), the
    card's whole memory, and an allocation past the cap admitted."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    ctx, ptr = ctypes.c_void_p(), ctypes.c_uint64()
    free, total = ctypes.c_size_t(), ctypes.c_size_t()
    rcs = [cuda.cuInit(0),
           cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), 0),
           cuda.cuCtxSetCurrent(ctx),
           cuda.cuMemGetInfo_v2(ctypes.byref(free), ctypes.byref(total)),
           cuda.cuMemAlloc_v2(ctypes.byref(ptr),
                              ctypes.c_size_t(cap + ENFORCE_CHUNK))]
    cache = os.path.join(os.environ["VTPU_DEVICE_MEMORY_SHARED_CACHE"],
                         "vtpu.cache")
    return {"rcs": rcs, "total": total.value, "free": free.value,
            "allocated": cap + ENFORCE_CHUNK,
            "region_exists": os.path.exists(cache)}


def _own_kinds(region) -> list:
    """This process's usage on ordinal 0 by kind, as the shim charged it
    (indexed by ``KIND_CONTEXT``, ``KIND_MODULE``, ``KIND_BUFFER``)."""
    slot = next(p for p in region.active_procs() if p.pid == os.getpid())
    kinds = [int(k) for k in slot.used[0].kinds]
    del slot  # no view of the mapping outlives the call
    return kinds


def _fill(region, dev, limit: int) -> dict:
    """512 MiB tensors until the shim refuses one or ``limit`` are held:
    the allocator's reserve, the region's usage and the device code
    charged after each."""
    import torch
    from k8s_device_plugin_torch import bench
    from k8s_device_plugin_torch.shm.region import KIND_MODULE
    cap = int(os.environ["VTPU_DEVICE_MEMORY_LIMIT_0"])
    tensors, steps, refused = [], [], None  # freed on return
    while len(tensors) < limit:
        try:
            tensors.append(torch.empty(ENFORCE_CHUNK, dtype=torch.uint8,
                                       device=dev))
        except torch.OutOfMemoryError:
            refused = len(tensors)
            break
        steps.append((torch.cuda.memory_reserved(dev),
                      region.device_used(0), _own_kinds(region)[KIND_MODULE]))
    used, spill, violations = bench.shim_accounting(region, cap, dev)
    return {"refused_at": refused, "allocations": len(tensors),
            "reserved": [r for r, _, _ in steps],
            "used": [u for _, u, _ in steps],
            "module": [m for _, _, m in steps],
            "reserved_at_end": torch.cuda.memory_reserved(dev),
            "used_at_end": region.device_used(0),
            "max_reserved": torch.cuda.max_memory_reserved(dev),
            "mem_get_info": list(torch.cuda.mem_get_info(dev)),
            "spill": spill, "violations": violations, "final_used": used}


def _k2_loop(region) -> dict:
    """K2 at case 5.1 against its plain version under the shim, then its
    own entry on preallocated outputs in a loop for ``K2_LOOP_S``: the loop
    launches faster than the card runs the kernel, so uncapped it is bound
    by the card, and a core limit's share shows in its rate. Under a
    limit, the bucket's burst is spent first."""
    import torch
    from k8s_device_plugin_torch import bench
    from k8s_device_plugin_torch.workloads import pallas_ops
    args = _lstm_args(*LSTM_CASE, torch.bfloat16)
    x, h, c, wx, wh, b = args
    err = max(check_close(f"lstm_cell under the shim {name}", g, w, 2e-2)
              for name, g, w in zip("hc", pallas_ops.lstm_cell(*args),
                                    pallas_ops.lstm_cell_reference(*args)))
    route = pallas_ops.cell_route(x, h, wx, wh)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    batch, features, hidden = LSTM_CASE
    call = [pallas_ops.ROUTES[route], x.data_ptr(), h.data_ptr(),
            c.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), batch, features, hidden]

    def launch():
        pallas_ops.LSTM_CELL(x, *call, label="lstm_cell loop")
    pct = region.data.sm_limit[0]
    drained = bench.drain_bucket(region, launch) if 0 < pct < 100 else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < K2_LOOP_S:
        for _ in range(20):
            launch()
        n += 20
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"route": route, "max_abs_err": err, "core_limit": pct,
            "drain_calls": drained,
            "tokens_after": region.data.duty_tokens_us[0], "launches": n,
            "seconds": seconds, "launches_per_s": n / seconds}


def _sequence_charged() -> dict:
    """K2's sequence route at case 5.1 x 1024 steps under the shim, one
    call at a time: the launches the shim counted for each and the cost
    it charged each (``shm/counters.py``), beside each call's device time
    (CUDA events). The shim times one launch at a time and charges a
    function at the mean of its timed runs, so after the first calls a
    long launch is charged about its own length."""
    import torch
    from k8s_device_plugin_torch.shm import counters
    from k8s_device_plugin_torch.workloads import pallas_ops
    xs, *rest = sequence_args(LSTM_CASE[0], LSTM_CASE_STEPS, seed=6)
    args = (pallas_ops._padded(xs)[0], *rest)
    calls = []
    with torch.inference_mode():
        pallas_ops.lstm_sequence(*args)  # the barrier word, the build
        torch.cuda.synchronize()
        for _ in range(SEQUENCE_CHARGE_CALLS):
            before = counters.counters(0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pallas_ops.lstm_sequence(*args)
            end.record()
            end.synchronize()
            after = counters.counters(0)
            calls.append({"us": start.elapsed_time(end) * 1e3,
                          "launches": after["launches"] - before["launches"],
                          "charged_us": (after["charged_us"]
                                         - before["charged_us"])})
    return {"calls": calls}


def _kernel_inputs(dev) -> tuple:
    """K1's operands, K3's inputs at the LM case and K2's at case 5.1, on
    the card: ``({name: a launch of it}, K1's operands, K3's inputs)``."""
    import numpy as np
    import torch
    from k8s_device_plugin_torch.monitor import dutyprobe
    from k8s_device_plugin_torch.workloads import flash, pallas_ops, run
    xw = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in dutyprobe.probe_operands(128)]
    heads, width, _, _ = run.LM_CONFIG
    batch, _, seq = run.CASES["lm"]
    q, k, v, m, l, o = _flash_args(batch, seq, seq, heads, width // heads,
                                   torch.bfloat16, 11, True)
    cell = _lstm_args(*LSTM_CASE, torch.bfloat16)
    return ({"probe_chain": lambda: dutyprobe.probe_chain(*xw, 16),
             "flash_absorb": lambda: flash.flash_absorb(q, k, v, 1, m, l, o),
             "lstm_cell": lambda: pallas_ops.lstm_cell(*cell)},
            xw, (q, k, v, m, l, o))


def _cublas_product(region, dev) -> dict:
    """One bf16 product through cuBLAS under the shim, then what the
    region holds beside PyTorch's reserve: usage outside the reserve and
    the context is device code (module) or an allocation of cuBLAS's
    own (which the trace names)."""
    import torch
    from k8s_device_plugin_torch.shm.region import (KIND_BUFFER,
                                                    KIND_CONTEXT,
                                                    KIND_MODULE)
    a = torch.randn(1024, 1024, device=dev, dtype=torch.bfloat16)
    (a @ a).sum().item()
    kinds = _own_kinds(region)
    return {"used": region.device_used(0),
            "reserved": torch.cuda.memory_reserved(dev),
            "context": kinds[KIND_CONTEXT], "module": kinds[KIND_MODULE],
            "buffer": kinds[KIND_BUFFER]}


def _eager_windows(region, dev) -> dict:
    """Under ``CUDA_MODULE_LOADING=EAGER`` (and a cap above the card, so
    cuMemGetInfo reports the card's free bytes): K1's, K3's and K2's
    first launches, each loading its library, and one cuBLAS product, as
    windows of the device code charged against the free bytes the card
    lost, less what the shim charged in the window as allocations and
    context (the kernels' outputs, cuBLAS's workspace)."""
    import torch
    from k8s_device_plugin_torch.shm.region import (KIND_BUFFER,
                                                    KIND_CONTEXT,
                                                    KIND_MODULE)
    a = torch.randn(1024, 1024, device=dev, dtype=torch.bfloat16)
    calls = dict(_kernel_inputs(dev)[0],
                 cublas=lambda: (a @ a).sum().item())
    windows = {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        free, before = torch.cuda.mem_get_info(dev)[0], _own_kinds(region)
        call()
        torch.cuda.synchronize()
        lost = free - torch.cuda.mem_get_info(dev)[0]
        after = _own_kinds(region)
        moved = [after[k] - before[k] for k in range(len(after))]
        windows[name] = {"charged": moved[KIND_MODULE], "free_lost": lost,
                         "lost_to_code": lost - moved[KIND_BUFFER]
                         - moved[KIND_CONTEXT]}
    return windows


def _refused_load(region, dev) -> dict:
    """K3's first launch with the slice's cap just above what this
    process holds (its context, the device code PyTorch loaded, K3's
    inputs, and its outputs' blocks cached beforehand): the shim refuses
    K3's library, and the launch raises through the kernel's wrapper.
    Then the cap is put back and K3 launched again."""
    import torch
    from k8s_device_plugin_torch.shm.region import KIND_MODULE
    from k8s_device_plugin_torch.workloads import flash
    q, k, v, m, l, o = _kernel_inputs(dev)[2]
    outs = [torch.empty_like(t) for t in (m, l, o)]
    del outs  # their blocks stay in PyTorch's cache for the launch
    before = _own_kinds(region)[KIND_MODULE]
    with region.locked():
        region.data.limit[0] = region.device_used(0) + REFUSE_MARGIN
    error = None
    try:
        flash.flash_absorb(q, k, v, 1, m, l, o)
        torch.cuda.synchronize()
    except RuntimeError as e:
        error = str(e)
    after = _own_kinds(region)[KIND_MODULE]
    with region.locked():
        region.data.limit[0] = ENFORCE_CAP
    try:
        flash.flash_absorb(q, k, v, 1, m, l, o)
        torch.cuda.synchronize()
        retry = "launched"
    except RuntimeError as e:
        retry = str(e)
    return {"error": error, "margin": REFUSE_MARGIN,
            "module_before": before, "module_after": after,
            "retry_at_the_full_cap": retry}


def _enforcement_child(case: str) -> int:
    """One case of ``phase_enforcement_card``, in a process started with
    the shim preloaded and the VTPU_* contract set (``bench._child_env``);
    prints one JSON line. ``main``: 512 MiB tensors until the shim
    refuses one (before anything else is allocated), then, with them
    freed, K1, K3 and K2's first launches (each library's load charged),
    each kernel against its plain version, the K2 loop, and one cuBLAS
    product, with the device code charged at each point; ``capped``
    (under a core limit and ``VTPU_OVERSUBSCRIBE``): the K2 loop, then the
    tensors past the cap; ``eager`` (``CUDA_MODULE_LOADING=EAGER``): the
    device code charged against the free bytes the card lost;
    ``refuse``: K3's load refused; ``disabled``: the kill switch."""
    cap = int(os.environ["VTPU_DEVICE_MEMORY_LIMIT_0"])
    out = {"case": case}
    if case == "disabled":
        out.update(_kill_switch_child(cap))
        print(json.dumps(out), flush=True)
        return 0
    import torch
    from k8s_device_plugin_torch import bench
    from k8s_device_plugin_torch.monitor import dutyprobe
    from k8s_device_plugin_torch.shm.region import KIND_CONTEXT, KIND_MODULE
    dev = torch.device("cuda")
    region = bench.shim_region(cap, dev)
    kinds = _own_kinds(region)
    out["context_bytes"] = kinds[KIND_CONTEXT]
    module = out["module_bytes"] = {"start": kinds[KIND_MODULE]}
    if case == "main":
        out["fill"] = _fill(region, dev, 64)
        module["after_fill"] = _own_kinds(region)[KIND_MODULE]
        torch.cuda.empty_cache()
        # each kernel's first launch loads its library (K1's and K3's
        # static cudart): charged before any plain version runs, as those
        # load cuBLAS's code
        launches, xw, args = _kernel_inputs(dev)
        for name, launch in launches.items():
            launch()
            torch.cuda.synchronize()
            module[f"after_{name}"] = _own_kinds(region)[KIND_MODULE]
        out["probe_chain_err"] = check_close(
            "probe_chain under the shim", launches["probe_chain"](),
            dutyprobe.probe_chain_reference(*xw, 16), 1e-4)
        out["flash_absorb"] = {
            f"kind{kind}": _absorb_checked(
                f"flash_absorb under the shim kind {kind}", args, kind, 2e-2)
            for kind in (1, 2)}
        del xw, args, launches
        out["k2"] = _k2_loop(region)
        module["after_plain_versions"] = _own_kinds(region)[KIND_MODULE]
        out["cublas"] = _cublas_product(region, dev)
    elif case == "capped":
        out["k2"] = _k2_loop(region)
        out["sequence"] = _sequence_charged()
        out["fill"] = _fill(region, dev, ENFORCE_CAP // ENFORCE_CHUNK + 4)
    elif case == "eager":
        out["windows"] = _eager_windows(region, dev)
    elif case == "refuse":
        out["refusal"] = _refused_load(region, dev)
    else:
        raise SystemExit(f"no enforcement case {case}")
    region.close()
    print(json.dumps(out), flush=True)
    return 0


_LOAD_LINE = re.compile(r"vtpu-dbg: load (\S+) (\d+) (\S+) sm_\d+ dev \d+ "
                        r"sm_\d+ (.*)$")
_ALLOC_LINE = re.compile(r"vtpu-dbg: alloc (\d+) dev \d+ from (.*)$")
_RETAIN_LINE = re.compile(r"vtpu-dbg: retain dev \d+: free bytes dropped "
                          r"(\d+), libraries (\d+)$")


def _load_trace(stderr: str) -> dict:
    """A child's shim trace (``VTPU_DEBUG=1``): every load the shim saw
    and the bytes it charged, by library (the file the image lies in;
    ``-`` for an image on the heap, as cuBLASLt decompresses its own) and
    by rule; and the bytes of the allocations it charged, by the library
    that asked for them; and each primary context's creation: the free
    bytes it took, and the libraries loaded before it, charged then."""
    by_library, allocations, retains = {}, {}, []
    for line in stderr.splitlines():
        m = _LOAD_LINE.match(line)
        if m:
            lib = by_library.setdefault(os.path.basename(m.group(4)),
                                        {"loads": 0, "bytes": 0,
                                         "rules": {}})
            lib["loads"] += 1
            lib["bytes"] += int(m.group(2))
            lib["rules"][m.group(3)] = lib["rules"].get(m.group(3), 0) + 1
            continue
        m = _ALLOC_LINE.match(line)
        if m:
            name = os.path.basename(m.group(2))
            allocations[name] = allocations.get(name, 0) + int(m.group(1))
        m = _RETAIN_LINE.match(line)
        if m:
            retains.append({"free_bytes_dropped": int(m.group(1)),
                            "libraries": int(m.group(2))})
    return {"loads": sum(v["loads"] for v in by_library.values()),
            "bytes": sum(v["bytes"] for v in by_library.values()),
            "by_library": by_library, "allocations_by_library": allocations,
            "retains": retains}


def _run_wrapped(case: str, workdir: str, shim: str, extra: dict) -> dict:
    """``_enforcement_child(case)`` in a fresh process under the shim, with
    a region of its own and the enforcement phase's cap unless ``extra``
    sets another; its line, with the shim's trace summed when ``extra``
    turns it on."""
    from k8s_device_plugin_torch import bench
    cache = tempfile.mkdtemp(prefix=f"{case}-", dir=workdir)
    env = bench._child_env({"VTPU_DEVICE_MEMORY_SHARED_CACHE": cache,
                            "VTPU_DEVICE_MEMORY_LIMIT_0": str(ENFORCE_CAP),
                            **extra}, shim)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--enforcement-child", case], env=env, cwd=HERE,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"enforcement {case}: rc={proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if extra.get("VTPU_DEBUG"):
        line["trace"] = _load_trace(proc.stderr)
    return line


def phase_enforcement_card(card: str) -> dict:
    """The enforcement shim (``libvtpu_cuda.so``) on the card, in five
    fresh processes under it with a 5 GiB cap each unless said: K1, K2 and
    K3 under it against their plain versions; a K2 launch loop at case 5.1
    under ``VTPU_DEVICE_CORE_LIMIT=50`` against one without a limit, the
    rate ratio inside ``bench.DUTY_BAND``; 512 MiB tensors until the shim
    refuses one (``torch.OutOfMemoryError``), with the allocator's reserve
    and the region's usage never above the cap, the usage equal to the
    reserve plus the charged context and device code within one segment,
    and the card reporting the cap as its total; the same past the cap
    under ``VTPU_OVERSUBSCRIBE=1`` (spill, no refusal, no violation); the
    device code the loads charged (``enforcement_module``): by library
    from the shim's trace, at each point of the main child, after a cuBLAS
    product beside cuBLAS's own allocations, against the free bytes the
    card lost under ``CUDA_MODULE_LOADING=EAGER`` (above the card's
    memory as the cap), and K3's load refused at a cap just above what a
    child holds; and the kill switch, under which the whole card shows and
    nothing is refused. Every line carries the card's name and power
    limit."""
    from k8s_device_plugin_torch import _build, bench
    t0 = time.perf_counter()
    shim = _build.host_library("vtpu_cuda")
    traced = {"VTPU_DEBUG": "1"}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-enforce-") as tmp:
        main = _run_wrapped("main", tmp, shim, traced)
        capped = _run_wrapped("capped", tmp, shim,
                              {"VTPU_DEVICE_CORE_LIMIT": "50",
                               "VTPU_OVERSUBSCRIBE": "1"})
        off = _run_wrapped("disabled", tmp, shim,
                           {"VTPU_DISABLE_CONTROL": "true"})
        eager = _run_wrapped("eager", tmp, shim,
                             {**traced, "CUDA_MODULE_LOADING": "EAGER",
                              "VTPU_DEVICE_MEMORY_LIMIT_0": str(EAGER_CAP)})
        refuse = _run_wrapped("refuse", tmp, shim, traced)

    emit("enforcement_kernels", card=card,
         probe_chain_err=main["probe_chain_err"],
         flash_absorb=main["flash_absorb"],
         lstm_cell_err=main["k2"]["max_abs_err"])

    k2, ratio = main["k2"], (capped["k2"]["launches_per_s"]
                             / main["k2"]["launches_per_s"])
    emit("enforcement_duty_k2", card=card, shape=LSTM_CASE,
         route=k2["route"], ratio=ratio, band=list(bench.DUTY_BAND),
         uncapped=k2, capped50=capped["k2"])
    if not bench.DUTY_BAND[0] <= ratio <= bench.DUTY_BAND[1]:
        raise AssertionError(f"K2 duty under the shim: ratio {ratio} "
                             f"outside {bench.DUTY_BAND}")

    seq = capped["sequence"]["calls"]
    emit("enforcement_sequence", card=card, shape=[LSTM_CASE_STEPS,
                                                   *LSTM_CASE], calls=seq)
    # each call is one launch, and once timed, charged at least half its
    # device time (the charge is the mean of timed runs of the function)
    if not (all(c["launches"] == 1 for c in seq)
            and seq[-1]["charged_us"] >= 0.5 * seq[-1]["us"]):
        raise AssertionError(f"lstm_sequence under the shim: {seq}")

    fill, ctx = main["fill"], main["context_bytes"]
    gap = [u - (r + ctx + m)
           for r, u, m in zip(fill["reserved"], fill["used"], fill["module"])]
    emit("enforcement_oom", card=card, cap=ENFORCE_CAP, chunk=ENFORCE_CHUNK,
         refused_at=fill["refused_at"],
         reserved_at_refusal=fill["reserved_at_end"],
         used_at_refusal=fill["used_at_end"],
         max_reserved=fill["max_reserved"], context_bytes=ctx,
         module_bytes=fill["module"],
         used_minus_reserved_context_and_module=gap,
         mem_get_info=fill["mem_get_info"])
    if not (fill["refused_at"] and fill["max_reserved"] <= ENFORCE_CAP
            and max(fill["used"]) <= ENFORCE_CAP
            and fill["used_at_end"] <= ENFORCE_CAP
            and all(abs(g) <= ENFORCE_SLACK for g in gap)
            and fill["mem_get_info"][1] == ENFORCE_CAP
            and fill["violations"] == 0):
        raise AssertionError(f"enforcement oom: {fill}")

    fill = capped["fill"]
    emit("enforcement_oversubscribe", card=card, cap=ENFORCE_CAP,
         allocations=fill["allocations"], refused_at=fill["refused_at"],
         spill=fill["spill"], violations=fill["violations"],
         final_used=fill["final_used"],
         context_bytes=capped["context_bytes"])
    if not (fill["refused_at"] is None and fill["spill"] > 0
            and fill["violations"] == 0):
        raise AssertionError(f"enforcement oversubscribe: {fill}")

    emit("enforcement_kill_switch", card=card, **off)
    if not (off["rcs"] == [0] * 5 and off["total"] > ENFORCE_CAP
            and not off["region_exists"]):
        raise AssertionError(f"enforcement kill switch: {off}")

    _check_module_charge(card, main, eager, refuse, capped)
    seconds = time.perf_counter() - t0
    emit("enforcement_card", card=card, seconds=seconds)
    return {"k2_ratio": ratio, "seconds": seconds}


def _check_module_charge(card: str, main: dict, eager: dict, refuse: dict,
                         capped: dict) -> None:
    """The ``enforcement_module`` line and its checks: each kernel's
    library charged at its first launch (the trace names it, read as a
    cubin of the fatbin), ``used`` after a cuBLAS product equal to the
    reserve, the context, the device code and cuBLAS's own allocations
    within one segment, the EAGER windows large enough to read within
    ``EAGER_BAND`` of the free bytes the card lost, and the refused load
    raised through the kernel's wrapper with no charge left from it."""
    trace, module = main["trace"], main["module_bytes"]
    kernels = ("probe_chain", "flash_absorb", "lstm_cell")
    libs = {name: next((v for lib, v in trace["by_library"].items()
                        if lib.startswith(f"lib{name}-")), None)
            for name in kernels}
    steps = ["after_fill", *(f"after_{n}" for n in kernels)]
    cub = main["cublas"]
    cublas_own = sum(b for lib, b in trace["allocations_by_library"].items()
                     if lib.startswith("libcublas"))
    outside = cub["used"] - cub["reserved"] - cub["context"]
    windows = eager["windows"]
    kernel_window = {key: sum(windows[n][key] for n in kernels)
                     for key in ("charged", "free_lost", "lost_to_code")}
    # a primary context created under EAGER takes the libraries loaded
    # before it: its footprint less the lazy one's, against their charge
    lazy, loaded = trace["retains"][0], eager["trace"]["retains"][0]
    created = {"charged": loaded["libraries"],
               "lost_to_code": loaded["free_bytes_dropped"]
               - lazy["free_bytes_dropped"]}
    ratio = {name: w["charged"] / w["lost_to_code"]
             if w["lost_to_code"] > 0 else None
             for name, w in (("kernels", kernel_window),
                             ("cublas", windows["cublas"]),
                             ("context_creation", created))}
    refusal = refuse["refusal"]
    emit("enforcement_module", card=card, loads=trace["loads"],
         charged=trace["bytes"], by_library=trace["by_library"],
         module_bytes=module,
         after_cublas={**cub, "outside_reserve_and_context": outside,
                       "cublas_own_allocations": cublas_own,
                       "unexplained": outside - cub["module"] - cublas_own},
         allocations_by_library=trace["allocations_by_library"],
         eager={"windows": windows, "kernels": kernel_window,
                "context_creation": created, "charged_over_lost": ratio,
                "band": list(EAGER_BAND),
                "loads": eager["trace"]["loads"],
                "charged": eager["trace"]["bytes"],
                "by_library": eager["trace"]["by_library"]},
         refusal=refusal, refused_child_loads=refuse["trace"]["loads"],
         capped_module_bytes=capped["module_bytes"])
    if not all(lib and lib["rules"] == {"fatbin": 1} for lib in
               libs.values()) or not all(
            module[b] > module[a] for a, b in zip(steps, steps[1:])):
        raise AssertionError(f"module charge of the kernels' libraries: "
                             f"{libs} {module}")
    if abs(outside - cub["module"] - cublas_own) > ENFORCE_SLACK:
        raise AssertionError(f"used after cuBLAS: {cub}, cuBLAS's own "
                             f"{cublas_own}")
    if not all(r is not None and EAGER_BAND[0] <= r <= EAGER_BAND[1]
               for name, r in ratio.items() if name != "kernels"):
        raise AssertionError(f"module charge under EAGER: {ratio}")
    if not (refusal["error"] and "CUDA error" in refusal["error"]
            and refusal["module_after"] == refusal["module_before"]):
        raise AssertionError(f"refused load: {refusal}")


def _runner_line(argv) -> dict:
    """run.main(argv) with its stdout captured; its last JSON line."""
    from k8s_device_plugin_torch.workloads import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(argv)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0:
        raise AssertionError(f"runner {argv}: rc={rc} {line}")
    return line


#: the names read from ``_build.launches``: the six kernels', K2's
#: sequence route and K3's window, then LFM2's short convs and grouped
#: expert applies
COUNTED = ("probe_chain", "lstm_cell", "lstm_sequence", "flash_absorb",
           "flash_window", "bn_relu", "add_bn_relu", "swiglu_gate",
           "short_conv", "expert_apply")


def _counting(by_path: dict):
    """``counted(path, fn)``: ``_build.launches`` cleared just before
    ``fn()`` and read just after, into ``by_path[path]``."""
    from k8s_device_plugin_torch import _build

    def counted(path, fn):
        _build.launches.clear()
        out = fn()
        by_path[path] = {name: _build.launches[name] for name in COUNTED}
        return out
    return counted


def phase_main_path() -> dict:
    """ResNet-50 native + 4-way share with the probe, then the bench's
    oversubscribe phase and duty check, every share child under the
    enforcement shim (``--child-mode wrapped``, the bench's default on a
    card); the share once more under the cooperative limiter (``plain``)
    in the same run, so the shim's cost stands beside it; LSTM case 5.1
    and the LM (infer, then decode) through the runner, and the train
    paths. Every launch counter is set to 0 just before each path and read
    just after; returns each kernel's launches by path."""
    from k8s_device_plugin_torch import bench

    by_path = {}
    counted = _counting(by_path)

    def share():
        args = bench.parse_args([])
        with tempfile.TemporaryDirectory(prefix="chip-smoke-") as workdir:
            return bench.measure(args, workdir)

    t0 = time.perf_counter()
    result = counted("resnet50_share", share)
    extra = result["extra"]
    if extra["enforcement"] != "wrapped":
        raise AssertionError(f"the share ran {extra['enforcement']}")
    emit("resnet50_native", img_per_s=extra["native_img_per_s"],
         best_pass_img_per_s=extra["native_best_pass_img_per_s"],
         batch=extra["batch"], image_size=extra["image_size"],
         flops_per_img=extra["flops_per_img"], device=extra["device"])
    emit("resnet50_share", share_procs=extra["share_procs"],
         enforcement=extra["enforcement"],
         img_per_s=result["value"], vs_baseline=result["vs_baseline"],
         images=extra["images"], window_s=extra["window_s"],
         per_proc_img_per_s=extra["per_proc_img_per_s"],
         per_proc_best_pass_img_per_s=extra[
             "per_proc_best_pass_img_per_s"],
         hbm_cap_bytes=extra["hbm_cap_bytes"],
         hbm_used_bytes=extra["hbm_used_bytes"],
         per_proc_module_bytes=extra["module_bytes"]["share"],
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
    # the bench's phases after the share: 10 replicas under
    # VTPU_OVERSUBSCRIBE with a 64 MiB cap (their usage above it is spill,
    # never a violation), then one child uncapped and one at a 50% duty
    # cap, each charging the token bucket its calls' device time
    over, duty = extra["oversubscribe"], extra["duty_check"]
    emit("bench_oversubscribe", **over, cap_bytes=bench.OVERSUB_CAP_BYTES,
         shape=list(bench.QUICK_TIER),
         module_bytes=extra["module_bytes"]["oversubscribe"],
         seconds=extra["phase_s"]["oversubscribe"])
    if not (over["replicas"] == 10 and over["spill_bytes"] > 0
            and over["violations"] == 0):
        raise AssertionError(f"oversubscribe phase: {over}")
    emit("bench_duty_check", **duty, band=list(bench.DUTY_BAND),
         batch=extra["batch"], image_size=extra["image_size"],
         module_bytes=extra["module_bytes"]["duty_check"],
         seconds=extra["phase_s"]["duty_check"])
    if not duty["within_band"]:
        raise AssertionError(f"duty check: capped/uncapped {duty['ratio']} "
                             f"outside {bench.DUTY_BAND}")

    # the same share under the cooperative limiter, beside the wrapped one
    def plain_share():
        args = bench.parse_args(["--child-mode", "plain"])
        with tempfile.TemporaryDirectory(prefix="chip-smoke-") as workdir:
            return bench.run_share(args, extra["total_bytes"], workdir)

    t0 = time.perf_counter()
    plain = counted("resnet50_share_plain", plain_share)
    emit("resnet50_share_plain", enforcement="plain",
         share_procs=plain["share_procs"], img_per_s=plain["img_per_s"],
         vs_baseline=plain["img_per_s"] / extra["native_img_per_s"],
         wrapped_img_per_s=result["value"],
         wrapped_over_plain=result["value"] / plain["img_per_s"],
         per_proc_img_per_s=plain["per_proc_img_per_s"],
         hbm_used_bytes=plain["hbm_used_bytes"],
         violations=plain["violations"], seconds=time.perf_counter() - t0)
    if plain["violations"] != 0:
        raise AssertionError(f"plain share: {plain['violations']} "
                             f"violations")

    line = counted("lstm_case_5_1", lambda: _runner_line(
        ["--model", "lstm", "--steps", str(INFER_STEPS["lstm"])]))
    if not line["items_per_s"] > 0:
        raise AssertionError(f"lstm runner: {line}")
    emit("lstm_case_5_1", **line)

    t0 = time.perf_counter()
    line = counted("lm_infer", lambda: _runner_line(
        ["--model", "lm", "--mode", "infer", "--steps", "5"]))
    if not (line["tokens_per_s"] > 0 and line["sp"] == 1):
        raise AssertionError(f"lm infer runner: {line}")
    emit("lm_infer", **line, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    line = counted("lm_decode", lambda: _runner_line(
        ["--model", "lm", "--mode", "decode", "--steps", "2"]))
    if not (line["gen_tokens_per_s"] > 0 and line["prefill_s"] > 0):
        raise AssertionError(f"lm decode runner: {line}")
    emit("lm_decode", **line, seconds=time.perf_counter() - t0)

    train = {}
    for model, case in (("lm", "lm_train"), ("resnet50", "resnet50_train"),
                        ("resnet152", "resnet152_train"),
                        ("lstm", "lstm_train")):
        t0 = time.perf_counter()
        line = counted(case, lambda model=model: _runner_line(
            ["--model", model, "--mode", "train", "--steps",
             str(TRAIN_STEPS[model])]))
        if not line["items_per_s"] > 0:
            raise AssertionError(f"{model} train runner: {line}")
        train[case] = line
        emit(case, **line, steps=TRAIN_STEPS[model],
             seconds=time.perf_counter() - t0)

    # the Switch-MoE LM (infer, train, decode), then VGG-16 and DeepLab-v3
    # (infer, train): cases 3.x and 4.x
    for model, mode, steps in (
            ("moe-lm", "infer", INFER_STEPS["moe-lm"]),
            ("moe-lm", "train", TRAIN_STEPS["moe-lm"]),
            ("moe-lm", "decode", 2),
            ("vgg16", "infer", INFER_STEPS["vgg16"]),
            ("vgg16", "train", TRAIN_STEPS["vgg16"]),
            ("deeplab", "infer", INFER_STEPS["deeplab"]),
            ("deeplab", "train", TRAIN_STEPS["deeplab"])):
        case = f"{model.replace('-', '_')}_{mode}"
        t0 = time.perf_counter()
        line = counted(case, lambda model=model, mode=mode, steps=steps:
                       _runner_line(["--model", model, "--mode", mode,
                                     "--steps", str(steps)]))
        rate = line["gen_tokens_per_s" if mode == "decode" else
                    "items_per_s"]
        if not rate > 0:
            raise AssertionError(f"{model} {mode} runner: {line}")
        emit(case, **line, steps=steps, seconds=time.perf_counter() - t0)

    launches = {name: sum(p[name] for p in by_path.values())
                for name in COUNTED}
    emit("main_path_launches", **launches, by_path=by_path)
    _check_own_paths(by_path)
    # launches a call: the LM trains on 12 absorbs (3 per layer at
    # 1024-token chunks), the MoE LM on one whole-sequence absorb a layer
    # to infer and to train; the LSTM infers in one launch of K2's
    # sequence route and trains on one per-step K2 a time step (autograd
    # records); the runner makes 2 warm-up calls before its steps. Decode,
    # VGG and DeepLab run no port kernel (cuDNN convolutions, as XLA owns
    # them on the TPU).
    per_call = {("lm_train", "flash_absorb"): (12, TRAIN_STEPS["lm"]),
                ("lstm_train", "lstm_cell"): (64, TRAIN_STEPS["lstm"]),
                ("lstm_train", "lstm_sequence"): (0, 0),
                ("lstm_case_5_1", "lstm_sequence"): (1, INFER_STEPS["lstm"]),
                ("lstm_case_5_1", "lstm_cell"): (0, 0),
                ("moe_lm_infer", "flash_absorb"): (4, INFER_STEPS["moe-lm"]),
                ("moe_lm_train", "flash_absorb"): (4, TRAIN_STEPS["moe-lm"])}
    per_call.update({(path, name): (0, 0) for path in (
        "moe_lm_decode", "vgg16_infer", "vgg16_train", "deeplab_infer",
        "deeplab_train") for name in COUNTED})
    # the ResNets train on the modules' own BatchNorm, ReLU and add
    per_call.update({(path, name): (0, 0) for path in (
        "resnet50_train", "resnet152_train")
        for name in ("bn_relu", "add_bn_relu")})
    for (path, name), (n, steps) in per_call.items():
        calls = steps + 2
        if by_path[path][name] != n * calls:
            raise AssertionError(f"{path}: {by_path[path][name]} {name} "
                                 f"launches in {calls} calls, not {n} each")
    return by_path


def _check_own_paths(by_path: dict) -> None:
    """Each kernel must have run on every path that carries it."""
    own = {"probe_chain": ["resnet50_share"],
           "lstm_cell": ["lstm_train"],
           "lstm_sequence": ["lstm_case_5_1"],
           "flash_absorb": ["lm_infer", "lm_train", "moe_lm_infer",
                            "moe_lm_train", "multichip_ring_flash",
                            "multichip_moe_lm_ring_flash",
                            "afmoe_forward"],
           "bn_relu": ["multichip_resnet50_infer"],
           "add_bn_relu": ["multichip_resnet50_infer"],
           "flash_window": ["afmoe_forward"],
           "swiglu_gate": ["lfm2_moe_forward", "afmoe_forward"],
           "short_conv": ["lfm2_moe_forward"],
           "expert_apply": ["lfm2_moe_forward", "afmoe_forward"]}
    missing = [(name, path) for name, paths in own.items() for path in paths
               if path in by_path and by_path[path][name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on their path: "
                             f"{missing}")


def phase_multichip_card() -> dict:
    """``--multichip`` on the card: a world of one over NCCL, as the JAX
    runner's mesh spans its one chip. The runner's ResNet-50 (infer at case
    1.1, train at case 1.2; (dp, mp) = (1, 1)) and LM (infer 8 x 2048, train
    4 x 2048; (dp, sp) = (1, 1), attention the ring's plain absorb, as
    JAX's under a mesh) each print their line, and the first calls of each
    path (the logits; two steps' losses) are held against the same path
    without a mesh on the same weights at 2e-2 of the largest magnitude
    (bf16, and cuDNN's algorithms may differ between two models). Then the
    ring with ``use_flash`` at the LM's attention shape (8 x 2048, 8 heads
    of 64, bf16, causal): its forward and its gradients in q, k, v
    through K3 and the absorb's recompute backward against the ring's
    plain absorb, at 2e-2 of the largest. Returns the K3 launches by path
    (the comparisons' own runs are not counted)."""
    import torch
    from k8s_device_plugin_torch.workloads import harness, run
    from k8s_device_plugin_torch.workloads.attention import ring_attention
    by_path = {}
    counted = _counting(by_path)
    report = {}
    t0 = time.perf_counter()
    with run.world(torch.device("cuda")) as device:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("--multichip on the card is not on NCCL")
        for model, mode in (("resnet50", "infer"), ("resnet50", "train"),
                            ("lm", "infer"), ("lm", "train")):
            argv = ["--model", model, "--mode", mode, "--steps", "3"]
            path = f"multichip_{model}_{mode}"
            t1 = time.perf_counter()
            line = counted(path, lambda argv=argv: _runner_line(
                argv + ["--multichip"]))
            if not line["items_per_s"] > 0:
                raise AssertionError(f"{path}: {line}")
            calls = 2 if mode == "train" else 1
            outs = []
            for flags in ([], ["--multichip"]):
                call, _, _ = run.build_call(run.parse_args(argv + flags),
                                            device)
                outs.append([call().float() for _ in range(calls)])
                del call
            errs = [err_of_largest(f"{path} against no mesh", got, want,
                                   2e-2) for got, want in zip(*outs[::-1])]
            report[path] = {"line": line, "err_vs_no_mesh": errs,
                            "seconds": time.perf_counter() - t1}
            emit(path, **line, err_vs_no_mesh=errs,
                 world=torch.distributed.get_world_size(),
                 seconds=report[path]["seconds"])
        mesh = harness.device_mesh((1, 1), ("dp", "sp"))
        group = mesh.get_group("sp")
        g = torch.Generator(device="cuda").manual_seed(5)
        q, k, v = (torch.randn(8, 2048, 8, 64, generator=g, device="cuda",
                               dtype=torch.bfloat16).requires_grad_()
                   for _ in range(3))

        def ring(use_flash):
            out = ring_attention(q, k, v, group, causal=True,
                                 use_flash=use_flash)
            grads = torch.autograd.grad(out.float().square().sum(),
                                        (q, k, v))
            return out, grads
        got = counted("multichip_ring_flash", lambda: ring(True))
        want = ring(False)
        errs = {"out": err_of_largest("ring+flash", got[0], want[0], 2e-2)}
        for name, gg, gw in zip("qkv", got[1], want[1]):
            errs[f"d{name}"] = err_of_largest(f"ring+flash d{name}", gg, gw,
                                              2e-2)
        with torch.no_grad():
            flash_ms = cuda_ms(lambda: ring_attention(
                q, k, v, group, causal=True, use_flash=True), 10)
            plain_ms = cuda_ms(lambda: ring_attention(
                q, k, v, group, causal=True, use_flash=False), 5)
        emit("multichip_ring_flash", shape=[8, 2048, 8, 64], errs=errs,
             k3_launches=by_path["multichip_ring_flash"]["flash_absorb"],
             ms=flash_ms, plain_ms=plain_ms)
    emit("multichip_card", by_path=by_path,
         seconds=time.perf_counter() - t0)
    # a ResNet-V2-50 eval forward: 33 BatchNorm + ReLU passes (the stem's
    # preact, bn1 and bn2 of 16 blocks) and 16 adds (15 into the next
    # preact, one into final_bn); training takes the modules' own ops.
    # The runner makes 2 warm-up calls before its 3 steps.
    for path, want in (("multichip_resnet50_infer", (33, 16)),
                       ("multichip_resnet50_train", (0, 0))):
        got = (by_path[path]["bn_relu"], by_path[path]["add_bn_relu"])
        if got != (want[0] * 5, want[1] * 5):
            raise AssertionError(f"{path}: {got} bn_relu, add_bn_relu "
                                 f"launches in 5 calls, not {want} each")
    return by_path


def _routes(fn):
    """(``fn()``, the expert each token took in each layer): from the
    dispatch ``moe._route`` returns, the expert whose slot the token holds,
    or -1 for a token past its expert's capacity (dropped), one flat
    tensor of the tokens' decisions a layer (batch-major, with or without
    a mesh of one)."""
    import torch
    from k8s_device_plugin_torch.workloads import moe
    taken, route = [], moe._route

    def recording(x, gate_w, n_experts, capacity):
        out = route(x, gate_w, n_experts, capacity)
        held = out[0].sum(-1)                                 # [..., N, E]
        taken.append(torch.where(held.sum(-1) > 0, held.argmax(-1), -1)
                     .reshape(-1))
        return out
    moe._route = recording
    try:
        return fn(), taken
    finally:
        moe._route = route


def _held_routed_alike(what: str, got_fn, want_fn, bound: float) -> dict:
    """Logits [B, T, V] of ``got_fn()`` against ``want_fn()`` at ``bound``
    of the largest, on every position whose decision (:func:`_routes`)
    agrees in every layer. A near-tie of the gate (bf16 logits tie
    exactly) flips a decision on a rounding difference upstream; the
    flipped token then takes another function's output (O(1) apart), and
    its expert's queue shifts, so another token may cross the capacity
    and be dropped: those positions are counted, not compared."""
    import torch
    got, got_routes = _routes(got_fn)
    want, want_routes = _routes(want_fn)
    alike = torch.stack([a == b for a, b in zip(got_routes,
                                                want_routes)]).all(0)
    vocab = want.shape[-1]
    got, want = got.float().reshape(-1, vocab), want.float().reshape(-1,
                                                                     vocab)
    scale = want.abs().max().item()
    err = max_abs_err(got[alike], want[alike]) / scale
    if not (torch.isfinite(got).all() and err <= bound):
        raise AssertionError(f"{what}: {err} of the largest on the "
                             f"positions routed alike, bound {bound}")
    return {"err_routed_alike": err, "err_all": max_abs_err(got, want)
            / scale, "flips_by_layer": [int((a != b).sum()) for a, b in
                                        zip(got_routes, want_routes)],
            "positions": alike.numel(),
            "positions_routed_apart": int((~alike).sum())}


def _moe_lm_oracle(call, steps: int = 0):
    """What the runner's ``moe-lm --multichip`` ``call`` at world 1 gives,
    from the oracle with the mesh's block boundaries: ``moe_lm_forward`` /
    ``moe_lm_loss`` without a mesh and with ``shard_shape=(1, 1)`` (one
    routing group, dense attention) on a copy of the weights ``call``
    starts from; the logits, or with ``steps`` the losses of as many steps
    of the same plain SGD."""
    import copy

    import torch
    from k8s_device_plugin_torch.workloads import harness
    from k8s_device_plugin_torch.workloads.moe import (moe_lm_forward,
                                                       moe_lm_loss)
    model, tokens = copy.deepcopy(call.model), call.tokens
    if not steps:
        with torch.inference_mode():
            return moe_lm_forward(model, tokens, shard_shape=(1, 1))[0]
    optimizer = harness.sgd(model, momentum=0.0)
    out = []
    for _ in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = moe_lm_loss(model, tokens, shard_shape=(1, 1))
        loss.backward()
        optimizer.step()
        out.append(loss.detach())
    return out


def phase_multichip_moe(device: str = "cuda") -> dict:
    """``moe-lm --multichip`` on the card, a world of one over NCCL: the
    runner's ``--mode infer`` (8 x 2048) and ``--mode train`` (4 x 2049) at
    full width (``LM_CONFIG``, 8 experts of hidden 2048, bf16) on a (dp,
    sp) = (1, 1) mesh, attention the ring's plain absorb and one routing
    group of the rank's whole block (a [16384, 8, 2560] fp32 dispatch
    tensor a layer to infer, as JAX's), each printing its line; the first
    calls against the oracle with the mesh's block boundaries
    (:func:`_moe_lm_oracle`): two steps' losses at 2e-2, the logits at 2e-2
    of the largest on the positions routed alike in every layer
    (:func:`_held_routed_alike`; bf16 gate logits tie), and the same
    forward in fp32 (TF32 off) at 1e-4 of the largest, PR 5's fp32 bound.
    Then the same forward with ``use_flash`` (K3 in the ring, one absorb a
    layer) against ``use_flash=False``, at 2e-2 on the positions routed
    alike. Returns the launches by path (the comparisons' own runs are not
    counted). ``device="cpu"`` rehearses the phase on a gloo world of
    one."""
    import copy

    import torch
    from k8s_device_plugin_torch.workloads import run
    from k8s_device_plugin_torch.workloads.attention import seq_shard
    from k8s_device_plugin_torch.workloads.moe import moe_lm_forward
    by_path = {}
    counted = _counting(by_path)
    t0 = time.perf_counter()
    with run.world(torch.device(device)) as device:
        if device.type == "cuda" and \
                torch.distributed.get_backend() != "nccl":
            raise AssertionError("--multichip on the card is not on NCCL")
        for mode in ("infer", "train"):
            argv = ["--model", "moe-lm", "--mode", mode, "--steps", "3",
                    "--multichip", "--device", device.type]
            path = f"multichip_moe_lm_{mode}"
            t1 = time.perf_counter()
            line = counted(path, lambda argv=argv: _runner_line(argv))
            if not (line["tokens_per_s"] > 0 and line["sp"] == 1):
                raise AssertionError(f"{path}: {line}")
            call, _, _ = run.build_call(run.parse_args(argv), device)
            if mode == "train":
                want = _moe_lm_oracle(call, steps=2)
                got = [call() for _ in range(2)]
                errs = [err_of_largest(f"{path} against the oracle", g, w,
                                       2e-2) for g, w in zip(got, want)]
            else:
                errs = {"bfloat16": _held_routed_alike(
                    f"{path} against the oracle", call,
                    lambda: _moe_lm_oracle(call), 2e-2)}
                model = copy.deepcopy(call.model).float()
                tokens, mesh = call.tokens, call.mesh
                with no_tf32(), torch.inference_mode():
                    errs["float32"] = _held_routed_alike(
                        f"{path} in fp32 against the oracle",
                        lambda: moe_lm_forward(model, seq_shard(tokens, mesh),
                                               mesh)[0],
                        lambda: moe_lm_forward(model, tokens,
                                               shard_shape=(1, 1))[0], 1e-4)
                del model
            emit(path, **line, err_vs_oracle=errs,
                 world=torch.distributed.get_world_size(),
                 seconds=time.perf_counter() - t1)
            del call
        call, _, _ = run.build_call(run.parse_args(
            ["--model", "moe-lm", "--mode", "infer", "--multichip",
             "--device", device.type]), device)
        model, mesh = call.model, call.mesh
        tokens = seq_shard(call.tokens, mesh)

        def forward(use_flash):
            with torch.inference_mode():
                return moe_lm_forward(model, tokens, mesh,
                                      use_flash=use_flash)[0]
        err = _held_routed_alike(
            "moe-lm ring+flash", lambda: counted(
                "multichip_moe_lm_ring_flash", lambda: forward(True)),
            lambda: forward(False), 2e-2)
        flash_ms = cuda_ms(lambda: forward(True), 3)
        plain_ms = cuda_ms(lambda: forward(False), 3)
        emit("multichip_moe_lm_ring_flash", shape=list(tokens.shape),
             err_vs_plain_ring=err,
             k3_launches=by_path["multichip_moe_lm_ring_flash"][
                 "flash_absorb"], ms=flash_ms, plain_ms=plain_ms)
    # the mesh path attends through the ring's plain absorb, as JAX's; K3
    # runs once a layer in the ring with use_flash
    launches = {path: counts["flash_absorb"]
                for path, counts in by_path.items()}
    want = {"multichip_moe_lm_infer": 0, "multichip_moe_lm_train": 0,
            "multichip_moe_lm_ring_flash": run.LM_CONFIG[3]}
    if launches != want:
        raise AssertionError(f"K3 launches {launches}, not {want}")
    emit("multichip_moe", by_path=by_path, seconds=time.perf_counter() - t0)
    return by_path


def phase_pipeline_card(device: str = "cuda") -> None:
    """The pipeline on the card at world 1 over NCCL, on a (dp, pp) =
    (1, 1) mesh at the dry run's shapes (dim 16, hidden 32, microbatches
    [2 pp - 1, 2 dp, 16]): ``pipeline_loss`` and its gradients against
    ``pipeline_reference``'s MSE in full fp32 (``no_tf32``) at 1e-5. The
    repo has no wider pipeline configuration."""
    import torch
    from k8s_device_plugin_torch.workloads import harness, run
    from k8s_device_plugin_torch.workloads.pipeline import (
        init_stage_params, pipeline_loss, pipeline_reference)
    g = torch.Generator().manual_seed(0)
    with run.world(torch.device(device)), no_tf32():
        mesh = harness.device_mesh((1, 1), ("dp", "pp"))
        params = init_stage_params(g, 1, 16, 32, device=device)
        ref = init_stage_params(torch.Generator().manual_seed(0), 1, 16, 32,
                                device=device)
        harness.shard_params(params, mesh)
        x, tgt = (torch.randn(1, 2, 16, generator=g).to(device)
                  for _ in range(2))
        loss = pipeline_loss(params, x, tgt, mesh)
        loss.backward()
        harness.sum_replica_grads(params, mesh)
        want = ((pipeline_reference(ref, x) - tgt) ** 2).mean()
        want.backward()
        errs = {"loss": check_close("pipeline loss", loss, want, 1e-5)}
        for name in ("w_in", "w_out"):
            errs[name] = check_close(f"pipeline d{name}",
                                     getattr(params, name).grad,
                                     getattr(ref, name).grad, 1e-5)
    emit("pipeline_card", shape=[1, 2, 16], hidden=32, loss=loss.item(),
         max_abs_err=errs)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_checkpoint_card(device: str = "cuda") -> None:
    """Checkpoint and resume of the runner's ResNet-50 train state at case
    1.2 (20 @ 346, fp32 master weights, bf16 compute, SGD-momentum 0.9 at
    1e-3) under ``shard_train_step`` on a (dp, mp) = (1, 1) mesh, a world of
    one over NCCL: 2 steps, a save, 2 more steps (the reference losses);
    then a fresh model and optimizer, sharded, restored, and 2 steps,
    within rtol 1e-5 of the reference; every restored tensor (parameters,
    BatchNorm statistics, momentum buffers) equal bit for bit to the saved
    one, and a restore without a mesh equal to it leaf by leaf. cuDNN runs
    deterministic, its algorithms chosen without search, for this phase
    only: two models' searches may pick different algorithms. Prints the
    bytes written and the seconds to save and to restore."""
    import torch
    from k8s_device_plugin_torch.workloads import checkpoint, harness, run
    batch, size = run.CASES["resnet50"][1], run.CASES["resnet50"][2]
    x = torch.ones(batch, size, size, 3, dtype=torch.bfloat16,
                   device=device)
    labels = torch.zeros(batch, dtype=torch.long, device=device)
    saved_flags = (torch.backends.cudnn.deterministic,
                   torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def fresh(mesh):
        model = harness.init_model(run.build_model(
            "resnet50", torch.bfloat16, size, train=True), 0, device)
        optimizer = harness.sgd(model)
        step = harness.make_train_fn(model, optimizer)
        step, state, xs, ls = harness.shard_train_step(
            step, mesh, harness.init_train_state(model), x, labels)
        return model, optimizer, step, state, xs, ls

    def train(step, state, xs, ls, n):
        losses = []
        for _ in range(n):
            state, loss = step(state, xs, ls)
            losses.append(loss.item())
        return state, losses

    def tensors(model, optimizer):
        out = {f"model.{k}": v.clone() for k, v in
               model.state_dict().items()}
        out.update({f"optim.{k}": optimizer.state[p]["momentum_buffer"]
                    .clone() for k, p in model.named_parameters()})
        return out
    try:
        with run.world(torch.device(device)), \
                tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as d:
            mesh = harness.make_mesh()
            model, optimizer, step, state, xs, ls = fresh(mesh)
            state, _ = train(step, state, xs, ls, 2)
            saved = tensors(model, optimizer)
            path = os.path.join(d, "ckpt")
            harness.synchronize(device)
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(path, model, optimizer, state, mesh)
            save_s = time.perf_counter() - t0
            _, ref = train(step, state, xs, ls, 2)
            del model, optimizer, step
            model, optimizer, step, _, xs, ls = fresh(mesh)
            t0 = time.perf_counter()
            state = checkpoint.restore_checkpoint(path, model, optimizer,
                                                  mesh)
            harness.synchronize(device)
            restore_s = time.perf_counter() - t0
            restored = tensors(model, optimizer)
            if state != {"step": 2} or sorted(restored) != sorted(saved):
                raise AssertionError(f"restored {state}, "
                                     f"{len(restored)} tensors")
            differ = [k for k in saved if not torch.equal(saved[k],
                                                          restored[k])]
            if differ:
                raise AssertionError(f"restored tensors differ: {differ}")
            _, got = train(step, state, xs, ls, 2)
            rel = [abs(g - w) / abs(w) for g, w in zip(got, ref)]
            if max(rel) > 1e-5:
                raise AssertionError(f"resumed losses {got} against {ref}")
            whole = run.build_model("resnet50", torch.bfloat16, size,
                                    train=True).to(device)
            whole_opt = harness.sgd(whole)
            checkpoint.restore_checkpoint(path, whole, whole_opt)
            differ = [k for k, v in tensors(whole, whole_opt).items()
                      if not torch.equal(v, saved[k])]
            if differ:
                raise AssertionError(f"no-mesh restore differs: {differ}")
            written = _dir_bytes(path)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved_flags
    emit("checkpoint_card", batch=batch, image_size=size,
         tensors=len(saved), bytes_written=written, save_s=save_s,
         restore_s=restore_s, losses=got, reference_losses=ref,
         loss_rel_err=rel)


#: kernel families by name, for a profile's breakdown (first match wins)
FAMILIES = (("flash_absorb (K3)", ("flash",)),
            ("lstm_cell (K2)", ("lstm",)),
            ("grouped expert products", ("groupproblemshape",
                                         "grouped_gemm")),
            ("matmul (cuBLAS, cuDNN)", ("gemm", "xmma", "cutlass", "sm90_",
                                        "wgmma", "conv", "cudnn")),
            ("copy", ("copy",)),
            ("reduction", ("reduce", "softmax", "norm")))


def _family(name: str) -> str:
    low = name.lower()
    for family, keys in FAMILIES:
        if any(key in low for key in keys):
            return family
    return "elementwise and other"


def _profile(fn, iters: int, top: int = 8, ranges: tuple = ()) -> dict:
    """Where ``fn``'s time goes: wall ms per call (host clock around
    ``iters`` calls ending in a synchronize, profiler off), device ms per
    call, by kernel family (:data:`FAMILIES`) and for the ``top`` kernels,
    under torch.profiler (CUPTI), and the device's idle share,
    1 - device / wall (one stream: no overlap). ``ranges`` names
    ``record_function`` ranges whose device time per call is summed from
    the same trace (the kernels launched inside them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # one warm-up step first: events at the very start of a profiled
    # window went missing (3 of a forward's 4 flash launches counted).
    # The cycle's events are read as it ends, before the profiler clears
    # them. A cycle that came back without a kernel (seen after many
    # profiled windows in one process) is profiled again, up to 3 times.
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if ranges else [])

    def is_kernel(e):
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation and e.key not in ranges)
    events = []
    for attempt in range(1, 4):
        events.clear()
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=iters),
                     on_trace_ready=lambda p: events.extend(
                         p.key_averages())) as prof:
            for _ in range(iters + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if any(is_kernel(e) for e in events):
            break
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                       e.count // iters) for e in events if is_kernel(e)),
                     key=lambda k: -k[1])
    if not kernels:
        raise AssertionError("the profiler recorded no kernel")
    device_ms = sum(ms for _, ms, _ in kernels)
    families = {}
    for name, ms, _ in kernels:
        families[_family(name)] = families.get(_family(name), 0.0) + ms
    ranges_ms = {name: sum(e.device_time_total for e in events
                           if e.key == name and e.device_type
                           == torch.autograd.DeviceType.CPU) / 1e3 / iters
                 for name in ranges}
    for name, ms in ranges_ms.items():
        if not 0 < ms <= device_ms:
            raise AssertionError(f"range {name}: {ms} ms of the trace's "
                                 f"{device_ms} ms")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            **({"ranges_ms": ranges_ms} if ranges else {}),
            "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
            "profile_attempts": attempt,
            "kernels_per_call": sum(n for _, _, n in kernels),
            "families_ms": families,
            "top": [{"kernel": name[:150], "ms": ms, "per_call": n,
                     "share": ms / device_ms}
                    for name, ms, n in kernels[:top]],
            # copies (layout changes and casts) by kernel, all of them
            "copies": [{"kernel": name[:150], "ms": ms, "per_call": n}
                       for name, ms, n in kernels if "copy" in name.lower()]}


def phase_lm_profile() -> None:
    """The LM's serving paths under the profiler, at the runner's shapes
    and weights: one forward at batch 8 x 2048 (3 timed), and one decode
    call of 32 tokens from a 2048-token prefill (2 timed)."""
    import torch
    from k8s_device_plugin_torch.workloads import decode, run
    from k8s_device_plugin_torch.workloads.attention import (init_lm_params,
                                                             lm_forward)
    heads, dim, vocab, layers = run.LM_CONFIG
    batch, _, seq = run.CASES["lm"]
    model = init_lm_params(torch.Generator().manual_seed(0), vocab, dim,
                           heads, layers, dtype=torch.bfloat16)
    tokens = torch.randint(0, vocab, (batch, seq),
                           generator=torch.Generator().manual_seed(1)
                           ).to("cuda")

    def forward():
        with torch.inference_mode():
            return lm_forward(model, tokens, use_flash=True)
    emit("lm_infer_profile", **_profile(forward, 3))
    state = decode.prefill(model, tokens, steps_budget=run.DECODE_LEN)
    emit("lm_decode_profile", tokens_per_call=run.DECODE_LEN,
         **_profile(lambda: decode.decode_from(
             model, *state, steps=run.DECODE_LEN), 2))


def phase_lm_train_profile(attention: dict) -> None:
    """One LM train step at the runner's shapes and weights (batch
    4 x 2049 tokens, bf16, plain SGD) under the profiler, 2 timed; the
    share of its device time that the flash backward's recompute takes,
    read from the same trace (the kernels under the ``flash_absorb.backward``
    range), beside the estimate from ``attention`` (``phase_flash_grad``'s
    times of one layer, times the layers)."""
    import torch
    from k8s_device_plugin_torch.workloads import harness, run
    from k8s_device_plugin_torch.workloads.attention import (init_lm_params,
                                                             lm_loss)
    heads, dim, vocab, layers = run.LM_CONFIG
    batch, seq = run.CASES["lm"][1], run.CASES["lm"][2]
    model = init_lm_params(torch.Generator().manual_seed(0), vocab, dim,
                           heads, layers, dtype=torch.bfloat16,
                           device="cuda")
    tokens = torch.randint(0, vocab, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(1)
                           ).to("cuda")
    optimizer = harness.sgd(model, momentum=0.0)

    def step():
        optimizer.zero_grad(set_to_none=True)
        lm_loss(model, tokens, use_flash=True).backward()
        optimizer.step()
    prof = _profile(step, 2, top=12, ranges=("flash_absorb.backward",))
    recompute_ms = prof["ranges_ms"]["flash_absorb.backward"]
    one_layer_ms = layers * (attention["fwd_bwd_ms"] - attention["fwd_ms"])
    emit("lm_train_profile", tokens_per_step=batch * seq,
         attention_backward_ms=recompute_ms,
         attention_backward_share=recompute_ms / prof["device_ms"],
         attention_backward_from_one_layer_ms=one_layer_ms, **prof)


def phase_moe_profile() -> None:
    """The MoE LM under the profiler at the runner's shapes and weights
    (``LM_CONFIG``, 8 experts of hidden 2048, bf16, 1024-token routing
    blocks): one forward at batch 8 x 2048 (3 timed), and one train step
    at 4 x 2049 tokens with plain SGD (2 timed), both through K3 on
    whole-sequence absorbs; for the step, the device time under the flash
    backward's ``flash_absorb.backward`` range and its share."""
    import torch
    from k8s_device_plugin_torch.workloads import harness, run
    from k8s_device_plugin_torch.workloads.moe import (init_moe_lm_params,
                                                       moe_lm_forward,
                                                       moe_lm_loss)
    heads, dim, vocab, layers = run.LM_CONFIG
    batch, train_batch, seq = run.CASES["moe-lm"]
    model = init_moe_lm_params(torch.Generator().manual_seed(0), vocab, dim,
                               heads, layers, n_experts=run.MOE_EXPERTS,
                               dtype=torch.bfloat16, device="cuda")

    def tokens(b, length):
        return torch.randint(0, vocab, (b, length),
                             generator=torch.Generator().manual_seed(1)
                             ).to("cuda")
    infer_tokens = tokens(batch, seq)

    def forward():
        with torch.inference_mode():
            return moe_lm_forward(model, infer_tokens, use_flash=True,
                                  shard_shape=(batch, seq // run.MOE_GROUP))
    emit("moe_lm_infer_profile", tokens_per_call=batch * seq,
         **_profile(forward, 3, top=12))
    train_tokens = tokens(train_batch, seq + 1)
    optimizer = harness.sgd(model, momentum=0.0)

    def step():
        optimizer.zero_grad(set_to_none=True)
        moe_lm_loss(model, train_tokens, use_flash=True,
                    shard_shape=(train_batch, seq // run.MOE_GROUP)
                    ).backward()
        optimizer.step()
    prof = _profile(step, 2, top=12, ranges=("flash_absorb.backward",))
    recompute_ms = prof["ranges_ms"]["flash_absorb.backward"]
    emit("moe_lm_train_profile", tokens_per_step=train_batch * seq,
         attention_backward_ms=recompute_ms,
         attention_backward_share=recompute_ms / prof["device_ms"], **prof)


#: LFM2-8B-A1B's kernels a forward: short convs, grouped expert applies
#: (two ``_grouped_mm`` each), K3 absorbs, K6 passes (one a layer)
LFM2_COUNTS = {"short_conv": 18, "expert_apply": 22, "flash_absorb": 6,
               "swiglu_gate": 24}
#: one expert layer's grouped bf16 products against fp32 ones, over the
#: largest output: bf16 rounds the first product, the gated SwiGLU and each
#: expert's output once (0.0057 on the H100); a pair sent to the wrong
#: expert reads near 1
LFM2_GROUPED_BOUND = 2e-2
#: a bf16 forward against the plain fp32 reference on the program's own
#: expert choices, over the largest logit (:func:`lfm2_routed_alike`): the
#: program read 0.030-0.041 and the float8 control 0.367-0.481 on the
#: H100 (12 inputs of 4 x 4096, 3 seeds)
LFM2_ROUTED_BOUND = 0.1


def lfm2_routed_alike(model, cfg, x) -> tuple[float, float]:
    """(program, control): the last logits of ``model`` on prompts ``x``,
    and the reference computed in float8, each against the plain fp32
    reference (``vgpu_bench/reference/lfm2_moe.py``) on the experts the
    program chose in each sparse layer, over the largest reference logit.
    On its own routing the reference breaks some near-ties of the 4th and
    5th expert the other way, which moves the last logits as far as float8
    does; on the program's routing what is left is the products'
    rounding."""
    import torch
    from k8s_device_plugin_torch.workloads import moe
    from vgpu_bench.reference import lfm2_moe as plain
    taken, route = [], moe.route_sigmoid_topk

    def keep(*args):
        sel, gates = route(*args)
        taken.append(sel)
        return sel, gates
    moe.route_sigmoid_topk = keep
    try:
        with torch.inference_mode():
            logits = model(x)
    finally:
        moe.route_sigmoid_topk = route
    w = dict(model.state_dict())
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = plain.forward(w, x, cfg, "fp32", routing=taken)
            scale = want.abs().max().item()
            control = plain.forward(w, x, cfg, "fp8", routing=taken)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return (max_abs_err(logits, want) / scale,
            max_abs_err(control, want) / scale)


def phase_lfm2_moe() -> dict:
    """LFM2-8B-A1B at its published widths, built and served as the
    benchmark's cell does (``vgpu_bench.tenant.build`` on the seed's
    weights, the first input of its pool, 4 prompts of 4096 embeddings):
    first K3 at the cell's shape, [4, 4096, 32, 64] bf16 with K and V
    expanded from 8 heads as ``lfm2.attention`` expands them (kind 1,
    identity state), against the plain absorb on m, l, o and the finalized
    output (tolerance 2e-2, as the LM case); then the counters of one
    forward (:data:`LFM2_COUNTS`, else it fails), K3's kernels all on the
    ``wgmma`` route (``wg::flash_kernel`` in the trace), the profile of a
    forward (3 timed), the most loaded expert, the logits bit-equal with
    every SwiGLU forced through the ATen chain (else it fails), one
    layer's grouped apply on the card against the loop of plain products
    on the CPU on the same routed tokens, and the whole forward against
    the plain fp32 reference on the program's routing
    (:func:`lfm2_routed_alike`), where the float8 control must miss the
    bound that the program meets. Returns the forward's launches of every
    port kernel, as the main paths' (``lfm2_moe_forward``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from k8s_device_plugin_torch import _build
    from k8s_device_plugin_torch.workloads import (attention, flash, lfm2,
                                                   moe, swiglu)
    from vgpu_bench import tenant, weights
    cfg = _config("lfm2-8b-a1b.prefill4k.json")
    batch, seq, _ = cfg["input_shape"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dim = cfg["hidden_size"] // heads
    bf16 = torch.bfloat16
    q, k, v, m, l, o = _flash_args(batch, seq, seq, heads, dim, bf16, 17,
                                   True)
    k, v = (attention.expand_kv(t[:, :, :kv].contiguous(), heads)
            for t in (k, v))
    route = flash.absorb_route(q.dtype, dim, seq)
    got = flash.flash_absorb(q, k, v, 1, m, l, o)
    # one prompt at a time: the plain absorb's scores are [H, T, T] fp32
    want = [torch.cat(parts) for parts in zip(*(
        flash._absorb_reference(*(t[b:b + 1] for t in (q, k, v)), 1,
                                *(t[b:b + 1] for t in (m, l, o)),
                                dim ** -0.5) for b in range(batch)))]
    k3 = {name: check_close(f"flash_absorb LFM2 {name}", g, w, 2e-2)
          for name, g, w in zip("mlo", got, want)}
    k3["finalized"] = check_close(
        "flash_absorb LFM2 finalized", flash.flash_finalize(*got, bf16),
        flash.flash_finalize(*want, bf16), 2e-2)
    emit("lfm2_moe_flash_absorb", route=route, shape=list(q.shape),
         max_abs_err=k3)
    del q, k, v, m, l, o, got, want
    torch.cuda.empty_cache()

    model = tenant.build(cfg, 0, "cuda")
    x = weights.inputs(cfg, 0, 0, 0, "cuda")

    def forward():
        with torch.inference_mode():
            return model(x)
    forward()
    _build.launches.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits = forward()
        torch.cuda.synchronize()
    launched = {name: _build.launches[name] for name in COUNTED}
    counts = {name: launched[name] for name in LFM2_COUNTS}
    if counts != LFM2_COUNTS:
        raise AssertionError(f"lfm2_moe: launches {counts}, expected "
                             f"{LFM2_COUNTS}")
    absorbs = [e.key for e in prof.key_averages()
               if "flash_kernel" in e.key]
    if not absorbs or any("wg::" not in k for k in absorbs):
        raise AssertionError(f"lfm2_moe: K3 off the wgmma route: {absorbs}")
    if tuple(logits.shape) != (batch, model.cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"lfm2_moe: logits {tuple(logits.shape)}")
    largest = moe.largest_expert_load()
    emit("lfm2_moe_profile", tokens_per_call=batch * seq, launches=counts,
         largest_expert_load=largest,
         mean_expert_load=batch * seq * model.cfg.top_k
         / model.cfg.experts, peak_bytes=torch.cuda.max_memory_allocated(),
         **_profile(forward, 3, top=12))
    # K6 against the chain it replaced, through the whole model
    saved = lfm2.swiglu_gate, moe.swiglu_gate
    lfm2.swiglu_gate = moe.swiglu_gate = swiglu.swiglu_gate_reference
    try:
        chain = forward()
    finally:
        lfm2.swiglu_gate, moe.swiglu_gate = saved
    if not torch.equal(logits, chain):
        raise AssertionError(
            f"lfm2_moe: logits with K6 differ from the chain's by "
            f"{max_abs_err(logits, chain)}")
    emit("lfm2_moe_swiglu_bit_equal", logits=list(logits.shape))
    del chain
    # the grouped products against the plain ones, on the same routing
    lyr = model.layers[5].moe
    h = torch.randn(seq, model.cfg.dim, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2)
                    ).to(torch.bfloat16)
    sel, gates = moe.route_sigmoid_topk(h, lyr.router, lyr.expert_bias,
                                        model.cfg.top_k)
    with torch.inference_mode():
        got = moe.expert_apply(h, sel, gates, lyr.w13, lyr.w2)
    want = moe.expert_apply(h.cpu().float(), sel.cpu(), gates.cpu(),
                            lyr.w13.cpu().float(), lyr.w2.cpu().float())
    # bf16 rounds h13, the gated SwiGLU and each expert's output once
    err = err_of_largest("lfm2_moe grouped apply", got.cpu(), want,
                         LFM2_GROUPED_BOUND)
    emit("lfm2_moe_grouped_apply", err_of_largest=err,
         bound=LFM2_GROUPED_BOUND)
    del lyr, h, sel, gates, got, want
    program, control = lfm2_routed_alike(model, cfg, x)
    if not program <= LFM2_ROUTED_BOUND < control:
        raise AssertionError(
            f"lfm2_moe on the program's routing: program {program}, "
            f"float8 control {control}, bound {LFM2_ROUTED_BOUND}")
    emit("lfm2_moe_routed_alike", program=program, control=control,
         bound=LFM2_ROUTED_BOUND)
    del model
    torch.cuda.empty_cache()
    return {"lfm2_moe_forward": launched}


#: launches of one Trinity-Mini forward (:func:`phase_afmoe`): K3 in the
#: 24 sliding layers (windowed) and the 8 full ones (causal), the 30
#: expert layers' grouped applies, K6 in 2 dense, 30 shared and 30 routed
#: SwiGLUs
AFMOE_COUNTS = {"flash_window": 24, "flash_absorb": 8, "expert_apply": 30,
                "swiglu_gate": 62}


def phase_afmoe() -> dict:
    """Trinity-Mini at its published widths as rank 0 of 4-way expert
    parallelism, built and served as the cell ``trinity-mini.solo`` does
    (``vgpu_bench.tenant.build`` on the seed's weights, the first input of
    its pool, one prompt of 16,384 embeddings): the counters of one
    forward, set to 0 just before it (:data:`AFMOE_COUNTS`, else it
    fails), its K3 launches in the trace as ``tc::flash_window_kernel<128>``
    (24) and ``tc::flash_kernel<128>`` (8), the logits finite at [1,
    vocab], the build's peak memory and the forward's profile (3 timed).
    Returns the forward's launches of every port kernel, as the main
    paths' (``afmoe_forward``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from k8s_device_plugin_torch import _build
    from vgpu_bench import tenant, weights
    cfg = _config(TRINITY_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    model = tenant.build(cfg, 0, "cuda")
    x = weights.inputs(cfg, 0, 0, 0, "cuda")

    def forward():
        with torch.inference_mode():
            return model(x)
    forward()
    _build.launches.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a kernel first: events at the very start of a profiled window
        # can go missing (:func:`_profile`), and every K3 launch is counted
        torch.ones(1, device="cuda").add_(1)
        logits = forward()
        torch.cuda.synchronize()
    launched = {name: _build.launches[name] for name in COUNTED}
    counts = {name: launched[name] for name in AFMOE_COUNTS}
    if counts != AFMOE_COUNTS:
        raise AssertionError(f"afmoe: launches {counts}, expected "
                             f"{AFMOE_COUNTS}")
    traced = {name: sum(e.count for e in prof.key_averages()
                        if name in e.key)
              for name in ("tc::flash_window_kernel<128>",
                           "tc::flash_kernel<128>")}
    if list(traced.values()) != [24, 8]:
        raise AssertionError(f"afmoe: K3's kernels in the trace {traced}")
    if tuple(logits.shape) != (1, model.cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"afmoe: logits {tuple(logits.shape)}")
    emit("afmoe_profile", tokens_per_call=x.shape[0] * x.shape[1],
         launches=counts, traced=traced,
         peak_bytes=torch.cuda.max_memory_allocated(),
         **_profile(forward, 3, top=12))
    del model, x, logits
    torch.cuda.empty_cache()
    return {"afmoe_forward": launched}


def phase_model_train_profiles() -> None:
    """One train step of ResNet-50 at case 1.2 (batch 20 @ 346) and of the
    LSTM at case 5.2 (batch 10, 64 steps), built and stepped as the runner
    does, under the profiler (3 timed each)."""
    import torch
    from k8s_device_plugin_torch.workloads import harness, run
    for model_name, case in (("resnet50", "resnet50_train_profile"),
                             ("lstm", "lstm_train_profile")):
        _, batch, size = run.CASES[model_name]
        model = harness.init_model(run.build_model(
            model_name, torch.bfloat16, size, train=True), 0, "cuda")
        shape = ((batch, run.LSTM_STEPS, size) if model_name == "lstm"
                 else (batch, size, size, 3))
        x = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
        labels = torch.zeros(batch, dtype=torch.long, device="cuda")
        step = harness.make_train_fn(model, harness.sgd(model))
        state = harness.init_train_state(model)
        emit(case, batch=batch, **_profile(lambda: step(state, x, labels), 3,
                                           top=12))


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
    report.update(_lm_correctness())
    report.update(_moe_correctness())
    emit("correctness", **report)


def _lm_correctness() -> dict:
    """The LM at LM_CONFIG's widths and depth on 2 x 64 tokens: on the
    card with K3 against the same weights on the CPU with the plain
    absorb, fp32 (TF32 off) to 1e-4 of the largest logit and bf16 to
    5e-2 (the bf16 bound above); then greedy decoding on the card (fp32,
    prompt 2 x 16, 8 tokens) token for token against its from-scratch
    recompute through K3."""
    import torch
    from k8s_device_plugin_torch.workloads import decode, run
    from k8s_device_plugin_torch.workloads.attention import (init_lm_params,
                                                             lm_forward)
    heads, dim, vocab, layers = run.LM_CONFIG
    ref = init_lm_params(torch.Generator().manual_seed(0), vocab, dim, heads,
                         layers, device="cpu")
    tokens = torch.randint(0, vocab, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = lm_forward(ref, tokens, use_flash=True)
    scale = want.abs().max().item()
    report = {"lm_max_logit": scale}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        model = init_lm_params(torch.Generator().manual_seed(0), vocab, dim,
                               heads, layers, dtype=dtype, device="cuda")
        model.load_state_dict(ref.state_dict())
        with torch.inference_mode():
            got = lm_forward(model, tokens.to("cuda"), use_flash=True).cpu()
        err = check_close(f"lm {dtype}", got.float() / scale, want / scale,
                          tol)
        report[f"lm_{str(dtype).split('.')[1]}_rel_err"] = err
    model = ref.to("cuda")
    prompt = tokens[:, :16].to("cuda")
    got = decode.generate(model, prompt, steps=8)
    want = decode.reference_generate(
        model, prompt, steps=8,
        forward=lambda p, t: lm_forward(p, t, use_flash=True))
    if not torch.equal(got, want):
        raise AssertionError(f"greedy decode on the card: {got.tolist()} "
                             f"!= recompute {want.tolist()}")
    report["lm_greedy_tokens_exact"] = int(got.numel() - prompt.numel())
    return report


def _moe_correctness() -> dict:
    """The MoE LM at LM_CONFIG's widths and depth, 8 experts, on 2 x 64
    tokens in 2 x 2 routing blocks: on the card through K3 against the
    same weights on the CPU through the plain absorb, in fp32 with TF32
    off, the logits to 1e-4 of the largest and the aux loss to 1e-5, with
    the count of routing decisions (token and layer) that differ between
    the two: a flip moves a token's output by O(1), so the bound holds
    only without one. Then greedy ``moe_generate`` on the card (fp32,
    prompt 2 x 16, 8 tokens) token for token against its from-scratch
    recompute at drop-free capacity through K3."""
    import copy

    import torch
    from k8s_device_plugin_torch.workloads import decode, moe, run
    heads, dim, vocab, layers = run.LM_CONFIG
    ref = moe.init_moe_lm_params(torch.Generator().manual_seed(0), vocab,
                                 dim, heads, layers,
                                 n_experts=run.MOE_EXPERTS, device="cpu")
    model = copy.deepcopy(ref).to("cuda")
    tokens = torch.randint(0, vocab, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    with no_tf32(), torch.inference_mode():
        (want, aux_want), cpu_routes = _routes(lambda: moe.moe_lm_forward(
            ref, tokens, use_flash=True, shard_shape=(2, 2)))
        (got, aux_got), card_routes = _routes(lambda: moe.moe_lm_forward(
            model, tokens.to("cuda"), use_flash=True, shard_shape=(2, 2)))
    flips = sum(int((a != b.cpu()).sum()) for a, b in zip(cpu_routes,
                                                          card_routes))
    n_decisions = sum(d.numel() for d in cpu_routes)
    emit("moe_lm_routing", decisions=n_decisions, flips=flips)
    scale = want.abs().max().item()
    err = check_close("moe-lm fp32", got.cpu() / scale, want / scale, 1e-4)
    aux_err = abs(aux_got.item() - aux_want.item())
    if not aux_err <= 1e-5 * (1 + abs(aux_want.item())):
        raise AssertionError(f"moe-lm aux {aux_got.item()} != "
                             f"{aux_want.item()}")
    report = {"moe_lm_max_logit": scale, "moe_lm_float32_rel_err": err,
              "moe_lm_aux_err": aux_err, "moe_lm_routing_decisions":
              n_decisions, "moe_lm_routing_flips": flips}
    prompt = tokens[:, :16].to("cuda")
    with no_tf32():
        got = decode.moe_generate(model, prompt, steps=8)
        want = decode.reference_generate(
            model, prompt, steps=8,
            forward=lambda p, t: moe.moe_lm_forward(
                p, t, capacity_factor=float(run.MOE_EXPERTS),
                use_flash=True)[0])
    if not torch.equal(got, want):
        raise AssertionError(f"moe greedy decode on the card: "
                             f"{got.tolist()} != recompute {want.tolist()}")
    report["moe_lm_greedy_tokens_exact"] = int(got.numel() - prompt.numel())
    return report


def _train_step_on(device, model, step, *batch) -> tuple:
    """``model`` (on the CPU) copied to ``device``, one ``step(model,
    *batch)`` there: (loss, state_dict before, state_dict after,
    gradients), on the CPU in fp64."""
    import copy

    import torch
    model = copy.deepcopy(model).to(device)
    before = {k: v.detach().double().cpu().clone() for k, v in
              model.state_dict().items()}
    loss = step(model, *(t.to(device) for t in batch))
    after = {k: v.detach().double().cpu() for k, v in
             model.state_dict().items()}
    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
    return loss.item(), before, after, grads


def _check_update(what, model, got, want, tol: float) -> dict:
    """Each parameter's gradient and update p1 - p0 on the card (``got``,
    ``want``: ``_train_step_on``'s results) against the CPU's, each within
    ``tol`` of its largest magnitude; the update plus 2 fp32 ulps of the
    weights (the rounding floor of p1 - p0 itself). Returns the largest
    errors over those magnitudes."""
    import torch
    worst = {"grad_err": 0.0, "update_err": 0.0}
    for name, _ in model.named_parameters():
        g_got, g_want = got[3][name], want[3][name]
        d_got = got[2][name] - got[1][name]
        d_want = want[2][name] - want[1][name]
        floor = 2 * torch.finfo(torch.float32).eps * \
            want[1][name].abs().max().item()
        for key, a, b, slack in (("grad_err", g_got, g_want, 0.0),
                                 ("update_err", d_got, d_want, floor)):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            if not (scale > 0 and err <= tol * scale + slack):
                raise AssertionError(f"{what} {key} of {name}: {err} over "
                                     f"{tol} x {scale} + {slack}")
            worst[key] = max(worst[key], err / scale)
    return worst


def _resnet_loss_close(got: float, want: float, tol: float,
                       what: str = "resnet50") -> float:
    if not abs(got - want) <= tol * (1 + abs(want)):
        raise AssertionError(f"{what} loss {got} != {want}")
    return abs(got - want)


def _check_resnet_update(net, got, want, dtype, tol: float,
                         stats_tol: float, what: str = "resnet50") -> dict:
    """A BatchNorm network's update on the card (``got``) against the
    CPU's: in fp64 each parameter's within ``tol`` of its L2 norm, in fp32
    all of them together (one flipped ReLU mask moves a channel); each
    BatchNorm running statistic within ``stats_tol`` of its largest
    magnitude."""
    import torch
    names = [n for n, _ in net.named_parameters()]
    moves = [(got[2][n] - got[1][n], want[2][n] - want[1][n]) for n in names]
    if dtype == torch.float32:
        moves = [tuple(torch.cat([m[i].flatten() for m in moves])
                       for i in range(2))]
    l2 = 0.0
    for (d_got, d_want), name in zip(moves, names):
        err = ((d_got - d_want).norm() / d_want.norm()).item()
        if not err <= tol:
            raise AssertionError(f"{what} {dtype} update of "
                                 f"{name if len(moves) > 1 else 'all'}: "
                                 f"relative L2 {err}")
        l2 = max(l2, err)
    stats = 0.0
    for n in want[2]:
        if n.endswith(("running_mean", "running_var")):
            w = want[2][n]
            err = ((got[2][n] - w).abs().max() / w.abs().max()).item()
            if not err <= stats_tol:
                raise AssertionError(f"{what} {dtype} {n}: {err}")
            stats = max(stats, err)
    return {"update_rel_l2": l2, "bn_stats_err": stats}


def phase_train_correctness() -> None:
    """One train step on the card against the same step on the CPU from
    the same weights, fp32 with TF32 off, at the bounds of
    tests/test_torch_train*.py: the LM at LM_CONFIG's widths on 2 x 65
    tokens through the flash absorb (K3 on the card, 32-token chunks, 3
    absorbs a layer) and plain SGD, the loss at 1e-5 and each update within
    1e-4 of its largest magnitude (each gradient too); the LSTM (batch
    4 x 8 steps, K2) with SGD-momentum, the same bounds; ResNet-50 with
    SGD-momentum at batch 2 @ 64, first in fp32, where a ReLU mask
    flipped by rounding moves a channel's whole gradient: the loss at
    1e-5, the whole update within 5e-2 in relative L2 (1.2e-3 to 1.6e-2
    read on an H100, as cuDNN's choice of algorithms varies from run to
    run), each BatchNorm running statistic within 2e-4 of its largest
    magnitude (2.6e-5 to 4.2e-5 read); then in fp64 (its fp32
    head aside) on another batch of that size, at the bounds of
    tests/test_torch_train_models.py: the loss at 1e-6, each parameter's
    update within 1e-4 of its L2 norm, each running statistic within
    1e-6."""
    import numpy as np
    import torch
    from k8s_device_plugin_torch import _build
    from k8s_device_plugin_torch.workloads import flash, harness, moe, run
    from k8s_device_plugin_torch.workloads.attention import (init_lm_params,
                                                             lm_loss)
    from k8s_device_plugin_torch.workloads.deeplab import DeepLabV3
    from k8s_device_plugin_torch.workloads.lstm import LSTMClassifier
    from k8s_device_plugin_torch.workloads.resnet import resnet50
    from k8s_device_plugin_torch.workloads.vgg import VGG16

    def sgd_step(loss_of, momentum):
        def step(model, *batch):
            optimizer = harness.sgd(model, momentum=momentum)
            harness.init_train_state(model)
            loss = loss_of(model, *batch)
            loss.backward()
            optimizer.step()
            return loss
        return step

    def loss_close(what, got, want):
        if not abs(got - want) <= 1e-5 * (1 + abs(want)):
            raise AssertionError(f"{what} loss {got} != {want}")
        return abs(got - want)

    report = {}
    rng = np.random.default_rng(12)
    with no_tf32():
        heads, dim, vocab, layers = run.LM_CONFIG
        lm = init_lm_params(torch.Generator().manual_seed(0), vocab, dim,
                            heads, layers, device="cpu")
        tokens = torch.randint(0, vocab, (2, 65),
                               generator=torch.Generator().manual_seed(1))
        step = sgd_step(lambda m, t: lm_loss(m, t, use_flash=True,
                                             flash_seq_block=32), 0.0)
        want = _train_step_on("cpu", lm, step, tokens)
        launches = _build.launches["flash_absorb"]
        got = _train_step_on("cuda", lm, step, tokens)
        if _build.launches["flash_absorb"] - launches != 3 * layers:
            raise AssertionError("the LM train step did not run K3 3 times "
                                 "a layer")
        report["lm"] = {"loss": got[0],
                        "loss_err": loss_close("lm", got[0], want[0]),
                        **_check_update("lm", lm, got, want, 1e-4)}

        features = LSTM_CASE[1]
        lstm = harness.init_model(LSTMClassifier(features,
                                                 dtype=torch.float32),
                                  0, "cpu")
        x = torch.from_numpy(rng.standard_normal(
            (4, 8, features)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 2, (4,)))
        step = sgd_step(lambda m, x, y: harness.cross_entropy(m(x), y), 0.9)
        want = _train_step_on("cpu", lstm, step, x, labels)
        got = _train_step_on("cuda", lstm, step, x, labels)
        report["lstm"] = {"loss": got[0],
                          "loss_err": loss_close("lstm", got[0], want[0]),
                          **_check_update("lstm", lstm, got, want, 1e-4)}

        for dtype, tol in ((torch.float32, (1e-5, 5e-2, 2e-4)),
                           (torch.float64, (1e-6, 1e-4, 1e-6))):
            net = harness.init_model(resnet50(dtype=dtype), 0, "cpu")
            net.to(dtype).head.float()  # the head stays fp32
            x = torch.from_numpy(rng.standard_normal(
                (2, 64, 64, 3)).astype(np.float32)).to(dtype)
            labels = torch.from_numpy(rng.integers(0, 1000, (2,)))
            want = _train_step_on("cpu", net, step, x, labels)
            got = _train_step_on("cuda", net, step, x, labels)
            report[f"resnet50_{str(dtype).split('.')[1]}"] = {
                "loss": got[0],
                "loss_err": _resnet_loss_close(got[0], want[0], tol[0]),
                **_check_resnet_update(net, got, want, dtype, *tol[1:])}

        # the MoE LM: 2 x 65 tokens in 2 x 2 routing blocks, one
        # whole-sequence absorb a layer (K3 on the card), plain SGD
        moe_lm = moe.init_moe_lm_params(
            torch.Generator().manual_seed(0), vocab, dim, heads, layers,
            n_experts=run.MOE_EXPERTS, device="cpu")
        tokens = torch.randint(0, vocab, (2, 65),
                               generator=torch.Generator().manual_seed(2))
        step = sgd_step(lambda m, t: moe.moe_lm_loss(
            m, t, use_flash=True, shard_shape=(2, 2)), 0.0)
        want = _train_step_on("cpu", moe_lm, step, tokens)
        launches = _build.launches["flash_absorb"]
        got = _train_step_on("cuda", moe_lm, step, tokens)
        if _build.launches["flash_absorb"] - launches != layers:
            raise AssertionError("the MoE LM train step did not run K3 once "
                                 "a layer")
        report["moe_lm"] = {"loss": got[0],
                            "loss_err": loss_close("moe-lm", got[0], want[0]),
                            **_check_update("moe_lm", moe_lm, got, want,
                                            1e-4)}

        # VGG-16 at batch 2 @ 32, dropout off (no generator), SGD-momentum
        vgg = harness.init_model(VGG16(image_size=32, dtype=torch.float32),
                                 0, "cpu")
        x = torch.from_numpy(rng.standard_normal(
            (2, 32, 32, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 1000, (2,)))
        step = sgd_step(lambda m, x, y: harness.cross_entropy(m(x), y), 0.9)
        want = _train_step_on("cpu", vgg, step, x, labels)
        got = _train_step_on("cuda", vgg, step, x, labels)
        report["vgg16"] = {"loss": got[0],
                           "loss_err": loss_close("vgg16", got[0], want[0]),
                           **_check_update("vgg16", vgg, got, want, 1e-4)}

        # DeepLab-v3 (full backbone, 21 classes) at the runner's train
        # batch 1, @ 64, in fp64 (its fp32 classifier and resize aside),
        # at the bounds of ResNet-50's fp64 step
        net = harness.init_model(DeepLabV3(dtype=torch.float64), 0,
                                 "cpu").double()
        x = torch.from_numpy(rng.standard_normal((1, 64, 64, 3)))
        labels = torch.from_numpy(rng.integers(0, 21, (1, 64, 64)))
        step = sgd_step(lambda m, x, y: harness.seg_cross_entropy(m(x), y),
                        0.9)
        want = _train_step_on("cpu", net, step, x, labels)
        got = _train_step_on("cuda", net, step, x, labels)
        report["deeplab_float64"] = {
            "loss": got[0],
            "loss_err": _resnet_loss_close(got[0], want[0], 1e-6, "deeplab"),
            **_check_resnet_update(net, got, want, torch.float64, 1e-4, 1e-6,
                                   "deeplab")}
    emit("train_correctness", **report)


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
    card = phase_card()
    phase_build()
    phase_compile_cache()
    kernels = {"probe_chain": phase_probe_kernel(),
               "lstm_cell": phase_lstm_kernel(),
               "lstm_sequence": phase_lstm_sequence_kernel(),
               "flash_absorb": phase_flash_kernel(),
               "flash_window": phase_flash_window_kernel(),
               **phase_bn_relu_kernel(), **phase_swiglu_kernel()}
    attention = phase_flash_grad()
    phase_lstm_grad()
    phase_enforcement_card(card)
    by_path = phase_main_path()
    by_path.update(phase_multichip_card())
    by_path.update(phase_multichip_moe())
    phase_pipeline_card()
    phase_checkpoint_card()
    phase_lm_profile()
    phase_lm_train_profile(attention)
    phase_model_train_profiles()
    phase_moe_profile()
    by_path.update(phase_lfm2_moe())
    by_path.update(phase_afmoe())
    _check_own_paths(by_path)
    launches = {name: sum(p[name] for p in by_path.values())
                for name in kernels}
    phase_correctness()
    phase_train_correctness()
    for name, k in kernels.items():
        k["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--enforcement-child"]:
        sys.exit(_enforcement_child(sys.argv[2]))
    sys.exit(main())
