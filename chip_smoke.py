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
   flash absorb also its mma.sync route and its rounded-P variant;
4. gradients: the flash absorb's ``autograd.Function`` (K3 forward,
   recompute backward) against dense attention's gradients, in fp32, and
   in bf16 at the LM's train chunking and at the MoE LM's whole-sequence
   absorbs, with forward and forward + backward times beside dense
   attention's and SDPA's; the LSTM's gradients through K2 against the
   plain cell's at case 5.2;
4b. enforcement (``enforcement_card``): the shim on the card, in fresh
   processes under it with a 4 GiB cap: 512 MiB tensors until it refuses
   one, the same past the cap under ``VTPU_OVERSUBSCRIBE=1``, a K2 launch
   loop at core limit 50 against 0 (the ratio in the duty band), K1, K2
   and K3 under it against their plain versions, and the kill switch;
   every line with the card's name and power limit;
5-12. the main paths, each with every launch counter set to 0 just before
   it and read just after: ResNet-50 bf16 at ai-benchmark case 1.1
   (batch 50 @ 346) natively and as a 4-way share under the enforcement
   shim with the duty probe sampling beside it, then the bench's
   oversubscribe phase (10 replicas at 8 @ 64 past a 64 MiB cap under
   ``VTPU_OVERSUBSCRIBE=1``: spill above 0, no violation) and its duty
   check (case 1.1 at core limit 0 and 50: the ratio in [0.35, 0.65]),
   all wrapped (``bench.measure``), and the share once more under the
   cooperative limiter, beside it;
   LSTM case 5.1 inference through the runner; the long-context LM
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
   family and the device's idle share;
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
#: steps of each train path through the runner (after its 2 warm-up calls)
TRAIN_STEPS = {"lm": 3, "resnet50": 10, "resnet152": 5, "lstm": 5,
               "moe-lm": 3, "vgg16": 5, "deeplab": 3}
#: calls per timed round of the MoE LM and the segmentation and VGG paths'
#: inference (after 2 warm-up calls)
INFER_STEPS = {"moe-lm": 5, "vgg16": 10, "deeplab": 5}


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
        launches = flash.flash_absorb.launches
        got = _grads(lambda *a, sb=sb: flash.flash_attention(
            *a, seq_block=sb), (q, k, v))
        launches = flash.flash_absorb.launches - launches
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
            launches = pallas_ops.lstm_cell.launches
            with no_tf32():
                model.zero_grad(set_to_none=True)
                harness.cross_entropy(model(x), labels).backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
            if not plain and (pallas_ops.lstm_cell.launches - launches
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


#: the enforcement phase's slice: a 4 GiB cap, filled in 512 MiB tensors
ENFORCE_CAP = 4 << 30
ENFORCE_CHUNK = 512 << 20
#: how far the shim's charge may be from the allocator's reserve plus the
#: context: one segment of PyTorch's medium pool (kLargeBuffer, 20 MiB)
ENFORCE_SLACK = 20 << 20
#: seconds each leg of the K2 duty loop is timed
K2_LOOP_S = 1.0


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


def _fill(region, dev, limit: int) -> dict:
    """512 MiB tensors until the shim refuses one or ``limit`` are held:
    the allocator's reserve and the region's usage after each."""
    import torch
    from k8s_device_plugin_torch import bench
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
                      region.device_used(0)))
    used, spill, violations = bench.shim_accounting(region, cap, dev)
    return {"refused_at": refused, "allocations": len(tensors),
            "reserved": [r for r, _ in steps], "used": [u for _, u in steps],
            "reserved_at_end": torch.cuda.memory_reserved(dev),
            "used_at_end": region.device_used(0),
            "max_reserved": torch.cuda.max_memory_reserved(dev),
            "mem_get_info": list(torch.cuda.mem_get_info(dev)),
            "spill": spill, "violations": violations, "final_used": used}


def _k2_loop(region, dev) -> dict:
    """K2 at case 5.1 against its plain version under the shim, then its
    own entry on preallocated outputs in a loop for ``K2_LOOP_S``: the loop
    launches faster than the card runs the kernel, so uncapped it is bound
    by the card, and a core limit's share shows in its rate. Under a
    limit, the bucket's burst is spent first."""
    import torch
    from k8s_device_plugin_torch import _build, bench
    from k8s_device_plugin_torch.workloads import pallas_ops
    args = _lstm_args(*LSTM_CASE, torch.bfloat16)
    x, h, c, wx, wh, b = args
    err = max(check_close(f"lstm_cell under the shim {name}", g, w, 2e-2)
              for name, g, w in zip("hc", pallas_ops.lstm_cell(*args),
                                    pallas_ops.lstm_cell_reference(*args)))
    lib = _build.load("lstm_cell", pallas_ops._ARGTYPES)
    route = pallas_ops.cell_route(x, h, wx, wh)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    batch, features, hidden = LSTM_CASE
    call = [pallas_ops.ROUTES[route], x.data_ptr(), h.data_ptr(),
            c.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), batch, features, hidden,
            torch.cuda.current_stream(dev).cuda_stream]

    def launch():
        _build.check(lib, lib.vtpu_lstm_cell(*call), "lstm_cell loop")
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


def _enforcement_child(case: str) -> int:
    """One case of ``phase_enforcement_card``, in a process started with
    the shim preloaded and the VTPU_* contract set (``bench._child_env``);
    prints one JSON line. ``main``: 512 MiB tensors until the shim
    refuses one (before anything else is allocated), then, with them
    freed, K1, K2 and K3 against their plain versions and the K2 loop;
    ``capped`` (under a core limit and ``VTPU_OVERSUBSCRIBE``): the K2
    loop, then the tensors past the cap; ``disabled``: the kill switch."""
    cap = int(os.environ["VTPU_DEVICE_MEMORY_LIMIT_0"])
    out = {"case": case}
    if case == "disabled":
        out.update(_kill_switch_child(cap))
        print(json.dumps(out), flush=True)
        return 0
    import numpy as np
    import torch
    from k8s_device_plugin_torch import bench
    from k8s_device_plugin_torch.monitor import dutyprobe
    from k8s_device_plugin_torch.shm.region import KIND_CONTEXT
    from k8s_device_plugin_torch.workloads import run
    dev = torch.device("cuda")
    region = bench.shim_region(cap, dev)
    slot = next(p for p in region.active_procs() if p.pid == os.getpid())
    out["context_bytes"] = slot.used[0].kinds[KIND_CONTEXT]
    del slot
    if case == "main":
        out["fill"] = _fill(region, dev, 64)
        torch.cuda.empty_cache()
        # K1 (a static-cudart library's launches) and K3 at the LM case
        xw = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in dutyprobe.probe_operands(128)]
        out["probe_chain_err"] = check_close(
            "probe_chain under the shim", dutyprobe.probe_chain(*xw, 16),
            dutyprobe.probe_chain_reference(*xw, 16), 1e-4)
        heads, width, _, _ = run.LM_CONFIG
        batch, _, seq = run.CASES["lm"]
        args = _flash_args(batch, seq, seq, heads, width // heads,
                           torch.bfloat16, 11, True)
        out["flash_absorb"] = {
            f"kind{kind}": _absorb_checked(
                f"flash_absorb under the shim kind {kind}", args, kind, 2e-2)
            for kind in (1, 2)}
        del xw, args
        out["k2"] = _k2_loop(region, dev)
    elif case == "capped":
        out["k2"] = _k2_loop(region, dev)
        out["fill"] = _fill(region, dev, ENFORCE_CAP // ENFORCE_CHUNK + 4)
    else:
        raise SystemExit(f"no enforcement case {case}")
    region.close()
    print(json.dumps(out), flush=True)
    return 0


def _run_wrapped(case: str, workdir: str, shim: str, extra: dict) -> dict:
    """``_enforcement_child(case)`` in a fresh process under the shim, with
    a region of its own and the enforcement phase's cap; its line."""
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
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_enforcement_card(card: str) -> dict:
    """The enforcement shim (``libvtpu_cuda.so``) on the card, in three
    fresh processes under it with a 4 GiB cap each: K1, K2 and K3 under it
    against their plain versions; a K2 launch loop at case 5.1 under
    ``VTPU_DEVICE_CORE_LIMIT=50`` against one without a limit, the rate
    ratio inside ``bench.DUTY_BAND``; 512 MiB tensors until the shim
    refuses one (``torch.OutOfMemoryError``), with the allocator's reserve
    and the region's usage never above the cap, the usage equal to the
    reserve plus the charged context within one segment, and the card
    reporting the cap as its total; the same past the cap under
    ``VTPU_OVERSUBSCRIBE=1`` (spill, no refusal, no violation); and the
    kill switch, under which the whole card shows and nothing is refused.
    Every line carries the card's name and power limit."""
    from k8s_device_plugin_torch import _build, bench
    t0 = time.perf_counter()
    shim = _build.host_library("vtpu_cuda")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-enforce-") as tmp:
        main = _run_wrapped("main", tmp, shim, {})
        capped = _run_wrapped("capped", tmp, shim,
                              {"VTPU_DEVICE_CORE_LIMIT": "50",
                               "VTPU_OVERSUBSCRIBE": "1"})
        off = _run_wrapped("disabled", tmp, shim,
                           {"VTPU_DISABLE_CONTROL": "true"})

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

    fill, ctx = main["fill"], main["context_bytes"]
    gap = [u - (r + ctx) for r, u in zip(fill["reserved"], fill["used"])]
    emit("enforcement_oom", card=card, cap=ENFORCE_CAP, chunk=ENFORCE_CHUNK,
         refused_at=fill["refused_at"],
         reserved_at_refusal=fill["reserved_at_end"],
         used_at_refusal=fill["used_at_end"],
         max_reserved=fill["max_reserved"], context_bytes=ctx,
         used_minus_reserved_and_context=gap,
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
    seconds = time.perf_counter() - t0
    emit("enforcement_card", card=card, seconds=seconds)
    return {"k2_ratio": ratio, "seconds": seconds}


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


def _counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` its launches count."""
    from k8s_device_plugin_torch.monitor import dutyprobe
    from k8s_device_plugin_torch.workloads import flash, pallas_ops
    return {"probe_chain": dutyprobe.probe_chain,
            "lstm_cell": pallas_ops.lstm_cell,
            "flash_absorb": flash.flash_absorb}


def _counting(by_path: dict):
    """``counted(path, fn)``: every launch counter set to 0 just before
    ``fn()`` and read just after, into ``by_path[path]``."""
    counters = _counters()

    def counted(path, fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        by_path[path] = {name: c.launches for name, c in counters.items()}
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

    counters = _counters()
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
         seconds=extra["phase_s"]["oversubscribe"])
    if not (over["replicas"] == 10 and over["spill_bytes"] > 0
            and over["violations"] == 0):
        raise AssertionError(f"oversubscribe phase: {over}")
    emit("bench_duty_check", **duty, band=list(bench.DUTY_BAND),
         batch=extra["batch"], image_size=extra["image_size"],
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

    line = counted("lstm_case_5_1",
                   lambda: _runner_line(["--model", "lstm"]))
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
                for name in counters}
    emit("main_path_launches", **launches, by_path=by_path)
    _check_own_paths(by_path)
    # launches a call: the LM trains on 12 absorbs (3 per layer at
    # 1024-token chunks), the MoE LM on one whole-sequence absorb a layer
    # to infer and to train; the LSTM one cell a time step; the runner
    # makes 2 warm-up calls before its steps. Decode, VGG and DeepLab run
    # no port kernel (cuDNN convolutions, as XLA owns them on the TPU).
    per_call = {("lm_train", "flash_absorb"): (12, TRAIN_STEPS["lm"]),
                ("lstm_train", "lstm_cell"): (64, TRAIN_STEPS["lstm"]),
                ("moe_lm_infer", "flash_absorb"): (4, INFER_STEPS["moe-lm"]),
                ("moe_lm_train", "flash_absorb"): (4, TRAIN_STEPS["moe-lm"])}
    per_call.update({(path, name): (0, 0) for path in (
        "moe_lm_decode", "vgg16_infer", "vgg16_train", "deeplab_infer",
        "deeplab_train") for name in counters})
    for (path, name), (n, steps) in per_call.items():
        calls = steps + 2
        if by_path[path][name] != n * calls:
            raise AssertionError(f"{path}: {by_path[path][name]} {name} "
                                 f"launches in {calls} calls, not {n} each")
    return by_path


def _check_own_paths(by_path: dict) -> None:
    """Each kernel must have run on every path that carries it."""
    own = {"probe_chain": ["resnet50_share"],
           "lstm_cell": ["lstm_case_5_1", "lstm_train"],
           "flash_absorb": ["lm_infer", "lm_train", "moe_lm_infer",
                            "moe_lm_train", "multichip_ring_flash",
                            "multichip_moe_lm_ring_flash"]}
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
        launches = flash.flash_absorb.launches
        got = _train_step_on("cuda", lm, step, tokens)
        if flash.flash_absorb.launches - launches != 3 * layers:
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
        launches = flash.flash_absorb.launches
        got = _train_step_on("cuda", moe_lm, step, tokens)
        if flash.flash_absorb.launches - launches != layers:
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
               "flash_absorb": phase_flash_kernel()}
    attention = phase_flash_grad()
    phase_lstm_grad()
    phase_enforcement_card(card)
    by_path = phase_main_path()
    by_path.update(phase_multichip_card())
    by_path.update(phase_multichip_moe())
    _check_own_paths(by_path)
    phase_pipeline_card()
    phase_checkpoint_card()
    launches = {name: sum(p[name] for p in by_path.values())
                for name in kernels}
    phase_lm_profile()
    phase_lm_train_profile(attention)
    phase_model_train_profiles()
    phase_moe_profile()
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
