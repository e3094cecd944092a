"""In-container benchmark runner (the ai-benchmark image entrypoint).

Counterpart of ``k8s_device_plugin_tpu/workloads/run.py``: runs one of the
suite's models, activates the cooperative limiter (so memory and
duty-cycle caps are honored and usage lands in the shared region for the
monitor), and prints steady-state throughput as the same JSON fields.
Ported so far: ``resnet50``, ``resnet152`` and ``lstm`` in ``--mode infer``
on one device; other models and modes exit with "not yet ported".

Usage:
  python3 -m k8s_device_plugin_torch.workloads.run --model lstm \
      [--batch N] [--size S] [--steps K] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

# defaults follow docs/benchmark.md:18-31 test cases
CASES = {
    # model: (infer_batch, train_batch, size)
    "resnet50": (50, 20, 346),
    "resnet152": (10, 10, 256),
    "vgg16": (20, 2, 224),
    "deeplab": (2, 1, 512),
    "lstm": (100, 10, 300),
    "lm": (8, 4, 2048),
    "moe-lm": (8, 4, 2048),
}
PORTED = ("resnet50", "resnet152", "lstm")
#: time steps of the LSTM case's input sequence (as the JAX runner)
LSTM_STEPS = 64


def build_model(name: str, dtype: torch.dtype, size: int):
    """The model of case ``name``; ``size`` is the LSTM's feature width."""
    from .lstm import LSTMClassifier
    from .resnet import resnet50, resnet152
    if name == "resnet50":
        return resnet50(dtype=dtype)
    if name == "resnet152":
        return resnet152(dtype=dtype)
    if name == "lstm":
        # the fused cell: the CUDA kernel on a card, its plain version on CPU
        return LSTMClassifier(features=size, dtype=dtype)
    raise SystemExit(f"model {name} is not yet ported")


def _bench_loop(args, call, device, limiter, batch: int, extra_fn) -> int:
    """Steady-state loop: warmup, then timed rounds of ``--steps`` calls
    with a cooperative throttle checkpoint after each, one JSON line per
    round. ``compile_s`` is the cold-start cost and ``warmup_step_s`` one
    steady execution (see harness.timed_warmup)."""
    from . import harness
    compile_s, warm_step_s = harness.timed_warmup(call, device)
    while True:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            call()
            if limiter is not None:
                limiter.throttle(1000)  # cooperative duty-cycle checkpoint
        harness.synchronize(device)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "batch": batch,
            "items_per_s": round(batch * args.steps / dt, 2),
            "compile_s": round(compile_s, 3),
            "warmup_step_s": round(warm_step_s, 3),
            "hbm_violations": limiter.violations if limiter else 0,
            **extra_fn(dt),
        }), flush=True)
        if not args.forever:
            return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser("vtpu-workload-torch")
    p.add_argument("--model", default="resnet50", choices=sorted(CASES))
    p.add_argument("--mode", default="infer",
                   choices=["infer", "train", "decode"])
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--forever", action="store_true",
                   help="loop until killed (service pods)")
    p.add_argument("--multichip", action="store_true",
                   help="shard over all visible devices (not yet ported)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.model not in PORTED or args.mode != "infer" or args.multichip:
        raise SystemExit(
            f"--model {args.model} --mode {args.mode}"
            f"{' --multichip' if args.multichip else ''} is not yet ported "
            f"(ported: {', '.join(PORTED)} in --mode infer on one device)")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device visible")
        torch.backends.cudnn.benchmark = True

    from ..shm import limiter as limiter_mod
    from . import harness

    limiter = limiter_mod.install()  # no-op without the vTPU env contract
    infer_b, _, size = CASES[args.model]
    batch = args.batch or infer_b
    size = args.size or size
    model = harness.init_model(
        build_model(args.model, torch.bfloat16, size), 0, device)
    if args.model == "lstm":
        x = torch.ones(batch, LSTM_STEPS, size, dtype=torch.bfloat16,
                       device=device)
    else:
        x = torch.ones(batch, size, size, 3, dtype=torch.bfloat16,
                       device=device)
    infer = harness.make_infer_fn(model)
    return _bench_loop(args, lambda: infer(x), device, limiter, batch,
                       lambda dt: {"model": args.model, "mode": args.mode})


if __name__ == "__main__":
    sys.exit(main())
