"""In-container benchmark runner (the ai-benchmark image entrypoint).

Counterpart of ``k8s_device_plugin_tpu/workloads/run.py``: runs one of the
suite's models, activates the cooperative limiter (so memory and
duty-cycle caps are honored and usage lands in the shared region for the
monitor), and prints steady-state throughput as the same JSON fields.
Every model of the JAX runner is ported, on one device: ``resnet50``,
``resnet152``, ``vgg16``, ``deeplab`` and ``lstm`` in ``--mode infer`` and
``--mode train``, and the long-context ``lm`` and ``moe-lm`` in ``--mode
infer`` and ``--mode train`` (on the card their attention runs through the
flash-absorb kernel, in training with the recompute backward) and ``--mode
decode`` (KV-cache serving); ``--multichip`` exits with "not yet ported".
Under ``VTPU_COMPILE_CACHE_DIR`` the kernels build into the compile cache
and the run vouches for ``VTPU_COMPILE_CACHE_KEY`` after its first call
(``harness.setup_compile_cache``).

Usage:
  python3 -m k8s_device_plugin_torch.workloads.run --model lstm \
      [--mode infer|train] [--batch N] [--size S] [--steps K] \
      [--device cuda|cpu]
  python3 -m k8s_device_plugin_torch.workloads.run --model lm|moe-lm \
      --mode infer|train|decode [--batch N] [--size SEQ] [--steps K]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..api import TPU_COMPILE_CACHE_KEY

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
PORTED = {"resnet50": ("infer", "train"), "resnet152": ("infer", "train"),
          "vgg16": ("infer", "train"), "deeplab": ("infer", "train"),
          "lstm": ("infer", "train"), "lm": ("infer", "train", "decode"),
          "moe-lm": ("infer", "train", "decode")}
#: time steps of the LSTM case's input sequence (as the JAX runner)
LSTM_STEPS = 64
#: one LM shape for every lm mode: heads, dim, vocab, layers
LM_CONFIG = (8, 512, 8192, 4)
#: tokens decoded per call in --mode decode; --steps = calls per round
DECODE_LEN = 32
#: experts per MoE layer on one device (the JAX runner's max(8, 2 sp))
MOE_EXPERTS = 8
#: tokens of one routing group of the MoE LM (one block of a sequence)
MOE_GROUP = 1024


def build_model(name: str, dtype: torch.dtype, size: int,
                train: bool = False):
    """The model of case ``name``; ``size`` is the LSTM's feature width and
    VGG's image size. To train, the convolutional models keep fp32 weights
    (Flax's ``param_dtype``) and compute in ``dtype``; the LSTM keeps its
    weights in ``dtype``, as the JAX cell declares them."""
    from .deeplab import DeepLabV3
    from .lstm import LSTMClassifier
    from .resnet import resnet50, resnet152
    from .vgg import VGG16
    param_dtype = torch.float32 if train else dtype
    if name == "resnet50":
        return resnet50(dtype=dtype, param_dtype=param_dtype)
    if name == "resnet152":
        return resnet152(dtype=dtype, param_dtype=param_dtype)
    if name == "vgg16":
        return VGG16(image_size=size, dtype=dtype, param_dtype=param_dtype)
    if name == "deeplab":
        return DeepLabV3(dtype=dtype, param_dtype=param_dtype)
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
    # the kernels are on disk now, if setup_compile_cache pointed the
    # builds at the cache: vouch for this pod's key, so the monitor
    # reports the host warm and the scheduler places the next one here
    cache_dir = harness.active_compile_cache_dir()
    if cache_dir:
        harness.record_compile_cache_key(
            os.environ.get(TPU_COMPILE_CACHE_KEY, ""), cache_dir)
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


def _run_lm(args, batch: int, seq: int, device, limiter) -> int:
    """The long-context causal LM (``--model lm``) or its Switch-MoE
    variant (``moe-lm``, ``MOE_EXPERTS`` experts of hidden 4 dim) at
    ``LM_CONFIG`` in bf16, random weights from seed 0, tokens from seed 1.
    On the card attention runs through the flash absorb: one
    whole-sequence causal absorb per layer to infer (the dense oracle would
    hold [B, H, T, T] fp32 scores, 1 GiB a layer at 8 x 2048); to train the
    LM, ``lm_loss``'s 1024-token chunks, whose recompute backward holds one
    [B, H, 1024, 1024] score block at a time; the MoE LM trains on
    whole-sequence absorbs, as the JAX ``moe_lm_loss`` passes no chunking.
    Training is plain SGD on the bf16 weights (``p - 1e-3 g``). The MoE LM
    routes each ``MOE_GROUP``-token block of each sequence on its own
    (``shard_shape``), the sequence padded to whole blocks, as the JAX
    runner bounds its [N, E, C] dispatch tensors. On the CPU attention is
    the dense oracle, as the JAX runner off the TPU."""
    from . import harness
    from .attention import init_lm_params, lm_forward, lm_loss
    from .moe import init_moe_lm_params, moe_lm_forward, moe_lm_loss
    heads, dim, vocab, layers = LM_CONFIG
    seed = torch.Generator().manual_seed(0)
    if args.model == "moe-lm":
        model = init_moe_lm_params(seed, vocab, dim, heads, layers,
                                   n_experts=MOE_EXPERTS,
                                   dtype=torch.bfloat16, device=device)
    else:
        model = init_lm_params(seed, vocab, dim, heads, layers,
                               dtype=torch.bfloat16, device=device)
    use_flash = device.type == "cuda"
    if args.model == "moe-lm" and args.mode != "decode":
        seq = -(-seq // MOE_GROUP) * MOE_GROUP
        shard_shape = (batch, seq // MOE_GROUP)

        def forward(t):
            return moe_lm_forward(model, t, use_flash=use_flash,
                                  shard_shape=shard_shape)[0]

        def loss_of(t):
            return moe_lm_loss(model, t, use_flash=use_flash,
                               shard_shape=shard_shape)
    else:
        def forward(t):
            return lm_forward(model, t, use_flash=use_flash)

        def loss_of(t):
            return lm_loss(model, t, use_flash=use_flash)
    # +1 to train: the next-token shift leaves ``seq`` positions
    length = seq + 1 if args.mode == "train" else seq
    tokens = torch.randint(0, vocab, (batch, length),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    if args.mode == "decode":
        return _run_lm_decode(args, model, tokens, device, limiter)
    if args.mode == "infer":
        def call():
            with torch.inference_mode():
                return forward(tokens)
    else:
        optimizer = harness.sgd(model, momentum=0.0)

        def call():
            optimizer.zero_grad(set_to_none=True)
            loss = loss_of(tokens)
            loss.backward()
            optimizer.step()
            return loss
    return _bench_loop(
        args, call, device, limiter, batch,
        lambda dt: {"model": args.model, "mode": args.mode, "seq": seq,
                    "tokens_per_s": round(batch * seq * args.steps / dt, 2),
                    "sp": 1})


def _run_lm_decode(args, model, prompt, device, limiter) -> int:
    """KV-cache serving: the prompt is prefilled once, cold
    (``prefill_compile_s``: CUDA context, library handles and kernel
    builds included, as the JAX runner's first call includes its
    compile), then once more, timed (``prefill_s``); every timed round
    decodes ``DECODE_LEN`` tokens per call from that prefilled state. The
    MoE LM's feed-forward is the drop-free expert apply."""
    from . import harness
    from .decode import decode_from, dropfree_moe_ffn, prefill
    ffn = dropfree_moe_ffn if args.model == "moe-lm" else None
    batch, seq = prompt.shape
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        state = prefill(model, prompt, steps_budget=DECODE_LEN, ffn=ffn)
        harness.synchronize(device)
        times.append(time.perf_counter() - t0)
    prefill_compile_s, prefill_s = times
    return _bench_loop(
        args, lambda: decode_from(model, *state, steps=DECODE_LEN, ffn=ffn),
        device, limiter, batch,
        lambda dt: {
            "model": args.model, "mode": "decode", "prompt": seq,
            "prefill_s": round(prefill_s, 3),
            "prefill_compile_s": round(prefill_compile_s, 3),
            "gen_tokens_per_s": round(batch * DECODE_LEN * args.steps / dt,
                                      2)})


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

    if args.mode == "decode" and args.model not in ("lm", "moe-lm"):
        raise SystemExit("--mode decode supports --model lm / moe-lm only")
    if args.mode not in PORTED.get(args.model, ()) or args.multichip:
        raise SystemExit(
            f"--model {args.model} --mode {args.mode}"
            f"{' --multichip' if args.multichip else ''} is not yet ported "
            f"(ported, on one device: "
            + ", ".join(f"{m} in --mode {'/'.join(modes)}"
                        for m, modes in PORTED.items()) + ")")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device visible")
        torch.backends.cudnn.benchmark = True

    from ..shm import limiter as limiter_mod
    from . import harness

    limiter = limiter_mod.install()  # no-op without the vTPU env contract
    # no-op without VTPU_COMPILE_CACHE_DIR; before any kernel builds
    harness.setup_compile_cache()
    infer_b, train_b, size = CASES[args.model]
    # decode is an inference-side workload: serving batch, not train
    batch = args.batch or (train_b if args.mode == "train" else infer_b)
    size = args.size or size
    if args.model in ("lm", "moe-lm"):
        return _run_lm(args, batch, size, device, limiter)
    train = args.mode == "train"
    model = harness.init_model(
        build_model(args.model, torch.bfloat16, size, train), 0, device)
    if args.model == "lstm":
        x = torch.ones(batch, LSTM_STEPS, size, dtype=torch.bfloat16,
                       device=device)
    else:
        x = torch.ones(batch, size, size, 3, dtype=torch.bfloat16,
                       device=device)
    if train:
        # DeepLab labels every pixel
        labels = torch.zeros((batch, size, size) if args.model == "deeplab"
                             else (batch,), dtype=torch.long, device=device)
        step = harness.make_train_fn(
            model, harness.sgd(model), loss_fn=harness.seg_cross_entropy
            if args.model == "deeplab" else harness.cross_entropy,
            has_dropout=args.model == "vgg16")
        state = harness.init_train_state(model)

        def call():
            nonlocal state
            state, loss = step(state, x, labels)
            return loss
    else:
        infer = harness.make_infer_fn(model)

        def call():
            return infer(x)
    return _bench_loop(args, call, device, limiter, batch,
                       lambda dt: {"model": args.model, "mode": args.mode})


if __name__ == "__main__":
    sys.exit(main())
