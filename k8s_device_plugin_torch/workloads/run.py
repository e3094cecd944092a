"""In-container benchmark runner (the ai-benchmark image entrypoint).

Counterpart of ``k8s_device_plugin_tpu/workloads/run.py``: runs one of the
suite's models, activates the cooperative limiter (so memory and
duty-cycle caps are honored and usage lands in the shared region for the
monitor), and prints steady-state throughput as the same JSON fields.
Every model and mode of the JAX runner is ported: ``resnet50``,
``resnet152``, ``vgg16``, ``deeplab`` and ``lstm`` in ``--mode infer`` and
``--mode train``, and the long-context ``lm`` and ``moe-lm`` in ``--mode
infer`` and ``--mode train`` (on one card their attention runs through the
flash-absorb kernel, in training with the recompute backward) and ``--mode
decode`` (KV-cache serving). ``lfm2_moe``, LFM2-8B-A1B at its published
widths (``lfm2.py``), and ``afmoe``, Trinity-Mini at its published widths
as rank 0 of 4-way expert parallelism (``afmoe.py``: experts 0-31 of each
expert layer's 128), neither with a JAX counterpart, are built here
(:func:`build_model`) for the benchmark's tenant, which fills them with
its seeded weights (``vgpu_bench.tenant.build``; ``chip_smoke.py`` serves
LFM2 so), and are no runner cases. Under ``VTPU_COMPILE_CACHE_DIR`` the kernels
build into the compile cache and the run vouches for
``VTPU_COMPILE_CACHE_KEY`` after its first call
(``harness.setup_compile_cache``).

``--multichip`` shards over every rank of the world the launcher gives
(``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; a world of one
without a launcher, as the JAX runner spans ``jax.devices()`` on one
chip), one device a rank: NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``. The convolutional models and the LSTM run on the (dp,
mp) mesh (``harness.make_mesh``: the batch over dp, the head over mp);
``lm`` runs sequence-parallel on a (dp, sp) mesh, sp 4, 2 or 1 as the world
divides, the sequence and the batch padded up to whole blocks, its
attention the ring's plain absorb, as the JAX runner's under a mesh;
``moe-lm`` runs the same way, its experts split over the same sp axis
(``max(8, 2 sp)`` of them, as JAX sizes them) and each rank routing its
whole block. ``--mode decode`` is single-device, as in JAX.

Usage:
  python3 -m k8s_device_plugin_torch.workloads.run --model lstm \
      [--mode infer|train] [--batch N] [--size S] [--steps K] \
      [--device cuda|cpu] [--multichip]
  python3 -m k8s_device_plugin_torch.workloads.run --model lm|moe-lm \
      --mode infer|train|decode [--batch N] [--size SEQ] [--steps K]
  torchrun --nproc-per-node N -m k8s_device_plugin_torch.workloads.run \
      --model resnet50|lm|moe-lm ... --multichip
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch
import torch.distributed as dist

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
#: time steps of the LSTM case's input sequence (as the JAX runner)
LSTM_STEPS = 64
#: one LM shape for every lm mode: heads, dim, vocab, layers
LM_CONFIG = (8, 512, 8192, 4)
#: tokens decoded per call in --mode decode; --steps = calls per round
DECODE_LEN = 32
#: experts per MoE layer at least: the JAX runner's max(8, 2 sp), 8 for
#: every sp the runner picks
MOE_EXPERTS = 8
#: tokens of one routing group of the MoE LM on one device (one block of
#: a sequence)
MOE_GROUP = 1024


def build_model(name: str, dtype: torch.dtype, size: int,
                train: bool = False, on_card: bool = True):
    """The model of case ``name``; ``size`` is the LSTM's feature width and
    VGG's image size. To train, the convolutional models keep fp32 weights
    (Flax's ``param_dtype``) and compute in ``dtype``. The LSTM takes the
    fused cell's layout on the card (K2, weights in ``dtype`` as the JAX
    cell declares them) and the stock layout elsewhere, as the JAX runner
    takes ``use_pallas=on_tpu``. ``lfm2_moe`` is LFM2-8B-A1B at its
    published widths (``lfm2.LFM2MoE``) and ``afmoe`` Trinity-Mini's rank
    0 of 4-way expert parallelism (``afmoe.AFMoE`` at
    ``afmoe.TRINITY_MINI_EP4``; a configuration of the benchmark that
    holds other experts is refused by its tenant's layout check, on
    ``experts_held``), both for inference only; their ``size`` is the
    prompt length and does not shape the model."""
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
        return LSTMClassifier(features=size, dtype=dtype, use_pallas=on_card)
    if name == "lfm2_moe":
        if train:
            raise SystemExit("lfm2_moe runs inference only")
        from .lfm2 import LFM2MoE
        return LFM2MoE(dtype=dtype)
    if name == "afmoe":
        if train:
            raise SystemExit("afmoe runs inference only")
        from .afmoe import AFMoE, TRINITY_MINI_EP4
        return AFMoE(TRINITY_MINI_EP4, dtype=dtype)
    raise SystemExit(f"unknown model {name}")


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


def _lm_setup(args, batch: int, seq: int, device):
    """(model, tokens, mesh, batch, seq) of the LM paths: ``LM_CONFIG`` in
    bf16, random weights from seed 0, tokens from seed 1 (one more
    position to train: the next-token shift leaves ``seq``). With
    ``--multichip`` (never to decode) a (dp, sp) mesh over the world, sp
    4, 2 or 1 as the world divides, the sequence and the batch rounded
    up to whole per-rank blocks, as the JAX runner pads them, and the MoE
    LM's experts split over sp (``harness.shard_params``); without one
    the MoE LM's sequence is padded to whole ``MOE_GROUP`` blocks."""
    from . import harness
    from .attention import init_lm_params
    from .moe import init_moe_lm_params
    heads, dim, vocab, layers = LM_CONFIG
    seed = torch.Generator().manual_seed(0)
    mesh, sp = None, 1
    if args.multichip:
        n = dist.get_world_size()
        sp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
        mesh = harness.device_mesh((n // sp, sp), ("dp", "sp"))
        seq = -(-seq // sp) * sp
        batch = -(-batch // (n // sp)) * (n // sp)
    elif args.model == "moe-lm" and args.mode != "decode":
        seq = -(-seq // MOE_GROUP) * MOE_GROUP
    if args.model == "moe-lm":
        model = init_moe_lm_params(seed, vocab, dim, heads, layers,
                                   n_experts=max(MOE_EXPERTS, 2 * sp),
                                   dtype=torch.bfloat16, device=device)
    else:
        model = init_lm_params(seed, vocab, dim, heads, layers,
                               dtype=torch.bfloat16, device=device)
    if mesh is not None:
        harness.shard_params(model, mesh)
    length = seq + 1 if args.mode == "train" else seq
    tokens = torch.randint(0, vocab, (batch, length),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    return model, tokens, mesh, batch, seq


def _lm_call(args, batch: int, seq: int, device):
    """The long-context causal LM (``--model lm``) or its Switch-MoE
    variant (``moe-lm``, ``MOE_EXPERTS`` experts of hidden 4 dim) in
    ``--mode infer`` or ``train`` (see :func:`_lm_setup`). On the card
    attention runs through the flash absorb: one whole-sequence causal
    absorb per layer to infer (the dense oracle would hold [B, H, T, T]
    fp32 scores, 1 GiB a layer at 8 x 2048); to train the LM,
    ``lm_loss``'s 1024-token chunks, whose recompute backward holds one
    [B, H, 1024, 1024] score block at a time; the MoE LM trains on
    whole-sequence absorbs, as the JAX ``moe_lm_loss`` passes no chunking.
    Training is plain SGD on the bf16 weights (``p - 1e-3 g``). On one
    device the MoE LM routes each ``MOE_GROUP``-token block of each
    sequence on its own (``shard_shape``), the sequence padded to whole
    blocks, as the JAX runner bounds its [N, E, C] dispatch tensors. On the
    CPU attention is the dense oracle, as the JAX runner off the TPU. On a
    mesh every rank runs its [B/dp, T/sp] block, attention the ring's
    plain absorb (as the JAX runner's under a mesh), the MoE LM's rank
    routes its whole block (as JAX passes no ``shard_shape`` under a
    mesh), and the gradients are summed over the axes each weight is
    replicated on before the step (``harness.sum_replica_grads``: the
    experts over dp, the rest over the world). ``call.model``,
    ``call.tokens`` and ``call.mesh`` are what the call runs on."""
    from . import harness
    from .attention import lm_forward, lm_loss, seq_shard
    from .moe import moe_lm_forward, moe_lm_loss
    model, tokens, mesh, batch, seq = _lm_setup(args, batch, seq, device)
    use_flash = device.type == "cuda" and mesh is None
    if args.model == "moe-lm":
        shard_shape = None if mesh is not None else (batch,
                                                     seq // MOE_GROUP)

        def forward(t):
            if mesh is not None:
                t = seq_shard(t, mesh)
            return moe_lm_forward(model, t, mesh, use_flash=use_flash,
                                  shard_shape=shard_shape)[0]

        def loss_of(t):
            return moe_lm_loss(model, t, mesh, use_flash=use_flash,
                               shard_shape=shard_shape)
    else:
        def forward(t):
            if mesh is not None:
                t = seq_shard(t, mesh)
            return lm_forward(model, t, mesh, use_flash=use_flash)

        def loss_of(t):
            return lm_loss(model, t, mesh, use_flash=use_flash)
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
            if mesh is not None:
                harness.sum_replica_grads(model, mesh)
            optimizer.step()
            return loss.detach()
    call.model, call.tokens, call.mesh = model, tokens, mesh
    sp = harness.mesh_shape(mesh)["sp"] if mesh is not None else 1
    return call, batch, lambda dt: {
        "model": args.model, "mode": args.mode, "seq": seq,
        "tokens_per_s": round(batch * seq * args.steps / dt, 2), "sp": sp}


def _run_lm_decode(args, device, limiter) -> int:
    """KV-cache serving: the prompt is prefilled once, cold
    (``prefill_compile_s``: CUDA context, library handles and kernel
    builds included, as the JAX runner's first call includes its
    compile), then once more, timed (``prefill_s``); every timed round
    decodes ``DECODE_LEN`` tokens per call from that prefilled state. The
    MoE LM's feed-forward is the drop-free expert apply."""
    from . import harness
    from .decode import decode_from, dropfree_moe_ffn, prefill
    batch, size = _shapes(args)
    model, prompt, _, _, _ = _lm_setup(args, batch, size, device)
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


def _shapes(args) -> tuple[int, int]:
    """(batch, size) of the case, unless given: the train batch to train;
    decode, an inference-side workload, takes the serving batch."""
    infer_b, train_b, size = CASES[args.model]
    return (args.batch or (train_b if args.mode == "train" else infer_b),
            args.size or size)


def build_call(args, device: torch.device):
    """(call, batch, fields) of ``--mode infer`` or ``train``: ``call()``
    runs one step (the logits to infer, the loss to train) and
    ``fields(dt)`` gives the model's own keys of a round's line. With
    ``--multichip`` the world must be joined (:func:`world`)."""
    from . import harness
    batch, size = _shapes(args)
    if args.model in ("lm", "moe-lm"):
        return _lm_call(args, batch, size, device)
    train = args.mode == "train"
    model = harness.init_model(
        build_model(args.model, torch.bfloat16, size, train,
                    on_card=device.type == "cuda"), 0, device)
    if args.model == "lstm":
        x = torch.ones(batch, LSTM_STEPS, size, dtype=torch.bfloat16,
                       device=device)
    else:
        x = torch.ones(batch, size, size, 3, dtype=torch.bfloat16,
                       device=device)
    # DeepLab labels every pixel
    labels = torch.zeros((batch, size, size) if args.model == "deeplab"
                         else (batch,), dtype=torch.long, device=device)
    mesh = harness.make_mesh() if args.multichip else None
    if train:
        step = harness.make_train_fn(
            model, harness.sgd(model), loss_fn=harness.seg_cross_entropy
            if args.model == "deeplab" else harness.cross_entropy,
            has_dropout=args.model == "vgg16")
        state = harness.init_train_state(model)
        if mesh is not None:
            step, state, x, labels = harness.shard_train_step(
                step, mesh, state, x, labels)

        def call():
            nonlocal state
            state, loss = step(state, x, labels)
            return loss
    else:
        if mesh is not None:
            harness.shard_model(model, mesh, x)
            x = harness.local_shard(x, mesh, harness.batch_shardings(mesh, x))
        infer = harness.make_infer_fn(model)

        def call():
            return infer(x)
    return call, batch, lambda dt: {"model": args.model, "mode": args.mode}


def init_world(device: torch.device) -> tuple[torch.device, bool]:
    """Join the world the launcher describes (``torchrun``'s ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or a
    world of one in this process without a launcher: NCCL with one card a
    rank (``cuda:LOCAL_RANK``), gloo on the CPU. Returns the rank's device
    and whether this call made the process group."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device, False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return device, True


@contextlib.contextmanager
def world(device: torch.device):
    """:func:`init_world` for the block, yielding the rank's device; the
    process group it made is destroyed on the way out."""
    device, owned = init_world(device)
    try:
        yield device
    finally:
        if owned:
            dist.destroy_process_group()


def parse_args(argv=None):
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
                   help="shard over every rank of the world (dp x mp mesh; "
                        "for --model lm and moe-lm, a dp x sp "
                        "sequence-parallel mesh)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.mode == "decode" and args.model not in ("lm", "moe-lm"):
        raise SystemExit("--mode decode supports --model lm / moe-lm only")
    if args.mode == "decode" and args.multichip:
        raise SystemExit("--mode decode is single-device (no --multichip "
                         "mesh)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
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
    if args.mode == "decode":
        return _run_lm_decode(args, device, limiter)
    with world(device) if args.multichip else \
            contextlib.nullcontext(device) as device:
        call, batch, fields = build_call(args, device)
        return _bench_loop(args, call, device, limiter, batch, fields)


if __name__ == "__main__":
    sys.exit(main())
