"""Headline benchmark of the port: ResNet-50 under an N-way share of one card.

Counterpart of the repo root's ``bench.py``: ai-benchmark case 1.1
(ResNet-V2-50 bf16 inference, batch 50 @ 346x346) runs once natively and
once as ``--share-procs`` concurrent processes on one card, each capped at
1/``--share`` of device memory under the cooperative limiter, which writes
the shared region the monitor reads. While the share runs, the monitor's
duty probe (calibrated on the idle card) samples how much of the card the
tenants leave free.

Usage: ``python -m k8s_device_plugin_torch.bench [--quick] [--device cpu]``.
Prints ONE JSON line: ``{"metric", "value": aggregate img/s under the
share, "unit": "img/s", "vs_baseline": share / native, "extra": {...}}``.

Children warm up one at a time under a file lock and then meet at a
barrier, so their timed regions overlap. Each child times ``PASSES``
passes back to back on the host's wall clock and reports the window's
start, end and image count; a phase's img/s is every image its children
ran over the window from the first start to the last end, so a child that
runs on alone after its siblings finish cannot inflate the aggregate.
Each child's fastest pass is kept apart, as a per-process statistic. A
failed child fails the run: there is no retry ladder, bank or CPU
fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), for the MFU
PEAK_BF16_FLOPS = 989e12
CHILD_TIMEOUT_S = float(os.environ.get("VTPU_BENCH_TIMEOUT", "600"))
#: seconds between duty-probe samples while the share runs (the monitor's
#: default is 10 s; the share's timed window is tens of seconds)
PROBE_INTERVAL_S = 0.25
#: timed passes of ``--iters`` calls each child runs inside its window
PASSES = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser("vtpu-bench-torch")
    p.add_argument("--quick", action="store_true",
                   help="tiny shapes / few iters (smoke)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--share", type=int, default=4,
                   help="memory split count: each process gets 1/share")
    p.add_argument("--share-procs", type=int, default=4,
                   help="concurrent capped share processes")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--child-phase", choices=["native", "share"],
                   default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _bench_shapes(args) -> tuple[int, int, int]:
    # ai-benchmark case 1.1: batch 50 @ 346x346 (docs/benchmark.md:22)
    batch = args.batch or (8 if args.quick else 50)
    size = args.image_size or (64 if args.quick else 346)
    iters = args.iters or (3 if args.quick else 20)
    return batch, size, iters


# --------------------------------------------------------------- children

def _compile_lock_acquire():
    """Exclusive fleet-wide lock held from start-up through the first
    inference; None when not in a fleet."""
    path = os.environ.get("VTPU_BENCH_COMPILE_LOCK")
    if not path:
        return None
    import fcntl
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    return fd


def _compile_lock_release(fd) -> None:
    if fd is None:
        return
    import fcntl
    fcntl.flock(fd, fcntl.LOCK_UN)
    os.close(fd)


def _barrier_wait() -> None:
    """Park until every fleet member is warm so the timed regions overlap.
    A timeout means a sibling died or stalled: fail this child, because an
    aggregate over non-overlapping timed regions would overstate the N-way
    throughput."""
    spec = os.environ.get("VTPU_BENCH_BARRIER")
    if not spec:
        return
    path, n = spec.rsplit(":", 1)
    fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    os.write(fd, b"x")
    os.close(fd)
    deadline = time.time() + float(
        os.environ.get("VTPU_BENCH_BARRIER_TIMEOUT", "300"))
    while time.time() < deadline:
        if os.path.getsize(path) >= int(n):
            return
        time.sleep(0.05)
    print("bench child: barrier timeout (sibling died?)", file=sys.stderr)
    sys.exit(3)


def child_main(args) -> int:
    from .shm.limiter import CooperativeLimiter
    from .workloads import harness
    from .workloads.resnet import resnet50

    lock_fd = _compile_lock_acquire()
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    limiter = None
    if args.child_phase == "share":
        # before the first allocation, so the allocator bound holds from
        # the start
        limiter = CooperativeLimiter(poll_interval=0.2)
        if not limiter.install():
            raise SystemExit("share child: the VTPU_* contract is not set")

    batch, size, iters = _bench_shapes(args)
    model = harness.init_model(resnet50(), 0, device)
    x = torch.ones(batch, size, size, 3, dtype=torch.bfloat16, device=device)
    infer = harness.make_infer_fn(model)
    flops = harness.count_flops(model, x) / batch  # also the first call
    logits = infer(x)
    if logits.shape != (batch, 1000) or not torch.isfinite(logits).all():
        raise SystemExit(f"bench child: bad logits {tuple(logits.shape)}")
    _compile_lock_release(lock_fd)
    _barrier_wait()
    # warm already (count_flops and the check above ran the model twice);
    # wall-clock ends so the supervisor can line the windows up
    start = time.time()
    secs = [harness.time_fn(infer, x, device=device, iters=iters, warmup=0)
            for _ in range(PASSES)]
    end = time.time()

    used = violations = 0
    cap = int(os.environ.get("VTPU_DEVICE_MEMORY_LIMIT_0", "0"))
    if limiter is not None:
        limiter.poll_once()
        violations = limiter.violations + (
            1 if cap and torch.cuda.is_available()
            and torch.cuda.max_memory_reserved(device) > cap else 0)
        used = limiter.region.device_used(0)
        limiter.uninstall()
    cuda = device.type == "cuda"
    images = batch * iters * PASSES
    print(json.dumps({
        "img_per_s": images / (end - start),
        "best_pass_img_per_s": batch / min(secs),
        "images": images,
        "start": start,
        "end": end,
        "platform": "gpu" if cuda else "cpu",
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "total_bytes": torch.cuda.mem_get_info(device)[1] if cuda else 0,
        "batch": batch,
        "image_size": size,
        "hbm_used_bytes": int(used),
        "hbm_cap_bytes": cap,
        "violations": violations,
        "flops_per_img": flops,
    }))
    return 0


# ------------------------------------------------------------- supervisor

def _child_cmd(phase: str, args) -> list[str]:
    cmd = [sys.executable, "-m", "k8s_device_plugin_torch.bench",
           "--child-phase", phase, "--device", args.device]
    if args.quick:
        cmd.append("--quick")
    for flag, val in (("--batch", args.batch),
                      ("--image-size", args.image_size),
                      ("--iters", args.iters)):
        if val is not None:
            cmd += [flag, str(val)]
    return cmd


def _child_env(extra: dict[str, str]) -> dict[str, str]:
    env = dict(os.environ)
    # a child starts from the contract it is given, never an inherited one
    for var in ("VTPU_DEVICE_MEMORY_SHARED_CACHE", "VTPU_DEVICE_MEMORY_LIMIT_0",
                "VTPU_DEVICE_CORE_LIMIT", "VTPU_OVERSUBSCRIBE",
                "VTPU_DISABLE_CONTROL"):
        env.pop(var, None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    env.update(extra)
    return env


def _run_children(phase: str, args, envs: list[dict], workdir: str,
                  during=None) -> list[dict]:
    """Start one child per env, run ``during(stop_event)`` on a thread once
    every child has passed the barrier, and return their JSON lines.
    Raises if any child fails; kills the rest on the way out."""
    procs = []
    try:
        for i, extra in enumerate(envs):
            log = open(os.path.join(workdir, f"{phase}{i}.stderr"), "w")
            procs.append((subprocess.Popen(
                _child_cmd(phase, args), env=_child_env(extra),
                stdout=subprocess.PIPE, stderr=log, text=True), log))
        barrier = envs[0].get("VTPU_BENCH_BARRIER", "").rsplit(":", 1)[0]
        stop = threading.Event()
        sampler = None
        deadline = time.time() + CHILD_TIMEOUT_S
        while any(p.poll() is None for p, _ in procs):
            if time.time() > deadline:
                raise RuntimeError(f"bench: {phase} children exceeded "
                                   f"{CHILD_TIMEOUT_S:.0f}s")
            if during is not None and sampler is None and barrier and \
                    os.path.exists(barrier) and \
                    os.path.getsize(barrier) >= len(envs):
                sampler = threading.Thread(target=during, args=(stop,))
                sampler.start()
            time.sleep(0.05)
        stop.set()
        if sampler is not None:
            sampler.join()
        outs = []
        for i, (p, log) in enumerate(procs):
            stdout = p.stdout.read()
            log.close()
            if p.returncode != 0 or not stdout.strip():
                with open(log.name) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"bench: {phase} child {i} failed "
                                   f"rc={p.returncode}:\n{tail}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
        return outs
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
            log.close()


def aggregate(outs: list[dict]) -> dict:
    """The children's lines as one: img/s is all their images over the
    window from the first start to the last end."""
    agg = dict(outs[0])
    agg["images"] = sum(o["images"] for o in outs)
    agg["window_s"] = max(o["end"] for o in outs) - min(o["start"]
                                                         for o in outs)
    agg["img_per_s"] = agg["images"] / agg["window_s"]
    agg["per_proc_img_per_s"] = [o["img_per_s"] for o in outs]
    agg["per_proc_best_pass_img_per_s"] = [o["best_pass_img_per_s"]
                                           for o in outs]
    agg["hbm_used_bytes"] = sum(o["hbm_used_bytes"] for o in outs)
    agg["violations"] = sum(o["violations"] for o in outs)
    return agg


def run_native(args, workdir: str) -> dict:
    return aggregate(_run_children("native", args, [{}], workdir))


def run_share(args, total_bytes: int, workdir: str, during=None) -> dict:
    """N concurrent children, each with its own region and a cap of
    ``total_bytes // share``; returns their aggregate."""
    n = args.share_procs
    sync = tempfile.mkdtemp(prefix="share-sync-", dir=workdir)
    envs = [{
        "VTPU_DEVICE_MEMORY_SHARED_CACHE": tempfile.mkdtemp(
            prefix=f"share{i}-", dir=workdir),
        "VTPU_DEVICE_MEMORY_LIMIT_0": str(total_bytes // args.share),
        "VTPU_BENCH_COMPILE_LOCK": os.path.join(sync, "compile.lock"),
        "VTPU_BENCH_BARRIER": f"{os.path.join(sync, 'warm.barrier')}:{n}",
    } for i in range(n)]
    agg = aggregate(_run_children("share", args, envs, workdir,
                                  during=during))
    agg["share_procs"] = n
    return agg


def probe_runner(device: str):
    """The duty probe's runner for ``device``: the CUDA kernel at its
    default size on a card, the JAX probe's interpret-mode scale (32x32,
    4 steps) on the CPU."""
    from .monitor.dutyprobe import TorchProbe
    if torch.device(device).type == "cuda":
        return TorchProbe(device=device)
    return TorchProbe(size=32, steps=4, device=device)


def measure(args, workdir: str) -> dict:
    """Native run, idle-card probe calibration, then the share with the
    probe sampling beside it; returns the result line."""
    from .monitor.dutyprobe import DutyProbe
    native = run_native(args, workdir)
    runner = probe_runner(args.device)
    probe = DutyProbe(runner=runner)
    probe.calibrate()
    probe.interval_s = PROBE_INTERVAL_S

    def sample(stop):
        while not stop.is_set():
            probe.maybe_sample()
            stop.wait(0.01)

    share = run_share(args, native["total_bytes"], workdir, during=sample)
    return assemble(args, native, share, probe, runner)


def assemble(args, native: dict, share: dict, probe, runner) -> dict:
    on_gpu = share["platform"] == "gpu"
    flops_img = native["flops_per_img"]
    achieved = share["img_per_s"] * flops_img
    return {
        "metric": f"resnet50_infer_img_per_s_{args.share}way_vtpu"
                  + ("" if on_gpu else "_cpu"),
        "value": share["img_per_s"],
        "unit": "img/s",
        "vs_baseline": share["img_per_s"] / native["img_per_s"],
        "extra": {
            "native_img_per_s": native["img_per_s"],
            "native_best_pass_img_per_s": native["best_pass_img_per_s"],
            "images": share["images"],
            "window_s": share["window_s"],
            "per_proc_img_per_s": share["per_proc_img_per_s"],
            "per_proc_best_pass_img_per_s":
                share["per_proc_best_pass_img_per_s"],
            "hbm_cap_bytes": share["hbm_cap_bytes"],
            "hbm_used_bytes": share["hbm_used_bytes"],
            "hbm_limit_violations": share["violations"],
            "total_bytes": native["total_bytes"],
            "batch": native["batch"],
            "image_size": native["image_size"],
            "platform": share["platform"],
            "device": native["device"],
            "enforcement": "cooperative",
            "share_procs": share["share_procs"],
            "flops_per_img": flops_img,
            "achieved_tflops": achieved / 1e12,
            "mfu": achieved / PEAK_BF16_FLOPS if on_gpu else 0.0,
            "probe": {
                "availability": probe.availability,
                "samples": probe.samples,
                "baseline_ms": probe.baseline_ms,
                "last_ms": probe.last_ms,
                "size": runner.size,
                "steps": runner.steps,
            },
        },
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.child_phase:
        return child_main(args)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device visible")
    with tempfile.TemporaryDirectory(prefix="vtpu-bench-") as workdir:
        print(json.dumps(measure(args, workdir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
