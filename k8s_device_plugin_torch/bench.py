"""Headline benchmark of the port: ResNet-50 under an N-way share of one card.

Counterpart of the repo root's ``bench.py``: ai-benchmark case 1.1
(ResNet-V2-50 bf16 inference, batch 50 @ 346x346) runs once natively and
once as ``--share-procs`` concurrent processes on one card, each capped at
1/``--share`` of device memory. While the share runs, the monitor's duty
probe (calibrated on the idle card) samples how much of the card the
tenants leave free.

The share, the oversubscribe phase and the duty check run each child
under ``--child-mode``: ``wrapped`` (the default on a card) executes under
the production enforcement path, the shim ``libvtpu_cuda.so`` in
``LD_PRELOAD`` with the ``VTPU_*`` contract a vTPU container receives at
Allocate time, as the JAX bench loads ``libvtpu.so``; it refuses an
allocation past the cap and charges every launch to the duty-cycle
bucket. ``plain`` (the default on the CPU, where there is nothing to
interpose) runs the cooperative limiter instead, which bounds PyTorch's
allocator and charges each call's device time (``_metered``). A wrapped
child first checks that the shim is live (the card reports the cap as its
total, and the region holds the child), since the shim fails open by
design. There is no fallback from one mode to the other. The native run
is never wrapped.

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
import copy
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
#: the oversubscribe phase's shapes (the JAX bench's ``TIERS[0]``: batch,
#: image size, iters) and cap
QUICK_TIER = (8, 64, 3)
OVERSUB_CAP_BYTES = 64 << 20
#: the band the capped / uncapped img/s of the duty check must fall in
DUTY_BAND = (0.35, 0.65)


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
    p.add_argument("--child-mode", choices=["wrapped", "plain"],
                   default=None,
                   help="enforcement of the share children: the shim "
                        "(wrapped, the default on a card) or the "
                        "cooperative limiter (plain, the default on the "
                        "CPU)")
    p.add_argument("--child-phase", choices=["native", "share"],
                   default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child_mode is None:
        args.child_mode = ("wrapped" if torch.device(args.device).type
                           == "cuda" else "plain")
    return args


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


def _metered(infer, limiter, device):
    """``infer`` charged to the limiter's duty-cycle bucket in a ``plain``
    child, where no shim meters the launches: before each call,
    ``throttle`` takes the previous call's own device time (CUDA events
    around it; on the CPU its wall time), so the call waits until the
    bucket has refilled for it. A cost above the bucket's capacity is
    charged in whole-capacity pieces (one such request would never be
    granted)."""
    from .shm.limiter import BUCKET_CAPACITY_US
    cuda = device.type == "cuda"
    last = None

    def call(x):
        nonlocal last
        if last is not None:
            if cuda:
                last[1].synchronize()
                cost_us = last[0].elapsed_time(last[1]) * 1e3
            else:
                cost_us = last
            while cost_us > 0:
                limiter.throttle(min(cost_us, BUCKET_CAPACITY_US))
                cost_us -= BUCKET_CAPACITY_US
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = infer(x)
            end.record()
            last = (start, end)
        else:
            t0 = time.perf_counter()
            out = infer(x)
            last = (time.perf_counter() - t0) * 1e6
        return out
    return call


def memory_accounting(limiter, cap: int, device) -> tuple[int, int, int]:
    """(used, spill, violations) of a share child once its window is over:
    used is the limiter's polled usage (``memory_reserved``). Under
    ``VTPU_OVERSUBSCRIBE`` the cap is soft, so usage above it is spill and
    no violation; otherwise the poll's violations count, plus one if the
    allocator's peak ever passed the cap."""
    limiter.poll_once()
    used = limiter.region.device_used(0)
    if limiter.region.data.oversubscribe:
        return used, max(0, used - cap) if cap else 0, limiter.violations
    peak_over = cap and device.type == "cuda" \
        and torch.cuda.max_memory_reserved(device) > cap
    return used, 0, limiter.violations + (1 if peak_over else 0)


def shim_region(cap: int, device):
    """The shared region of a wrapped child, once the shim is shown live:
    the card reports ``cap`` as its total memory and the region holds this
    process. Raises SystemExit otherwise: the shim fails open by design,
    so a child it does not hold must not measure unenforced."""
    from .shm.region import Region
    if device.type != "cuda":
        raise SystemExit("wrapped child: the shim enforces on a CUDA "
                         f"device, not {device}")
    cache = os.environ.get("VTPU_DEVICE_MEMORY_SHARED_CACHE")
    total = torch.cuda.mem_get_info(device)[1]
    if not cache or total != cap:
        raise SystemExit(f"wrapped child: the shim is not live (the card "
                         f"reports {total} bytes, the cap is {cap})")
    region = Region(os.path.join(cache, "vtpu.cache"), create=False)
    if os.getpid() not in [p.pid for p in region.active_procs()]:
        region.close()
        raise SystemExit("wrapped child: the shim is not live (its region "
                         "holds no slot of this process)")
    return region


def drain_bucket(region, call, dev: int = 0, seconds: float = 10.0) -> int:
    """``call()`` until the shim's duty-cycle bucket holds less than a
    tenth of its capacity, or for ``seconds``: the burst the bucket starts
    with is spent, and a timed window after it runs at the capped rate
    from its first call. A tenant that keeps the card busy for less than
    its cap never drains the bucket (the cap does not bind it), so the
    time bound ends the wait. Returns the calls made."""
    from .shm.limiter import BUCKET_CAPACITY_US
    data = region.data
    deadline = time.monotonic() + seconds
    calls = 0
    while time.monotonic() < deadline:
        if data.duty_refill_us[dev] and \
                data.duty_tokens_us[dev] < BUCKET_CAPACITY_US // 10:
            break
        call()
        calls += 1
    return calls


def shim_accounting(region, cap: int, device) -> tuple[int, int, int]:
    """(used, spill, violations) of a wrapped child once its window is
    over: used is what the shim charged the region (the allocator's
    device memory and the context). Under ``VTPU_OVERSUBSCRIBE`` usage
    above the cap is spill and no violation; otherwise usage or the
    allocator's peak above the cap is one."""
    used = region.device_used(0)
    if region.data.oversubscribe:
        return used, max(0, used - cap) if cap else 0, 0
    over = cap and (used > cap
                    or torch.cuda.max_memory_reserved(device) > cap)
    return used, 0, 1 if over else 0


def child_main(args) -> int:
    from .shm.limiter import BUCKET_CAPACITY_US, CooperativeLimiter
    from .workloads import harness
    from .workloads.resnet import resnet50

    lock_fd = _compile_lock_acquire()
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    cap = int(os.environ.get("VTPU_DEVICE_MEMORY_LIMIT_0", "0"))
    limiter = region = None
    if args.child_phase == "share" and args.child_mode == "wrapped":
        region = shim_region(cap, device)
    elif args.child_phase == "share":
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
    # a plain child under a core limit (the duty check pins one on both
    # legs) meters every call; the others run unmetered, and a wrapped
    # child's launches are charged by the shim
    metered = limiter is not None and "VTPU_DEVICE_CORE_LIMIT" in os.environ
    if metered:
        infer = _metered(infer, limiter, device)
    logits = infer(x)
    if logits.shape != (batch, 1000) or not torch.isfinite(logits).all():
        raise SystemExit(f"bench child: bad logits {tuple(logits.shape)}")
    _compile_lock_release(lock_fd)
    _barrier_wait()
    # the bucket starts full, a burst of BUCKET_CAPACITY_US (0.2 s) of
    # device time, more than a quick tier's window holds: drain it, so the
    # timed window runs at the capped rate from its first call
    if metered:
        limiter.throttle(BUCKET_CAPACITY_US)
    elif region is not None and 0 < region.data.sm_limit[0] < 100:
        drain_bucket(region, lambda: infer(x))
    # warm already (count_flops and the check above ran the model twice);
    # wall-clock ends so the supervisor can line the windows up
    start = time.time()
    secs = [harness.time_fn(infer, x, device=device, iters=iters, warmup=0)
            for _ in range(PASSES)]
    end = time.time()

    used = spill = violations = 0
    if limiter is not None:
        used, spill, violations = memory_accounting(limiter, cap, device)
        limiter.uninstall()
    elif region is not None:
        used, spill, violations = shim_accounting(region, cap, device)
        region.close()
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
        "spill_bytes": int(spill),
        "flops_per_img": flops,
    }))
    return 0


# ------------------------------------------------------------- supervisor

def _child_cmd(phase: str, args) -> list[str]:
    cmd = [sys.executable, "-m", "k8s_device_plugin_torch.bench",
           "--child-phase", phase, "--child-mode", args.child_mode,
           "--device", args.device]
    if args.quick:
        cmd.append("--quick")
    for flag, val in (("--batch", args.batch),
                      ("--image-size", args.image_size),
                      ("--iters", args.iters)):
        if val is not None:
            cmd += [flag, str(val)]
    return cmd


def _child_env(extra: dict[str, str], shim: str | None = None
               ) -> dict[str, str]:
    """A child's environment: the contract in ``extra`` and no inherited
    one; the shim preloaded when ``shim`` is its path (a wrapped share
    child), and never otherwise (the native run)."""
    env = dict(os.environ)
    # a child starts from the contract it is given, never an inherited one
    for var in ("VTPU_DEVICE_MEMORY_SHARED_CACHE", "VTPU_DEVICE_MEMORY_LIMIT_0",
                "VTPU_DEVICE_CORE_LIMIT", "VTPU_OVERSUBSCRIBE",
                "VTPU_DISABLE_CONTROL"):
        env.pop(var, None)
    from .shm.limiter import is_shim
    preload = [p for p in env.pop("LD_PRELOAD", "").replace(":", " ").split()
               if not is_shim(p)]
    if shim or preload:
        env["LD_PRELOAD"] = " ".join(([shim] if shim else []) + preload)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    env.update(extra)
    return env


def _run_children(phase: str, args, envs: list[dict], workdir: str,
                  during=None, label: str | None = None) -> list[dict]:
    """Start one ``phase`` child per env, run ``during(stop_event)`` on a
    thread once every child has passed the barrier, and return their JSON
    lines (their logs named by ``label``, default the phase). Raises if any
    child fails; kills the rest on the way out."""
    procs = []
    label = label or phase
    shim = None
    if phase == "share" and args.child_mode == "wrapped":
        from . import _build
        shim = _build.host_library("vtpu_cuda")
    try:
        for i, extra in enumerate(envs):
            log = open(os.path.join(workdir, f"{label}{i}.stderr"), "w")
            procs.append((subprocess.Popen(
                _child_cmd(phase, args), env=_child_env(extra, shim),
                stdout=subprocess.PIPE, stderr=log, text=True), log))
        barrier = envs[0].get("VTPU_BENCH_BARRIER", "").rsplit(":", 1)[0]
        stop = threading.Event()
        sampler = None
        deadline = time.time() + CHILD_TIMEOUT_S
        while any(p.poll() is None for p, _ in procs):
            if time.time() > deadline:
                raise RuntimeError(f"bench: {label} children exceeded "
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
                raise RuntimeError(f"bench: {label} child {i} failed "
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


def _share_envs(n: int, cap: int, workdir: str, prefix: str,
                extra: dict | None = None) -> list[dict]:
    """Envs of ``n`` share children, each with its own region and ``cap``,
    warming up one at a time and timed together."""
    sync = tempfile.mkdtemp(prefix=f"{prefix}-sync-", dir=workdir)
    return [{
        "VTPU_DEVICE_MEMORY_SHARED_CACHE": tempfile.mkdtemp(
            prefix=f"{prefix}{i}-", dir=workdir),
        "VTPU_DEVICE_MEMORY_LIMIT_0": str(cap),
        "VTPU_BENCH_COMPILE_LOCK": os.path.join(sync, "compile.lock"),
        "VTPU_BENCH_BARRIER": f"{os.path.join(sync, 'warm.barrier')}:{n}",
        **(extra or {}),
    } for i in range(n)]


def run_share(args, total_bytes: int, workdir: str, during=None) -> dict:
    """N concurrent children, each with its own region and a cap of
    ``total_bytes // share``; returns their aggregate."""
    n = args.share_procs
    envs = _share_envs(n, total_bytes // args.share, workdir, "share")
    agg = aggregate(_run_children("share", args, envs, workdir,
                                  during=during))
    agg["share_procs"] = n
    return agg


def _pinned(args) -> bool:
    return any(v is not None for v in (args.batch, args.image_size,
                                       args.iters))


def oversubscribe_result(replicas: int, outs: list[dict]) -> dict:
    """The JAX bench's ``oversubscribe`` entry from the replicas' lines:
    their spill and violations summed, and img/s over the shared window
    (as the share's)."""
    return {"replicas": replicas,
            "spill_bytes": sum(o["spill_bytes"] for o in outs),
            "violations": sum(o["violations"] for o in outs),
            "img_per_s": aggregate(outs)["img_per_s"]}


def run_oversubscribe(args, workdir: str) -> dict:
    """``VTPU_BENCH_OVERSUB_REPLICAS`` (10) concurrent share children under
    ``VTPU_OVERSUBSCRIBE=1`` with a cap of ``OVERSUB_CAP_BYTES``, which
    the workload exceeds (spill above 0), at the quick tier unless the
    caller pinned the shapes."""
    targs = copy.copy(args)
    if not _pinned(args):
        targs.batch, targs.image_size, targs.iters = QUICK_TIER
    n = int(os.environ.get("VTPU_BENCH_OVERSUB_REPLICAS", "10"))
    envs = _share_envs(n, OVERSUB_CAP_BYTES, workdir, "osub",
                       {"VTPU_OVERSUBSCRIBE": "1"})
    return oversubscribe_result(
        n, _run_children("share", targs, envs, workdir, label="osub"))


def duty_result(uncapped: dict, capped: dict) -> dict:
    """The JAX bench's ``duty_check`` entry from the two children's
    lines."""
    ratio = capped["img_per_s"] / uncapped["img_per_s"]
    return {"uncapped_img_per_s": uncapped["img_per_s"],
            "capped50_img_per_s": capped["img_per_s"],
            "ratio": ratio,
            "within_band": DUTY_BAND[0] <= ratio <= DUTY_BAND[1]}


def run_duty_check(args, total_bytes: int, workdir: str) -> dict:
    """One share child at ``VTPU_DEVICE_CORE_LIMIT=0`` and then one at
    ``50``, alone on the device, at the bench's shapes. Both pin the limit
    explicitly: a supervisor inside a capped container must not run the
    "uncapped" leg at its inherited cap (``_child_env`` drops inherited
    ``VTPU_*`` anyway)."""
    legs = [_run_children(
        "share", args, _share_envs(1, total_bytes // args.share, workdir,
                                   f"duty{pct}-",
                                   {"VTPU_DEVICE_CORE_LIMIT": str(pct)}),
        workdir, label=f"duty{pct}-")[0] for pct in (0, 50)]
    return duty_result(*legs)


def probe_runner(device: str):
    """The duty probe's runner for ``device``: the CUDA kernel at its
    default size on a card, the JAX probe's interpret-mode scale (32x32,
    4 steps) on the CPU."""
    from .monitor.dutyprobe import TorchProbe
    if torch.device(device).type == "cuda":
        return TorchProbe(device=device)
    return TorchProbe(size=32, steps=4, device=device)


def measure(args, workdir: str) -> dict:
    """Native run, idle-card probe calibration, the share with the probe
    sampling beside it, then the oversubscribe phase and the duty check;
    returns the result line, with each phase's seconds under
    ``extra.phase_s``."""
    from .monitor.dutyprobe import DutyProbe
    seconds = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    native = timed("native", run_native, args, workdir)
    runner = probe_runner(args.device)
    probe = DutyProbe(runner=runner)
    probe.calibrate()
    probe.interval_s = PROBE_INTERVAL_S

    def sample(stop):
        while not stop.is_set():
            probe.maybe_sample()
            stop.wait(0.01)

    share = timed("share", run_share, args, native["total_bytes"], workdir,
                  during=sample)
    oversub = timed("oversubscribe", run_oversubscribe, args, workdir)
    duty = timed("duty_check", run_duty_check, args, native["total_bytes"],
                 workdir)
    result = assemble(args, native, share, probe, runner, oversub, duty)
    result["extra"]["phase_s"] = seconds
    return result


def assemble(args, native: dict, share: dict, probe, runner,
             oversub: dict, duty: dict) -> dict:
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
            "enforcement": args.child_mode,
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
            "oversubscribe": oversub,
            "duty_check": duty,
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
