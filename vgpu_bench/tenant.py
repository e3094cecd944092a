"""One tenant of a cell, as a pod is one process: it builds the port's
inference path for the configuration, fills it with the seed's weights,
warms it up, meets its siblings, runs a closed loop of calls for the
window, and writes what it measured for the supervisor (``run.py``).

Usage (the supervisor starts it): ``python -m vgpu_bench.tenant SPEC``,
where SPEC is a JSON file: the cell's ``config`` and ``traffic``, this
tenant's ``index``, ``seed``, ``seconds``, ``trace``, ``device``, ``cap``,
the ``lock``, ``barriers`` and ``held`` paths, the ``out`` prefix, and
``wrap``, a
``module:function`` that wraps the call (tests plant faults with it; a
run never sets it).
"""

from __future__ import annotations

import gc
import json
import random
import sys
import time

import numpy as np

from . import supervise, weights

#: the longest wait for the duty bucket's burst to be spent
DRAIN_S = 10.0
#: the forbidden top-level modules: JAX, and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "k8s_device_plugin_tpu")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that this process has loaded,
    compared whole (``k8s_device_plugin_torch`` is not the JAX package)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build(cfg, seed: int, device):
    """The port's model of ``cfg`` (``workloads.run.build_model``, made
    without weights) holding the seed's weights, in eval mode."""
    import torch
    from k8s_device_plugin_torch.workloads import run as runner
    with torch.device("meta"):
        model = runner.build_model(cfg["model"], getattr(torch, cfg["dtype"]),
                                   cfg["runner_size"], on_card=True)
    model = model.to_empty(device=device)
    values = weights.make(cfg, seed, device)
    state = model.state_dict()
    extra = sorted(k for k in state if k not in values
                   and not k.endswith("num_batches_tracked"))
    missing = sorted(k for k in values if k not in state)
    wrong = sorted(k for k in values if k in state and (
        tuple(state[k].shape) != tuple(values[k].shape)
        or state[k].dtype != values[k].dtype))
    if extra or missing or wrong:
        raise SystemExit(f"tenant: the port's layout differs from the "
                         f"reference's: not made {extra}, not in the model "
                         f"{missing}, shape or dtype {wrong}")
    with torch.no_grad():
        for k, t in state.items():
            if k in values:
                t.copy_(values[k])
            else:
                t.zero_()
    return model.eval()


def settle(region, call, barrier: str, n: int) -> int:
    """Meet the siblings once each is ready to be timed. A tenant under a
    core limit first spends the bucket's starting burst (or gives up after
    ``DRAIN_S``: a tenant that keeps the card less busy than its limit
    never drains it) and keeps calling until all are ready, so every
    window starts at the capped rate. Returns the calls made."""
    capped = region is not None and 0 < region.data.sm_limit[0] < 100
    if not capped:
        supervise.barrier_wait(barrier, n)
        return 0
    deadline = time.monotonic() + DRAIN_S
    ready = False
    calls = 0
    while True:
        if not ready and (supervise.drained(region)
                          or time.monotonic() > deadline):
            supervise.barrier_arrive(barrier)
            ready = True
        if ready and supervise.barrier_full(barrier, n):
            return calls
        if time.monotonic() > deadline + supervise.BARRIER_TIMEOUT_S:
            raise SystemExit("tenant: barrier timeout (sibling died?)")
        call(calls)
        calls += 1


def main(spec_path: str) -> int:
    marks = {"started": time.time_ns()}
    with open(spec_path) as f:
        spec = json.load(f)
    import torch
    from k8s_device_plugin_torch.workloads import harness
    cfg, mix, i = spec["config"], spec["traffic"], spec["index"]
    seed = spec["seed"]
    device = torch.device(spec["device"])
    cuda = device.type == "cuda"
    region = supervise.shim_region(spec["cap"]) if mix["wrapped"] else None
    if cuda:
        torch.backends.cudnn.benchmark = True
    model = build(cfg, seed, device)
    pool = [weights.inputs(cfg, seed, i, j, device)
            for j in range(mix["pool"])]
    infer = harness.make_infer_fn(model)
    if spec.get("wrap"):
        module, _, name = spec["wrap"].partition(":")
        infer = getattr(__import__(module, fromlist=[name]), name)(infer)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks["built"] = time.time_ns()

    # one tenant at a time where the configuration's warm-up needs the card
    # to itself; the profiler, where traced, starts inside the warm-up,
    # since its first launches are slow
    lock = supervise.lock_acquire(spec["lock"]) if cfg["warm_alone"] \
        else None
    t0 = time.perf_counter()
    prof = None
    if spec["trace"]:
        from . import trace
        prof = trace.start(device)
    for x in pool + pool[:1]:  # every input the window feeds; the first
        infer(x)               # call tunes
        sync()
    warm_s = time.perf_counter() - t0
    if lock is not None:
        supervise.lock_release(lock)
    marks["warmed"] = time.time_ns()

    first, ready = spec["barriers"]
    supervise.barrier_wait(first, mix["tenants"])

    def call(k):
        infer(pool[k % len(pool)])
        sync()
    k = settle(region, call, ready, mix["tenants"])

    # a sample of the window's calls, drawn from the seed as they come
    # (reservoir sampling): only the sampled outputs stay on the card
    rng = random.Random(weights.derive(seed, "sample", i))
    size = mix["sample_calls"]
    calls, kept, errors, failed = [], [], [], 0
    gc.disable()  # no collector pauses inside the window
    start = time.time_ns()
    stop = start + int(spec["seconds"] * 1e9)
    while True:
        j = k % len(pool)
        a = time.time_ns()
        try:
            y = infer(pool[j])
            b = time.time_ns()
            sync()
        except Exception as e:  # a refused allocation is a failed call
            failed += 1
            if len(errors) < 5:
                errors.append(f"{type(e).__name__}: {e}"[:300])
            y, b = None, time.time_ns()
        c = time.time_ns()
        n = len(calls)
        calls.append((a, b, c))
        if n < size:
            kept.append((j, y))
        else:
            slot = rng.randrange(n + 1)
            if slot < size:
                kept[slot] = (j, y)
        del y
        k += 1
        if c >= stop:
            break
    gc.enable()
    end = calls[-1][2]
    usage = {}
    if region is not None:
        usage = {"region_used": region.device_used(0),
                 "allocator_peak": torch.cuda.max_memory_reserved(device)}
        region.close()
    # the supervisor reads the card's memory now, while every tenant
    # still holds what its window used and its region accounts
    done, released = spec["held"]
    supervise.barrier_arrive(done)
    supervise.wait_for(released)

    result = {"index": i, "start_ns": start, "end_ns": end, "calls": calls,
              "batch": cfg["input_shape"][0], "errors": errors,
              "failed": failed, "warm_s": warm_s, "marks": marks,
              "cap": spec["cap"], **usage,
              "device": torch.cuda.get_device_name(device) if cuda else "cpu"}
    if prof is not None:
        summary = trace.summarize(prof, device, start, end)
        result["device_events"] = summary["device_events"]
        result["names"] = summary["names"]
        np.save(f"{spec['out']}.trace.npy", summary["intervals"])
    sample = [(j, None if y is None else y.float().cpu()) for j, y in kept]
    torch.save(sample, f"{spec['out']}.sample.pt")
    del kept, model, pool
    result["forbidden_modules"] = forbidden_modules()
    with open(f"{spec['out']}.json", "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
