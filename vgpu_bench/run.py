"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Usage, from the root of a checkout::

    python3 -m vgpu_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The supervisor builds what the cell loads, starts the mix's tenants as
processes (``tenant.py``; a wrapped tenant under ``libvtpu_cuda.so`` with
the ``VTPU_*`` contract and a region of its own under ``TMPDIR``), reads
the card's memory before they start and once every window has closed,
and once every tenant has exited holds the logits they kept against the
plain reference and the configuration's guarantees (``check.py``). With
``--trace 0`` it prints the cell's end-to-end metrics, with ``--trace 1``
its per-layer ones; each is read by ``metrics/<name>.py``. The last line
of standard output is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` (each compared number and
its limit) last. Without a card, or with fewer cards than the cell asks
for, it prints no result and exits with 2. The supervisor loads ``torch``
only once its tenants are starting, to keep it out of the set-up.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

T0 = time.time()

import numpy as np  # noqa: E402

from . import check, supervise, trace  # noqa: E402
from . import tenant as tenant_mod  # noqa: E402

#: how long the tenants may take beyond the window: start, warm-up (the
#: algorithm search), the reads after the window
TENANT_SLACK_S = 240.0


def parse_args(argv=None):
    p = argparse.ArgumentParser("vgpu_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str, traced: bool):
    """(cell, config, traffic, metrics) of workload ``name``, each found
    from ``BENCHMARK.json`` by its name; the metrics are the cell's
    end-to-end ones, or ``traced``, its per-layer ones."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"vgpu_bench: no workload {name!r} in "
                         f"BENCHMARK.json ({', '.join(cells)})")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(root, entry["file"]))
    mix = load_json(os.path.join(root, "vgpu_bench", "traffic",
                                 f"{cell['traffic']}.json"))
    kind = "per_layer" if traced else "end_to_end"
    metrics = [m for m in bench[kind]
               if "workloads" not in m or name in m["workloads"]]
    return cell, cfg, mix, metrics


def reader(root: str, name: str):
    """The ``read(run)`` of ``metrics/<name>.py``; a metric named
    ``<base>.<cells>`` without a file of its own, the same quantity kept
    apart for some cells (its own bound, its own cells), is read by
    ``metrics/<base>.py``."""
    base = os.path.join(root, "vgpu_bench", "metrics")
    path = os.path.join(base, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(base, f"{name.partition('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "vgpu_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def nvidia_smi(*query: str) -> list[list[str]]:
    out = subprocess.run(["nvidia-smi", *query,
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return [[f.strip() for f in line.split(",")]
            for line in out.splitlines() if line.strip()]


def card_memory() -> tuple[int, int]:
    """(total, in use) bytes of card 0, all processes together (inside a
    container the card names every process pid 1, so it gives no one
    tenant's)."""
    total, used = nvidia_smi("--query-gpu=memory.total,memory.used")[0]
    return int(total) << 20, int(used) << 20


def cache_env(root: str) -> dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout, so a
    second run there builds and compiles nothing."""
    base = os.path.join(root, "build", "vgpu_bench")
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": os.path.join(base, "inductor"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda")}


def build(root: str, cfg, wrapped: bool, env) -> str | None:
    """Build the configuration's kernels and, wrapped, the shim; returns
    the shim's path."""
    cmd = [sys.executable, "-m", "vgpu_bench.build", *cfg["kernels"]]
    if wrapped:
        cmd.append("--shim")
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise SystemExit(f"vgpu_bench: build failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["shim"]


def start_tenants(root, cell, cfg, mix, args, device, wrap, workdir, env,
                  shim, total):
    """One process per tenant: [(Popen, spec, log)]. Each tenant holds its
    memory after its window until the supervisor has read the card
    (``held``: the barrier it arrives at, the file it waits for)."""
    n = mix["tenants"]
    cap = int(total * mix["memory_share"]) if mix["wrapped"] else 0
    contracts = (supervise.share_envs(n, cap, mix["core_limit"], workdir)
                 if mix["wrapped"] else [{} for _ in range(n)])
    paths = {k: os.path.join(workdir, k) for k in
             ("warm.lock", "warm.barrier", "ready.barrier", "done.barrier",
              "released")}
    procs = []
    for i, contract in enumerate(contracts):
        out = os.path.join(workdir, f"tenant{i}")
        spec = {"index": i, "seed": args.seed, "seconds": args.seconds,
                "trace": args.trace, "device": device, "cap": cap,
                "config": cfg, "traffic": mix, "wrap": wrap,
                "lock": paths["warm.lock"],
                "barriers": [paths["warm.barrier"], paths["ready.barrier"]],
                "held": [paths["done.barrier"], paths["released"]],
                "out": out}
        with open(f"{out}.spec.json", "w") as f:
            json.dump(spec, f)
        log = open(f"{out}.stderr", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "vgpu_bench.tenant", f"{out}.spec.json"],
            cwd=root, env=supervise.child_env({**env, **contract}, root,
                                              shim),
            stdout=log, stderr=subprocess.STDOUT), spec, log))
    return procs


def wait_tenants(procs, seconds: float, cuda: bool) -> int:
    """Wait for every tenant; once all have closed their windows, read the
    card's memory in use (on a card) and let them go on. Returns that
    reading in bytes. Raises if a tenant fails or overruns."""
    deadline = time.time() + seconds + TENANT_SLACK_S
    done, released = procs[0][1]["held"]
    used = 0
    while any(p.poll() is None for p, _, _ in procs):
        if time.time() > deadline:
            raise RuntimeError("vgpu_bench: the tenants overran")
        if any(p.returncode not in (None, 0) for p, _, _ in procs):
            break
        if not os.path.exists(released) and \
                supervise.barrier_full(done, len(procs)):
            used = card_memory()[1] if cuda else 0
            open(released, "w").close()
        time.sleep(0.02)
    for i, (p, spec, log) in sorted(enumerate(procs),
                                    key=lambda e: e[1][0].returncode is None):
        if p.returncode != 0:
            log.flush()
            with open(log.name) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"vgpu_bench: tenant {i} failed "
                               f"rc={p.returncode}:\n{tail}")
    return used


def main(argv=None, root: str | None = None, device: str | None = None,
         wrap: str | None = None) -> int:
    """One run; ``root`` (default the working directory) holds
    ``BENCHMARK.json``. ``device`` and ``wrap`` are for the rehearsal on
    the CPU and its planted faults: a run leaves them unset, and then needs
    a card."""
    args = parse_args(argv)
    root = os.path.abspath(root or os.getcwd())
    cell, cfg, mix, metrics = load_cell(root, args.workload, args.trace)
    cuda = device in (None, "cuda")
    if mix["wrapped"] and not cuda:
        raise SystemExit("vgpu_bench: a wrapped mix runs under the shim, "
                         "on a card")
    total = before = 0
    if cuda:
        try:
            total, before = card_memory()
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            return no_card(args, cell)
    env = {**cache_env(root), "OMP_NUM_THREADS": "1"}
    shim = build(root, cfg, mix["wrapped"],
                 supervise.child_env(env, root)) if cuda else None
    workdir = tempfile.mkdtemp(prefix="vgpu-bench-")
    procs = []
    try:
        procs = start_tenants(root, cell, cfg, mix, args,
                              "cuda" if cuda else device, wrap, workdir, env,
                              shim, total)
        # torch loads here, while the tenants start
        import torch
        if device is None and (not torch.cuda.is_available() or
                               torch.cuda.device_count() < cell["chips"]):
            return no_card(args, cell)
        card_used = wait_tenants(procs, args.seconds, cuda)
        tenants = []
        for p, spec, log in procs:
            tenants.append(load_json(f"{spec['out']}.json"))
        samples = {}
        for t, (_, spec, _) in zip(tenants, procs):
            samples[t["index"]] = torch.load(f"{spec['out']}.sample.pt")
            if args.trace:
                t["intervals"] = np.load(f"{spec['out']}.trace.npy")
        return report(root, args, cell, cfg, mix, metrics, tenants, samples,
                      card_used, before, "cuda" if cuda else device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
        shutil.rmtree(workdir, ignore_errors=True)


def no_card(args, cell) -> int:
    """No result, exit code 2: the cell needs more cards than there are."""
    print(f"vgpu_bench: {args.workload} needs {cell['chips']} CUDA "
          f"device(s); this machine has fewer", file=sys.stderr)
    return 2


def report(root, args, cell, cfg, mix, metrics, tenants, samples, card_used,
           before, device) -> int:
    for t in tenants:
        t["calls"] = np.asarray(t["calls"], dtype=np.int64).reshape(-1, 3)
    taken = card_used - before if card_used else 0
    items = sum(len(t["calls"]) * t["batch"] for t in tenants)
    run = types.SimpleNamespace(
        config=cfg, traffic=mix, tenants=tenants, items=items,
        window_s=supervise.window(tenants),
        setup_s=min(t["start_ns"] for t in tenants) / 1e9 - T0,
        counts=importlib.import_module(f"vgpu_bench.counts.{cfg['model']}"),
        trace=None)
    if args.trace:
        run.trace = trace.merge(tenants,
                                min(t["start_ns"] for t in tenants),
                                max(t["end_ns"] for t in tenants))
    values = {}
    for m in metrics:
        value = reader(root, m["name"])(run)
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    durations = np.concatenate([t["calls"][:, 2] - t["calls"][:, 0]
                                for t in tenants]) / 1e6
    print(json.dumps({
        "calls": int(len(durations)),
        "call_p50_ms": float(np.median(durations)),
        "tenant_items_per_s": [len(t["calls"]) * t["batch"]
                               / ((t["end_ns"] - t["start_ns"]) / 1e9)
                               for t in tenants],
        "warm_s": [t["warm_s"] for t in tenants],
        "card_taken_bytes": taken,
        "region_used": [t.get("region_used") for t in tenants],
        "set_up_s": [{k: v / 1e9 - T0 for k, v in t["marks"].items()}
                     for t in tenants],
        "device_events": [t.get("device_events") for t in tenants],
        "errors": [e for t in tenants for e in t["errors"]]}))

    # the window is closed and the tenants' memory read: the reference may
    # take the card now
    err, compared = check.logit_err(cfg, args.seed, samples, device)
    checks = {"logit_err": (err, cfg["limits"]["logit_err"]),
              "failed_calls": (sum(t["failed"] for t in tenants), 0)}
    checks.update(check.guarantees(cfg, mix, tenants, taken, run.trace))
    correct = compared > 0 and all(value <= limit
                                   for value, limit in checks.values())
    print(f"compared {compared} sampled calls", file=sys.stderr)

    forbidden = sorted(set(tenant_mod.forbidden_modules()).union(
        *(t["forbidden_modules"] for t in tenants)))
    if forbidden:
        print(f"vgpu_bench: loaded {', '.join(forbidden)}: the benchmark "
              f"runs the port alone", file=sys.stderr)
        return 1
    attempted = sum(len(t["calls"]) for t in tenants)
    result = {"correct": correct, "attempted": attempted,
              "failed": checks["failed_calls"][0], "metrics": values,
              "device": {"platform": "gpu" if device == "cuda" else "cpu",
                         "kind": tenants[0]["device"],
                         "count": cell["chips"],
                         "memory_peak_bytes": card_used}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
