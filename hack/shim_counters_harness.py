"""Read the shim's counters in the benchmark's cells, outside the benchmark.

``vgpu_bench`` does not read ``k8s_device_plugin_torch.shm.counters`` yet.
This script lays the readings over a copy of a checkout, so that its
traced runs print five more per-layer metrics and a ``shimcheck`` line on
standard error, and runs cells in such copies on the card. It edits the
copy only, never the checkout it runs from.

The edits to the copy:

- ``vgpu_bench/tenant.py`` reads the counters of ordinal 0, the next
  span's number and the K2/K3 launch counts just before the window's first
  stamp and just after its last call (before the region closes), never
  inside the window. The tenant's result gains the differences (``shim``,
  None when unwrapped; ``kernel_launches``), and the spans numbered
  between go to ``<out>.spans.npy``;
- ``vgpu_bench/run.py`` loads the spans, adds ``shim`` and
  ``kernel_launches`` per tenant to its diagnostic line, and prints
  ``shimcheck`` (:data:`SHIM_CHECK`);
- ``vgpu_bench/trace.py`` ``merge`` keeps the window's idle intervals
  under ``idle``;
- five readers in ``vgpu_bench/metrics/`` (:data:`METRICS`) and their
  ``per_layer`` entries in ``BENCHMARK.json`` (:data:`PER_LAYER`).

Usage, from the root of a checkout::

    python3 hack/shim_counters_harness.py patch COPY
    python3 hack/shim_counters_harness.py run OUT LABEL=DIR:CELL:SEED:TRACE ...

``run`` runs each cell once in turn, ``python3 -m vgpu_bench.run`` from
``DIR``, writes ``OUT/LABEL.out`` and ``OUT/LABEL.err``, and prints one
line a run: its label, cell, seed, trace flag, seconds and metrics (or
the tail of its error), then a short ``shimcheck`` where the run printed
one. It stops after ``--give-up`` failed runs in a row.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: (file, text the copy holds, text it gets instead)
EDITS = [
    ("vgpu_bench/tenant.py", """    calls, kept, errors, failed = [], [], [], 0
    gc.disable()  # no collector pauses inside the window
""", """    calls, kept, errors, failed = [], [], [], 0
    from k8s_device_plugin_torch import _build
    from k8s_device_plugin_torch.shm import counters as shim_counters

    def edge():
        got = shim_counters.spans(0)
        return (shim_counters.counters(0), None if got is None else got[1],
                _build.launches["lstm_cell"], _build.launches["flash_absorb"])
    before = edge()
    gc.disable()  # no collector pauses inside the window
"""),
    ("vgpu_bench/tenant.py", """    gc.enable()
    end = calls[-1][2]
""", """    after = edge()
    gc.enable()
    end = calls[-1][2]
"""),
    ("vgpu_bench/tenant.py", """    if prof is not None:
        summary = trace.summarize(prof, device, start, end)""",
     """    result["shim"] = None if before[0] is None else {
        k: after[0][k] - before[0][k] for k in before[0]}
    result["kernel_launches"] = {"lstm_cell": after[2] - before[2],
                                 "flash_absorb": after[3] - before[3]}
    if before[1] is not None:
        rows = shim_counters.spans(before[1])[0]
        rows = [r for r in rows if r[1] <= end + 10**9]
        np.save(f"{spec['out']}.spans.npy",
                np.asarray(rows, dtype=np.int64).reshape(-1, 5))
    if prof is not None:
        summary = trace.summarize(prof, device, start, end)"""),
    ("vgpu_bench/run.py", """            if args.trace:
                t["intervals"] = np.load(f"{spec['out']}.trace.npy")""",
     """            if args.trace:
                t["intervals"] = np.load(f"{spec['out']}.trace.npy")
            if os.path.exists(f"{spec['out']}.spans.npy"):
                t["spans"] = np.load(f"{spec['out']}.spans.npy")"""),
    ("vgpu_bench/run.py", """        "errors": [e for t in tenants for e in t["errors"]]}))""",
     """        "errors": [e for t in tenants for e in t["errors"]],
        "shim": [t.get("shim") for t in tenants],
        "kernel_launches": [t.get("kernel_launches") for t in tenants]}))
    print("shimcheck " + json.dumps(shim_check(run)), file=sys.stderr)"""),
    ("vgpu_bench/trace.py", """    gaps = []
    for k in np.flatnonzero(~busy & (length > 0)):
        if gaps and gaps[-1][1] == points[k]:
            gaps[-1][1] = points[k + 1]
        else:
            gaps.append([points[k], points[k + 1]])
""", """    gaps = []
    for k in np.flatnonzero(~busy & (length > 0)):
        if gaps and gaps[-1][1] == points[k]:
            gaps[-1][1] = points[k + 1]
        else:
            gaps.append([points[k], points[k + 1]])
    idle = np.asarray(gaps, dtype=np.int64).reshape(-1, 2)
"""),
    ("vgpu_bench/trace.py", """            "attributed_s": [float(a) for a in attributed],""",
     """            "attributed_s": [float(a) for a in attributed],
            "idle": idle,"""),
]

#: put before run.py's ``report``: per tenant, its calls, the counters a
#: call, the hook's and the driver's us a launch, the spans in the window
#: and the share of them inside the tenant's own [issue, return], and with
#: a trace the kernels it holds (no Memset/Memcpy) and their top names
SHIM_CHECK = '''def shim_check(run) -> dict:
    out = []
    for t in run.tenants:
        calls = t["calls"]
        row = {"calls": int(len(calls)),
               "enqueue_ms": float((calls[:, 1] - calls[:, 0]).mean() / 1e6),
               "kernel_launches": t.get("kernel_launches")}
        shim = t.get("shim")
        if shim:
            n = len(calls)
            row.update({k: v / n for k, v in shim.items()})
            row["hook_us_per_launch"] = shim["hook_ns"] / max(
                shim["launches"], 1) / 1e3
            row["driver_us_per_launch"] = shim["driver_ns"] / max(
                shim["launches"], 1) / 1e3
            row["timed_us_per_timed"] = shim["timed_us"] / max(
                shim["timed"], 1)
        sp = t.get("spans")
        if sp is not None and len(sp):
            w = sp[(sp[:, 1] > t["start_ns"]) & (sp[:, 0] < t["end_ns"])]
            k = np.searchsorted(calls[:, 0], w[:, 0], side="right") - 1
            ok = (k >= 0) & (w[:, 1] <= calls[np.maximum(k, 0), 1])
            row["window_spans"] = int(len(w))
            row["spans_inside_call"] = float(ok.mean()) if len(w) else None
            row["span_ms_in_window"] = float(
                (np.minimum(w[:, 1], t["end_ns"])
                 - np.maximum(w[:, 0], t["start_ns"])).sum() / 1e6)
        if "intervals" in t:
            names = t["names"]
            keep = [i for i, nm in enumerate(names)
                    if not nm.startswith(("Memset", "Memcpy"))]
            iv = t["intervals"]
            row["trace_kernels"] = int(np.isin(iv[:, 2], keep).sum())
            row["trace_memops"] = int(len(iv) - row["trace_kernels"])
            row["trace_top_names"] = sorted(
                ((int((iv[:, 2] == i).sum()), names[i]) for i in keep),
                reverse=True)[:8]
        out.append(row)
    return {"tenants": out}


'''

#: ``vgpu_bench/metrics/<name>.py`` for each new metric
METRICS = {
    "launches_per_call": '''"""The shim's launches in the window over the tenant's calls, mean over
the wrapped tenants."""


def read(run):
    got = [t["shim"]["launches"] / len(t["calls"]) for t in run.tenants
           if t.get("shim")]
    return sum(got) / len(got) if got else None
''',
    "shim_hook_us": '''"""The shim's own time in its launch hooks, less the bucket's sleeps, in
us a launch, mean over the wrapped tenants."""


def read(run):
    got = [t["shim"]["hook_ns"] / t["shim"]["launches"] / 1e3
           for t in run.tenants if t.get("shim") and t["shim"]["launches"]]
    return sum(got) / len(got) if got else None
''',
    "shim_sleep_ms": '''"""The time the shim's bucket slept in the window, in ms a call, mean
over the wrapped tenants."""


def read(run):
    got = [t["shim"]["slept_ns"] / len(t["calls"]) / 1e6
           for t in run.tenants if t.get("shim")]
    return sum(got) / len(got) if got else None
''',
    "charge_over_device": '''"""What the bucket granted a tenant over its device time in the trace,
in %, mean over the wrapped tenants."""


def read(run):
    if run.trace is None:
        return None
    got = [t["shim"]["granted_us"] / 1e6 / s
           for t, s in zip(run.tenants, run.trace["attributed_s"])
           if t.get("shim") and s > 0]
    return 100.0 * sum(got) / len(got) if got else None
''',
    "bucket_idle_share": '''"""The share of the window, in %, in which the card was idle while at
least one tenant's host was inside a bucket-wait span."""

import numpy as np


def _union(iv):
    iv = iv[np.argsort(iv[:, 0])]
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def read(run):
    if run.trace is None or "idle" not in run.trace:
        return None
    spans = [t["spans"][:, :2] for t in run.tenants if "spans" in t]
    if not spans:
        return None
    t0 = min(t["start_ns"] for t in run.tenants)
    t1 = max(t["end_ns"] for t in run.tenants)
    waits = _union(np.clip(np.concatenate(spans), t0, t1))
    idle = run.trace["idle"]
    both = 0
    for a, b in idle:
        lo = np.maximum(waits[:, 0], a)
        hi = np.minimum(waits[:, 1], b)
        both += np.clip(hi - lo, 0, None).sum()
    return 100.0 * both / (t1 - t0)
''',
}

SHIM_LAYER = "shim: csrc/vtpu_cuda_preload.c duty bucket over csrc/vtpu_shm.c"
SHARE4 = ["resnet50.share4", "lstm.share4"]
CORE25 = ["resnet50.share4-core25"]
#: the new entries of ``BENCHMARK.json``'s ``per_layer``
PER_LAYER = [
    {"name": "launches_per_call", "unit": "launches", "better": "lower",
     "source": "host_clock", "layer": SHIM_LAYER, "moves": "items_per_s",
     "workloads": SHARE4},
    {"name": "shim_hook_us", "unit": "us", "better": "lower",
     "source": "host_clock", "layer": SHIM_LAYER, "moves": "items_per_s",
     "workloads": SHARE4},
    {"name": "shim_sleep_ms.core25", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": SHIM_LAYER,
     "moves": "items_per_s.core25", "workloads": CORE25},
    {"name": "charge_over_device.core25", "unit": "%", "better": "lower",
     "source": "device_trace", "layer": SHIM_LAYER,
     "moves": "items_per_s.core25", "workloads": CORE25},
    {"name": "bucket_idle_share.core25", "unit": "%", "better": "lower",
     "source": "device_trace", "layer": "device",
     "moves": "items_per_s.core25", "workloads": CORE25},
]


def patch(root: str) -> None:
    """Lays the readings over the copy at ``root``."""
    edits = EDITS + [("vgpu_bench/run.py", "def report(root, args,",
                      SHIM_CHECK + "def report(root, args,")]
    for path, old, new in edits:
        p = os.path.join(root, path)
        with open(p) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"{path}: the text to replace is not there")
        with open(p, "w") as f:
            f.write(text.replace(old, new, 1))
    for name, text in METRICS.items():
        with open(os.path.join(root, "vgpu_bench", "metrics", f"{name}.py"),
                  "w") as f:
            f.write(text)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"] += PER_LAYER
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)


def _short_check(err: str) -> str | None:
    """The ``shimcheck`` line of a run's standard error, a few fields a
    tenant."""
    line = [ln for ln in err.splitlines() if ln.startswith("shimcheck ")]
    if not line:
        return None
    keys = ("calls", "launches", "hook_us_per_launch",
            "driver_us_per_launch", "slept_ns", "granted_us",
            "spans_inside_call", "trace_kernels")
    rows = json.loads(line[-1][len("shimcheck "):])["tenants"]
    return json.dumps([{k: r[k] for k in keys if k in r} for r in rows])


def run(out: str, specs: list[str], seconds: int, timeout: int,
        give_up: int) -> int:
    """Runs each ``LABEL=DIR:CELL:SEED:TRACE`` once in turn."""
    os.makedirs(out, exist_ok=True)
    failed = 0
    for spec in specs:
        label, rest = spec.split("=", 1)
        root, cell, seed, traced = rest.rsplit(":", 3)
        cmd = [sys.executable, "-m", "vgpu_bench.run", "--workload", cell,
               "--seed", seed, "--seconds", str(seconds), "--trace", traced]
        t0 = time.time()
        try:
            res = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, timeout=timeout)
            rc, stdout, stderr = res.returncode, res.stdout, res.stderr
        except subprocess.TimeoutExpired as e:
            rc = "timeout"
            stdout, stderr = (e.stdout or b"", e.stderr or b"")
            stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
            stderr = stderr.decode() if isinstance(stderr, bytes) else stderr
        took = time.time() - t0
        with open(os.path.join(out, f"{label}.out"), "w") as f:
            f.write(stdout)
        with open(os.path.join(out, f"{label}.err"), "w") as f:
            f.write(stderr)
        lines = stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
            said = json.dumps({"correct": result["correct"],
                               **result["metrics"]})
        except (IndexError, ValueError, KeyError):
            said = json.dumps({"rc": rc, "err": stderr[-600:]})
            result = None
        print(label, cell, seed, traced, f"{took:.0f}s", said, flush=True)
        check = _short_check(stderr)
        if check:
            print(" ", label, "shimcheck", check, flush=True)
        failed = 0 if result is not None and rc == 0 else failed + 1
        if failed >= give_up:
            print(f"{failed} runs failed in a row: stopped", flush=True)
            return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    p = sub.add_parser("patch", help="lay the readings over a copy")
    p.add_argument("copy")
    r = sub.add_parser("run", help="run cells in turn")
    r.add_argument("out")
    r.add_argument("specs", nargs="+", metavar="LABEL=DIR:CELL:SEED:TRACE")
    r.add_argument("--seconds", type=int, default=10)
    r.add_argument("--timeout", type=int, default=240,
                   help="seconds a run may take")
    r.add_argument("--give-up", type=int, default=3,
                   help="failed runs in a row that end the series")
    args = ap.parse_args(argv)
    if args.what == "patch":
        patch(args.copy)
        return 0
    return run(args.out, args.specs, args.seconds, args.timeout,
               args.give_up)


if __name__ == "__main__":
    sys.exit(main())
