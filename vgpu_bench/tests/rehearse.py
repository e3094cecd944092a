"""Tiny cells for rehearsing the harness on the CPU.

:func:`root` copies ``vgpu_bench`` into a directory with a
``BENCHMARK.json`` of tiny cells (the two configurations at a few pixels
and steps, unwrapped), so a run there drives every part of a real run but
the card and the shim. :func:`run` calls the supervisor in this process
with the device set to the CPU, which a run from the command line never
does, and returns its exit code and the lines it printed.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {
    "resnet-tiny": ("resnet50-v2.case1.1.json",
                    {"image_size": 32, "batch": 2, "runner_size": 32,
                     "input_shape": [2, 32, 32, 3]}),
    "lstm-tiny": ("lstm.case5.1.json",
                  {"batch": 2, "time_steps": 3, "features": 8,
                   "runner_size": 8, "input_shape": [2, 3, 8],
                   "kernels": []}),
}
DUO = {"tenants": 2, "wrapped": False, "memory_share": 1.0, "core_limit": 0,
       "loop": "closed", "pool": 2, "sample_calls": 3}


def config(name: str) -> dict:
    """A configuration of the benchmark by its file's name, or a tiny one
    of :data:`TINY`."""
    base = os.path.join(REPO, "vgpu_bench", "configs")
    if name in TINY:
        file, changes = TINY[name]
        with open(os.path.join(base, file)) as f:
            return {**json.load(f), **changes, "name": name}
    with open(os.path.join(base, f"{name}.json")) as f:
        return json.load(f)


def root(path: str) -> str:
    """A checkout at ``path`` holding the benchmark and tiny cells: ``r.solo``
    (ResNet, one tenant) and ``l.duo`` (the LSTM, two tenants)."""
    shutil.copytree(os.path.join(REPO, "vgpu_bench"),
                    os.path.join(path, "vgpu_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = []
    for name in TINY:
        file = f"vgpu_bench/configs/{name}.json"
        with open(os.path.join(path, file), "w") as f:
            json.dump(config(name), f)
        bench["configs"].append({"name": name, "source": "tiny", "file": file,
                                 "reduced": [], "why": "rehearsal"})
    with open(os.path.join(path, "vgpu_bench", "traffic", "duo.json"),
              "w") as f:
        json.dump(DUO, f)
    bench["workloads"] = [
        {"name": "r.solo", "config": "resnet-tiny", "traffic": "solo",
         "chips": 1, "why": "rehearsal"},
        {"name": "l.duo", "config": "lstm-tiny", "traffic": "duo",
         "chips": 1, "why": "rehearsal"}]
    for kind in ("end_to_end", "per_layer"):
        # every metric in every tiny cell, but those kept apart for a cell
        bench[kind] = [m for m in bench[kind] if "." not in m["name"]]
        for m in bench[kind]:
            m.pop("workloads", None)
    write_bench(path, bench)
    return path


def write_bench(path: str, bench: dict) -> None:
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)


def run(path: str, workload: str, trace: int = 0, seed: int = 3_000_000_007,
        seconds: float = 1.0, device: str | None = "cpu",
        wrap: str | None = None) -> tuple[int, list[str], str]:
    """(exit code, standard output's lines, standard error) of one run of
    ``workload`` in the checkout ``path``."""
    from vgpu_bench import run as bench_run
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = bench_run.main(
                ["--workload", workload, "--seed", str(seed), "--seconds",
                 str(seconds), "--trace", str(trace)],
                root=path, device=device, wrap=wrap)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            print(e, file=sys.stderr)
    return rc, out.getvalue().splitlines(), err.getvalue()


def result(lines: list[str]) -> dict:
    return json.loads(lines[-1])
