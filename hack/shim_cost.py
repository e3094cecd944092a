#!/usr/bin/env python3
"""What the enforcement shim costs the 4-way share, on one card.

    python3 hack/shim_cost.py [--rounds 2]

From the root of a checkout, on a machine with one NVIDIA GPU: the port
bench's native run once (the card's memory and the baseline), then the
4-way ResNet-50 share at ai-benchmark case 1.1 in turns, wrapped, plain,
plain, wrapped for each round: ``wrapped`` with every child under
``libvtpu_cuda.so``, ``plain`` under the cooperative limiter
(``k8s_device_plugin_torch.bench``, ``--child-mode``). Prints the card's
name and power limit, one JSON line per share, then a summary: each
mode's img/s and the ratio of the wrapped median to the plain one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("shim_cost")
    p.add_argument("--rounds", type=int, default=2)
    opts = p.parse_args(argv)
    sys.path.insert(0, HERE)
    os.chdir(HERE)  # the bench's children import the port from here
    import torch
    from k8s_device_plugin_torch import bench
    if not torch.cuda.is_available():
        print("shim_cost: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    rates = {"wrapped": [], "plain": []}
    with tempfile.TemporaryDirectory(prefix="shim-cost-") as workdir:
        native = bench.run_native(bench.parse_args([]), workdir)
        print(json.dumps({"native_img_per_s": native["img_per_s"]}),
              flush=True)
        for r in range(opts.rounds):
            for mode in ("wrapped", "plain", "plain", "wrapped"):
                share = bench.run_share(
                    bench.parse_args(["--child-mode", mode]),
                    native["total_bytes"], workdir)
                rates[mode].append(share["img_per_s"])
                print(json.dumps({"round": r, "mode": mode,
                                  "img_per_s": share["img_per_s"],
                                  "vs_baseline": share["img_per_s"]
                                  / native["img_per_s"],
                                  "violations": share["violations"]}),
                      flush=True)
    print(json.dumps({
        "wrapped_img_per_s": rates["wrapped"],
        "plain_img_per_s": rates["plain"],
        "wrapped_over_plain": statistics.median(rates["wrapped"])
        / statistics.median(rates["plain"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
