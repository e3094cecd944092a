"""The control's readings of ``logit_err`` at a cell's own size.

For each seed, the inputs that a run of the cell could sample (every
tenant's pool) are held against the fp32 reference as the control computes
them: the reference in float8 in the program's place. Prints one JSON line
per seed. The program's own readings are the ``logit_err`` check lines of
the cell's runs.

Usage: ``python -m vgpu_bench.control --workload <cell> --seeds 1,2,3``
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from . import check, run
    p = argparse.ArgumentParser("vgpu_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("vgpu_bench.control: no card")
    _, cfg, mix, _ = run.load_cell(os.getcwd(), args.workload, False)
    pools = {i: list(range(mix["pool"])) for i in range(mix["tenants"])}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        err, n = check.logit_err(
            cfg, seed, {i: [(j, torch.zeros(1)) for j in js]
                        for i, js in pools.items()}, "cuda", control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": "control", "logit_err": err,
                          "compared": n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
