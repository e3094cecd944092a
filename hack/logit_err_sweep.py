#!/usr/bin/env python3
"""The benchmark's ``logit_err`` of a configuration over many seeds: the
program's, the float8 control's and, for AFMoE, the program's with a
planted fault, to place the configuration's limit between them.

    python3 hack/logit_err_sweep.py CONFIG --seeds N [--first SEED]
        [--pool 4] [--control] [--faults no_window,no_gate] [--device cuda]

From the root of a checkout: CONFIG names ``vgpu_bench/configs/CONFIG.json``.
For each seed it builds the program as a tenant does
(``vgpu_bench.tenant.build``: the seed's weights), runs the pool's inputs
(``weights.inputs`` of tenant 0, indices 0 .. pool - 1) and hands their
logits to the benchmark's own comparison, ``vgpu_bench.check.logit_err``
(the largest absolute difference from the plain fp32 reference on the
same weights, over the reference's largest magnitude; the widest over the
pool, as a run of the cell reads the widest over its sampled calls, which
cover the pool). With ``--control`` the check's float8 control is read
too; each fault runs the program with one mechanism removed. It prints
one JSON line a seed, then one line of the ranges over the seeds. It
loads nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _faults() -> dict:
    """{name: a context that plants the fault in the program}: AFMoE's
    sliding layers run causal without their window, or its attention
    output goes ungated."""
    from k8s_device_plugin_torch.workloads import afmoe
    absorb = afmoe.flash_attention
    return {
        "no_window": lambda: mock.patch.object(
            afmoe, "flash_attention",
            lambda q, k, v, window=0: absorb(q, k, v)),
        "no_gate": lambda: mock.patch.object(afmoe, "output_gate",
                                             lambda o, g: o),
    }


def readings(cfg, seed: int, device, pool: int, control: bool,
             faults: list[str]) -> dict:
    """The seed's widest gap over its pool, as the benchmark reads it
    (``vgpu_bench.check.logit_err``): the program's and, as asked, the
    float8 control's and each fault's. The logits are collected first and
    the model freed, since the check makes the seed's weights anew."""
    import torch
    from k8s_device_plugin_torch.workloads import harness
    from vgpu_bench import check, tenant, weights
    plant = _faults() if faults else {}
    model = tenant.build(cfg, seed, device)
    infer = harness.make_infer_fn(model)
    logits = {name: [] for name in ["program", *faults]}
    for j in range(pool):
        x = weights.inputs(cfg, seed, 0, j, device)
        logits["program"].append((j, infer(x).cpu()))
        for name in faults:
            with plant[name]():
                logits[name].append((j, infer(x).cpu()))
    del model, infer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed}
    for name, items in logits.items():
        out[name] = check.logit_err(cfg, seed, {0: items}, device)[0]
    if control:
        out["control"] = check.logit_err(cfg, seed, {0: logits["program"]},
                                         device, control=True)[0]
    return out


def ranges(lines: list[dict]) -> dict:
    """{reading: [narrowest, widest]} over the seeds."""
    keys = [k for k in lines[0] if k != "seed"]
    return {k: [min(ln[k] for ln in lines), max(ln[k] for ln in lines)]
            for k in keys}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("logit_err_sweep")
    p.add_argument("config")
    p.add_argument("--seeds", type=int, required=True)
    p.add_argument("--first", type=int, default=2 ** 31 + 11)
    p.add_argument("--pool", type=int, default=4)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    with open(os.path.join(ROOT, "vgpu_bench", "configs",
                           f"{args.config}.json")) as f:
        cfg = json.load(f)
    faults = [f for f in args.faults.split(",") if f]
    unknown = set(faults) - set(_faults() if faults else {})
    if unknown:
        raise SystemExit(f"logit_err_sweep: no fault {sorted(unknown)}")
    device = torch.device(args.device)
    lines = []
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        lines.append(readings(cfg, seed, device, args.pool, args.control,
                              faults))
        print(json.dumps(lines[-1]), flush=True)
    print(json.dumps({"config": args.config, "seeds": len(lines),
                      "ranges": ranges(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
