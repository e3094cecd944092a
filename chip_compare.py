#!/usr/bin/env python3
"""Compare the serving paths of two checkouts on one card, in turns.

    python3 chip_compare.py OTHER_TREE [--rounds 2]

OTHER_TREE is another checkout of this repo (for instance the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Each round runs, in a fresh process per tree and in the order
other, this, this, other: the tree's own ``chip_smoke.phase_build``,
``phase_lstm_kernel`` and ``phase_flash_kernel`` (K2's and K3's times
through their wrappers), ``phase_lm_profile`` (the forward's and the
decode call's device time, idle share, kernels and copies a call), the
runner's ``--model lm --mode infer`` line (``tokens_per_s``) and three
of its LSTM case 5.1 lines (``--model lstm``, 500 calls). Prints one
JSON line per phase, tagged with the tree, after the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

_CHILD = """
import json, chip_smoke as c
c.phase_build()
c.phase_lstm_kernel()
c.phase_flash_kernel()
c.phase_lm_profile()
line = c._runner_line(["--model", "lm", "--mode", "infer", "--steps", "5"])
print(json.dumps({"phase": "lm_infer", **line}))
for _ in range(3):
    line = c._runner_line(["--model", "lstm", "--steps", "500"])
    print(json.dumps({"phase": "lstm_case_5_1", **line}))
"""


def run_tree(tree: str, tag: str) -> None:
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"{tag} ({tree}) failed:\n{proc.stderr[-4000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("{") and '"phase": "build"' not in line:
            print(json.dumps({"tree": tag, **json.loads(line)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for _ in range(args.rounds):
        for tree, tag in ((args.other, "other"), (HERE, "this"),
                          (HERE, "this"), (args.other, "other")):
            run_tree(os.path.abspath(tree), tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
