#!/usr/bin/env python3
"""What each test file costs the CPU, run alone.

    python3 hack/test_cpu_cost.py tests/test_torch_run.py [more files ...]

From the root of a checkout (any checkout: the script can time another
tree's tests from there), runs pytest on each file in turn, in a fresh
process (``JAX_PLATFORMS=cpu``, as tier-1 runs it), and prints one line
per file: its wall seconds, the user and system CPU seconds of the
process and every child it waited for, and the machine's CPU seconds
over the run from ``/proc/stat`` (every process: it also counts what a
fork server's children used, which nobody here waits for, so run it on
an otherwise idle machine).
Tier-1 runs the files in parallel (``-n 6 --dist loadfile``) beside
``tests/test_stress.py``, whose scheduler bench has a wall-clock timeout;
the CPU-seconds of the files that run beside it are what the bench
competes with.
"""

import os
import resource
import subprocess
import sys
import time


def machine_cpu_s() -> float:
    """user + nice + system seconds of every CPU since boot."""
    with open("/proc/stat") as f:
        ticks = [int(x) for x in f.readline().split()[1:4]]
    return sum(ticks) / os.sysconf("SC_CLK_TCK")


def main(files: list[str]) -> int:
    rc = 0
    for path in files:
        before = resource.getrusage(resource.RUSAGE_CHILDREN)
        machine = machine_cpu_s()
        start = time.time()
        run = subprocess.run(
            [sys.executable, "-m", "pytest", path, "-q", "-p",
             "no:cacheprovider", "-p", "no:randomly"],
            capture_output=True, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        after = resource.getrusage(resource.RUSAGE_CHILDREN)
        lines = run.stdout.strip().splitlines()
        print(f"{path}: wall {time.time() - start:.1f} s, user "
              f"{after.ru_utime - before.ru_utime:.1f} s, sys "
              f"{after.ru_stime - before.ru_stime:.1f} s, machine "
              f"{machine_cpu_s() - machine:.1f} s | "
              f"{lines[-1] if lines else ''}", flush=True)
        rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
