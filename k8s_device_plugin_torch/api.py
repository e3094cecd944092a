"""The in-container env contract, as far as the port reads it.

A copy of the constants the port needs from the JAX package's ``api.py``
(the same names and values), and of its ``gang_process_env``: the device
plugin injects these at Allocate time, and the cooperative limiter and the
multi-device dry run read them inside the container.
"""

from __future__ import annotations

# Per-assigned-device memory cap in bytes; suffix is the local device
# ordinal: VTPU_DEVICE_MEMORY_LIMIT_0, _1, ...
TPU_DEVICE_MEMORY_LIMIT = "VTPU_DEVICE_MEMORY_LIMIT"
# Duty-cycle cap in percent (0/100 = unlimited).
TPU_DEVICE_CORE_LIMIT = "VTPU_DEVICE_CORE_LIMIT"
# Directory holding the shared-region cache file mmapped by shim + monitor.
TPU_DEVICE_CACHE_PATH = "VTPU_DEVICE_MEMORY_SHARED_CACHE"
# "true" -> oversubscription: the memory cap is soft.
TPU_OVERSUBSCRIBE = "VTPU_OVERSUBSCRIBE"
# Task priority: 0 high, 1 low (feedback loop arbitration).
TASK_PRIORITY = "VTPU_TASK_PRIORITY"
# "true" -> disable all enforcement (kill switch, like CUDA_DISABLE_CONTROL).
TPU_DISABLE_CONTROL = "VTPU_DISABLE_CONTROL"
# Physical memory of assigned device <i> in bytes (pre-scaling). Lets
# in-container enforcement derive the allocator bound from the cap.
TPU_DEVICE_HBM_BYTES = "VTPU_DEVICE_HBM_BYTES"
# Core-utilization policy inside the container: default/force/disable.
TPU_CORE_UTILIZATION_POLICY = "VTPU_CORE_UTILIZATION_POLICY"
# "true" -> kill the process on a memory-limit violation instead of only
# reporting it (ACTIVE_OOM_KILLER analog).
ACTIVE_OOM_KILLER = "VTPU_ACTIVE_OOM_KILLER"
# The compile-cache key this worker's executable is cached under: workloads
# record it into the cache manifest the monitor reports.
TPU_COMPILE_CACHE_KEY = "VTPU_COMPILE_CACHE_KEY"
# Directory of the persistent compile cache inside the container; when set,
# workloads/harness.py builds the kernel libraries there, so a re-placed pod
# on this host starts warm.
TPU_COMPILE_CACHE_DIR = "VTPU_COMPILE_CACHE_DIR"
# Manifest of cache keys compiled on this host, kept next to the cache and
# shipped by the monitor with the usage batch: filename and key cap.
COMPILE_CACHE_MANIFEST = "vtpu_cache_keys.json"
COMPILE_CACHE_MANIFEST_MAX_KEYS = 256
# A vouched key older than this is presumed evicted from the cache: the
# writer drops it on rewrite.
COMPILE_CACHE_MANIFEST_MAX_AGE_S = 7 * 24 * 3600.0
# Multi-process and multi-host (gang) identity: the process grid's and a
# process's chip grid's bounds, which member this process is, and every
# member's hostname in worker order.
TPU_PROCESS_BOUNDS = "TPU_PROCESS_BOUNDS"
TPU_CHIPS_PER_PROCESS_BOUNDS = "TPU_CHIPS_PER_PROCESS_BOUNDS"
TPU_WORKER_ID = "TPU_WORKER_ID"
TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"


def _compact_grid(n: int) -> tuple[int, int]:
    """Most-square a x b factorization of n (a >= b): how a member's chips
    tile its local grid in the bounds strings."""
    best = (n, 1)
    for b in range(1, int(n ** 0.5) + 1):
        if n % b == 0:
            best = (n // b, b)
    return best


def gang_process_env(gang_size: int, worker_id: int, hostnames: list[str],
                     chips_per_member: int) -> dict[str, str]:
    """One gang member's process and worker identity, as the device plugin
    renders it from the gang's placement: members striped along the
    process grid's leading axis (one process per member host), each with a
    most-square local chip grid; every member gets the same bounds."""
    chips_a, chips_b = _compact_grid(max(1, chips_per_member))
    return {
        TPU_WORKER_ID: str(worker_id),
        TPU_WORKER_HOSTNAMES: ",".join(hostnames),
        TPU_PROCESS_BOUNDS: f"{max(1, gang_size)},1,1",
        TPU_CHIPS_PER_PROCESS_BOUNDS: f"{chips_a},{chips_b},1",
    }
