"""The share's supervision, copied from the port's ``bench.py`` so that a
change there cannot move the yardstick: each tenant's environment and
region (``_share_envs``, ``_child_env``), the warm-up lock and the
barriers, the shim's live check (``shim_region``), the bucket's drain
(``drain_bucket``), and the window from the first start to the last end
(``aggregate``).
"""

from __future__ import annotations

import os
import re
import sys
import tempfile
import time

#: the variables of the contract a container receives at Allocate time; a
#: tenant starts from the ones it is given, never inherited ones
CONTRACT = ("VTPU_DEVICE_MEMORY_SHARED_CACHE", "VTPU_DEVICE_MEMORY_LIMIT_0",
            "VTPU_DEVICE_CORE_LIMIT", "VTPU_OVERSUBSCRIBE",
            "VTPU_DISABLE_CONTROL")
#: the shim's duty-cycle bucket: its capacity in device microseconds
BUCKET_CAPACITY_US = 200000
BARRIER_TIMEOUT_S = 300.0


def is_shim(path: str) -> bool:
    """Whether ``path`` names the enforcement shim: installed as
    ``libvtpu_cuda.so``, built as ``libvtpu_cuda-<hash>.so``."""
    return re.fullmatch(r"libvtpu_cuda(-[0-9a-f]+)?\.so",
                        os.path.basename(path)) is not None


def share_envs(n: int, cap: int, core_limit: int, workdir: str) -> list[dict]:
    """The contract of ``n`` wrapped tenants: each its own region and
    ``cap``, and ``core_limit`` where it is above 0."""
    envs = []
    for i in range(n):
        env = {"VTPU_DEVICE_MEMORY_SHARED_CACHE": tempfile.mkdtemp(
                   prefix=f"region{i}-", dir=workdir),
               "VTPU_DEVICE_MEMORY_LIMIT_0": str(cap)}
        if core_limit:
            env["VTPU_DEVICE_CORE_LIMIT"] = str(core_limit)
        envs.append(env)
    return envs


def child_env(extra: dict[str, str], root: str,
              shim: str | None = None) -> dict[str, str]:
    """A tenant's environment: the contract in ``extra`` and no inherited
    one; the shim preloaded when ``shim`` is its path, never otherwise;
    ``root`` first on the path."""
    env = dict(os.environ)
    for var in CONTRACT:
        env.pop(var, None)
    preload = [p for p in env.pop("LD_PRELOAD", "").replace(":", " ").split()
               if not is_shim(p)]
    if shim or preload:
        env["LD_PRELOAD"] = " ".join(([shim] if shim else []) + preload)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    env.update(extra)
    return env


def lock_acquire(path: str):
    """Exclusive lock on ``path`` among the tenants (the warm-up)."""
    import fcntl
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    return fd


def lock_release(fd) -> None:
    import fcntl
    fcntl.flock(fd, fcntl.LOCK_UN)
    os.close(fd)


def barrier_arrive(path: str) -> None:
    fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    os.write(fd, b"x")
    os.close(fd)


def barrier_full(path: str, n: int) -> bool:
    return os.path.exists(path) and os.path.getsize(path) >= n


def barrier_wait(path: str, n: int) -> None:
    """Arrive and park until all ``n`` tenants have. A timeout means a
    sibling died or stalled: fail, since a window over tenants that did
    not overlap would overstate the share."""
    barrier_arrive(path)
    deadline = time.time() + BARRIER_TIMEOUT_S
    while time.time() < deadline:
        if barrier_full(path, n):
            return
        time.sleep(0.001)
    print("tenant: barrier timeout (sibling died?)", file=sys.stderr)
    sys.exit(3)


def wait_for(path: str) -> None:
    """Park until ``path`` exists (the supervisor's word to go on)."""
    deadline = time.time() + BARRIER_TIMEOUT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise SystemExit(f"tenant: no {os.path.basename(path)} from "
                             "the supervisor")
        time.sleep(0.005)


def shim_region(cap: int):
    """The region of a wrapped tenant, once the shim is shown live: the
    card reports ``cap`` as its total memory and the region holds this
    process. Raises SystemExit otherwise: the shim fails open by design,
    so a tenant it does not hold must not be measured."""
    import torch
    from k8s_device_plugin_torch.shm.region import Region
    cache = os.environ.get("VTPU_DEVICE_MEMORY_SHARED_CACHE")
    total = torch.cuda.mem_get_info()[1]
    if not cache or total != cap:
        raise SystemExit(f"tenant: the shim is not live (the card reports "
                         f"{total} bytes, the cap is {cap})")
    region = Region(os.path.join(cache, "vtpu.cache"), create=False)
    if os.getpid() not in [p.pid for p in region.active_procs()]:
        region.close()
        raise SystemExit("tenant: the shim is not live (its region holds "
                         "no slot of this process)")
    return region


def drained(region, dev: int = 0) -> bool:
    """Whether the shim's bucket holds less than a tenth of its capacity:
    the burst it starts with is spent (``bench.drain_bucket``'s test)."""
    data = region.data
    return bool(data.duty_refill_us[dev]) and \
        data.duty_tokens_us[dev] < BUCKET_CAPACITY_US // 10


def window(tenants: list[dict]) -> float:
    """Seconds from the first tenant's start to the last one's end."""
    return (max(t["end_ns"] for t in tenants)
            - min(t["start_ns"] for t in tenants)) / 1e9
