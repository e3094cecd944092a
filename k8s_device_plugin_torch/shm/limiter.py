"""Cooperative in-container limiter for PyTorch/CUDA workloads.

Counterpart of ``k8s_device_plugin_tpu/shm/limiter.py``: the same
``VTPU_*`` env contract, the same shared region, the same duty-cycle token
bucket. What changes is how the limiter sees and bounds device memory:

* usage comes from PyTorch's caching allocator (``torch.cuda.memory_reserved``)
  and lands in the process's shared-region slot, so the monitor and limits
  see real usage;
* over the cap -> count a violation, and with ``VTPU_ACTIVE_OOM_KILLER``
  kill the process (the reference's ACTIVE_OOM_KILLER semantics);
* the allocator itself is bounded with
  ``torch.cuda.set_per_process_memory_fraction(cap / total)``, so a burst
  between two polls fails its allocation instead of taking a neighbour's
  memory;
* ``throttle()`` is called around dispatch and drains the same token bucket
  as the C shim and the JAX limiter.

Activate with ``install()`` inside the container.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from .. import api
from .region import KIND_BUFFER, Region

log = logging.getLogger(__name__)

#: the duty-cycle token bucket's capacity in device microseconds (the C
#: shim's and the JAX limiter's): its burst, and the largest cost one
#: ``throttle`` call can be granted
BUCKET_CAPACITY_US = 200000


def _env_true(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "on", "yes")


class CooperativeLimiter:
    def __init__(self, poll_interval: float = 0.1):
        self.poll_interval = poll_interval
        self.region: Region | None = None
        self.slot = -1
        self.enabled = False
        #: allocator fraction set per device ordinal by install()
        self.memory_fractions: dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._violations = 0

    # ------------------------------------------------------------- lifecycle

    def install(self) -> bool:
        if _env_true(api.TPU_DISABLE_CONTROL):
            log.info("vtpu limiter disabled by kill switch")
            return False
        cache = os.environ.get(api.TPU_DEVICE_CACHE_PATH)
        if not cache:
            return False
        os.makedirs(cache, exist_ok=True)
        self.region = Region(os.path.join(cache, "vtpu.cache"))
        limits = []
        i = 0
        while True:
            v = os.environ.get(f"{api.TPU_DEVICE_MEMORY_LIMIT}_{i}")
            if v is None:
                break
            limits.append(int(v))
            i += 1
        core = os.environ.get(api.TPU_DEVICE_CORE_LIMIT)
        self.region.set_limits(limits, int(core) if core else None)
        self._bound_allocator(limits)
        if _env_true(api.TPU_OVERSUBSCRIBE):
            self.region.data.oversubscribe = 1
        prio = os.environ.get(api.TASK_PRIORITY)
        if prio:
            self.region.data.priority = int(prio)
        self.slot = self.region.attach(os.getpid())
        self.enabled = True
        from .region import _native_shm
        if core and _native_shm() is None:
            # duty-cycle fairness vs C sharers needs the shared sem lock;
            # fcntl alone only excludes other Python processes
            log.warning(
                "vtpu: libvtpu_shm.so not loadable — duty-cycle bucket "
                "updates are not atomic vs native shim processes "
                "(set VTPU_SHM_LIB or ship the lib next to libvtpu.so)")
        self._thread = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="vtpu-limiter")
        self._thread.start()
        log.info("vtpu cooperative limiter active (limits=%s)", limits)
        return True

    def _bound_allocator(self, limits: list[int]) -> None:
        """Hard bound: cap PyTorch's caching allocator at ``limit / total``
        of each device, the counterpart of the JAX limiter's reserved-HBM
        flag. ``total`` is ``VTPU_DEVICE_HBM_BYTES_<i>`` when the plugin
        injected it, else the device's own total. Without a CUDA device
        there is nothing to bound."""
        if _env_true(api.TPU_OVERSUBSCRIBE):
            return  # oversubscription: the cap is intentionally soft
        import torch
        if not torch.cuda.is_available():
            return
        for dev, limit in enumerate(limits[:torch.cuda.device_count()]):
            if limit <= 0:
                continue
            hbm = os.environ.get(f"{api.TPU_DEVICE_HBM_BYTES}_{dev}") \
                or (os.environ.get(api.TPU_DEVICE_HBM_BYTES) if dev == 0
                    else None)
            total = int(hbm) if hbm else torch.cuda.mem_get_info(dev)[1]
            fraction = min(1.0, limit / total)
            torch.cuda.set_per_process_memory_fraction(fraction, dev)
            self.memory_fractions[dev] = fraction
            log.info("vtpu: bounded CUDA allocator on device %d to %.4f",
                     dev, fraction)

    def uninstall(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        if self.region is not None:
            self.region.detach(os.getpid())
            self.region.close()
            self.region = None
        self.enabled = False

    # ---------------------------------------------------------- memory poll

    def _device_stats(self):
        """``bytes_in_use`` per device is ``torch.cuda.memory_reserved``:
        the bytes the caching allocator holds from the device, whether or
        not a live tensor uses them. That is what this process takes from
        its neighbours and what ``set_per_process_memory_fraction`` bounds;
        ``memory_allocated`` (live tensors only) would under-report a
        process whose cache keeps freed blocks. The CUDA context itself is
        outside the allocator and not counted. Before CUDA is initialised
        there is nothing to report, and the poll must not initialise it."""
        import torch
        if not torch.cuda.is_initialized():
            return []
        return [(i, {"bytes_in_use": torch.cuda.memory_reserved(i)})
                for i in range(torch.cuda.device_count())]

    @property
    def observe_only(self) -> bool:
        """True when HAMi-core's ``libvgpu.so`` is preloaded: it owns the
        accounting and maintains ``used`` itself, so the poll writes the
        observed value into ``monitor_used`` instead of clobbering it."""
        return any(p.endswith("libvgpu.so") for p in
                   os.environ.get("LD_PRELOAD", "").replace(":", " ").split())

    def poll_once(self, stats=None) -> list[int]:
        """Write usage into the region; returns devices over their limit."""
        if not self.enabled or self.region is None:
            return []
        stats = stats if stats is not None else self._device_stats()
        over = []
        observe = self.observe_only
        slot = self.region.data.procs[self.slot]
        for dev, st in stats:
            if dev >= len(slot.used):
                continue
            used = int(st.get("bytes_in_use", 0))
            if observe:
                slot.monitor_used[dev] = used
            else:
                slot.used[dev].kinds[KIND_BUFFER] = used
                slot.used[dev].total = used
            limit = self.region.data.limit[dev]
            if limit and not self.region.data.oversubscribe and used > limit:
                over.append(dev)
        return over

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            over = self.poll_once()
            if over:
                self._violations += 1
                log.error("vtpu: memory limit exceeded on devices %s", over)
                if _env_true(api.ACTIVE_OOM_KILLER):
                    log.error("vtpu: ACTIVE_OOM_KILLER set; terminating")
                    os._exit(137)

    @property
    def violations(self) -> int:
        return self._violations

    # ---------------------------------------------------------- duty cycle

    def throttle(self, est_device_us: float, dev: int = 0) -> float:
        """Token-bucket wait before a dispatch; returns seconds slept.

        The bucket lives in the shared region (v2 ABI) so Python and C
        sharers of the slice drain ONE budget; mutations run under the
        cross-language lock. ``VTPU_CORE_UTILIZATION_POLICY=disable``
        frees the duty cycle (memory limits stay) — the reference's
        GPU_CORE_UTILIZATION_POLICY. The algebra is the JAX limiter's,
        unchanged.
        """
        if not self.enabled or self.region is None:
            return 0.0
        if os.environ.get(api.TPU_CORE_UTILIZATION_POLICY) == "disable":
            return 0.0
        data = self.region.data
        pct = data.sm_limit[dev]
        if pct == 0 or pct >= 100:
            return 0.0
        slept = 0.0
        cap = BUCKET_CAPACITY_US
        while True:
            if data.recent_kernel < 0 and data.utilization_switch > 0:
                time.sleep(0.002)
                slept += 0.002
                continue
            with self.region.locked():
                now = int(time.monotonic() * 1e6)  # CLOCK_MONOTONIC, as C
                if data.duty_refill_us[dev] == 0:
                    data.duty_refill_us[dev] = now
                    data.duty_tokens_us[dev] = cap
                elapsed = max(0, now - data.duty_refill_us[dev])
                data.duty_refill_us[dev] = now
                tokens = min(cap, data.duty_tokens_us[dev]
                             + elapsed * pct // 100)
                granted = tokens >= est_device_us
                if granted:
                    tokens -= int(est_device_us)
                data.duty_tokens_us[dev] = tokens
            if granted:
                data.last_kernel_time = int(time.time())
                return slept
            need = (est_device_us - tokens) / 1e6 * 100.0 / pct
            step = min(need, 0.05)
            time.sleep(step)
            slept += step


_limiter: CooperativeLimiter | None = None


def install() -> CooperativeLimiter | None:
    global _limiter
    if _limiter is None:
        lim = CooperativeLimiter()
        if lim.install():
            _limiter = lim
    return _limiter


def get() -> CooperativeLimiter | None:
    return _limiter
