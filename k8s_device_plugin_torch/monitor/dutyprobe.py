"""Calibrated device-occupancy probe on a hand-written CUDA kernel.

Counterpart of ``k8s_device_plugin_tpu/monitor/dutyprobe.py``. The monitor
measures occupancy empirically: a compute-bound kernel of calibrated
idle-card runtime ``t0`` is launched periodically; when tenants occupy the
card the probe's wall time stretches to ``t``, and ``t0 / t`` estimates the
fraction of device time available.

:class:`TorchProbe` is the runner (``PallasProbe``'s interface: lazy build,
warm-up, each call returns wall seconds). On CUDA it launches
``csrc/probe_chain.cu`` through :func:`probe_chain`: an fp32 matmul chain
held in shared memory on every SM, so it measures compute availability,
moves no device memory and cannot trip a tenant's memory cap. On the CPU
:func:`probe_chain` runs :func:`probe_chain_reference`. :class:`DutyProbe`
is a copy of the JAX package's framework-free sampler.
"""

from __future__ import annotations

import ctypes
import logging
import time

import numpy as np
import torch

from .. import _build

log = logging.getLogger(__name__)

#: EMA weight of the newest availability sample (higher = jumpier)
DEFAULT_ALPHA = 0.4
#: idle-card time of one probe launch that calibration aims for
TARGET_MS = 5.0

# x, w, out, sink, n, steps, grid
PROBE_CHAIN = _build.Kernel("probe_chain", "vtpu_probe_chain",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3)


def probe_chain_reference(x: torch.Tensor, w: torch.Tensor,
                          steps: int) -> torch.Tensor:
    """``steps`` chained fp32 products ``y <- y @ w``, starting at ``x``."""
    y = x
    for _ in range(steps):
        y = y @ w
    return y


def probe_chain(x: torch.Tensor, w: torch.Tensor, steps: int) -> torch.Tensor:
    """The probe chain: on CUDA one launch of the kernel with one block per
    SM, each running the whole chain; on the CPU the plain version. x and w are [n, n] fp32 with n a multiple of 4 and
    at most 128 (both stay in one SM's shared memory)."""
    if x.device.type == "cpu":
        return probe_chain_reference(x, w, steps)
    if x.device.type != "cuda":
        raise ValueError(f"probe_chain: no kernel for device {x.device}")
    n = x.shape[0]
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, n) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"probe_chain: {name} must be a contiguous "
                             f"[{n}, {n}] fp32 tensor on {x.device}")
    if n > 128 or n % 4:
        raise ValueError(f"probe_chain: n={n} must be a multiple of 4 "
                         "and at most 128")
    grid = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = torch.empty_like(x)
    sink = torch.empty(grid, dtype=torch.float32, device=x.device)
    PROBE_CHAIN(x, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                sink.data_ptr(), n, steps, grid)
    return out


def probe_operands(size: int) -> tuple[np.ndarray, np.ndarray]:
    """(x, W) as the JAX probe makes them: W orthogonal (QR of a seeded
    normal matrix) so pure powers neither explode nor denormalize over
    thousands of steps."""
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((size, size)))
    x = rng.standard_normal((size, size))
    return x.astype(np.float32), q.astype(np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchProbe:
    """The probe runner: ``steps`` chained [size x size] fp32 products in
    one launch, operands device-resident. Calling it returns the wall
    seconds from launch to output-ready.

    Construction is lazy: the kernel is built and the operands placed on
    the first call. With ``steps=None`` the first call calibrates the
    chain length so one launch takes about ``TARGET_MS`` on the card as it
    is then (call it on an idle card, as the monitor does at startup).
    """

    def __init__(self, size: int = 128, steps: int | None = None,
                 device: str = "cuda"):
        self.size = size
        self.steps = steps
        self.device = torch.device(device)
        self._x = None
        self._w = None

    def _run(self, steps: int) -> float:
        t0 = time.perf_counter()
        probe_chain(self._x, self._w, steps)
        _sync(self.device)
        return time.perf_counter() - t0

    def _build(self) -> None:
        x, w = probe_operands(self.size)
        self._x = torch.from_numpy(x).to(self.device)
        self._w = torch.from_numpy(w).to(self.device)
        if self.steps is None:
            base = 16
            self._run(base)  # build + first launch are not signal
            per_step = min(self._run(base) for _ in range(3)) / base
            self.steps = max(base, int(TARGET_MS / 1e3 / per_step))
        # warm up: build and first dispatch are not probe signal
        self._run(self.steps)

    def __call__(self) -> float:
        if self._x is None:
            self._build()
        return self._run(self.steps)


class DutyProbe:
    """Rate-limited sampler over a probe runner.

    ``runner`` is any zero-arg callable returning elapsed seconds for one
    probe launch (``TorchProbe`` in production; scripted in tests).

    Lifecycle: :meth:`calibrate` once while the card is expected idle
    (monitor startup), then :meth:`maybe_sample` on every daemon pass —
    it self-limits to one launch per ``interval_s``. ``availability`` is
    an EMA of ``baseline / measured`` clamped to [0, 1]; 1.0 means the
    probe runs as fast as at calibration (card free), 0.25 means the
    probe saw a quarter of the card.
    """

    def __init__(self, runner=None, interval_s: float = 10.0,
                 alpha: float = DEFAULT_ALPHA, clock=time.monotonic):
        self._runner = runner if runner is not None else TorchProbe()
        self.interval_s = interval_s
        self.alpha = alpha
        self._clock = clock
        self.baseline_s: float | None = None
        self._ema: float | None = None
        self._last_s: float | None = None
        self._last_at: float | None = None
        self.samples = 0
        self.enabled = True

    def calibrate(self, n: int = 5) -> float:
        """Take ``n`` launches and keep the MINIMUM as the idle baseline
        — the least-contended sample is the truest idle time; mean or
        median would bake transient contention into every later ratio."""
        times = [self._runner() for _ in range(max(1, n))]
        self.baseline_s = min(times)
        if self.baseline_s <= 0:
            self.enabled = False
            raise ValueError("probe returned non-positive baseline")
        return self.baseline_s

    def sample(self) -> float:
        if self.baseline_s is None:
            self.calibrate()
        t = self._runner()
        self._last_s = t
        self._last_at = self._clock()
        if 0 < t < self.baseline_s:
            # faster than "idle": calibration happened while tenants were
            # busy (monitor restart under load). Ratchet TOWARD the faster
            # sample, bounded to 10% per step, so the contended baseline
            # can't inflate every later ratio — but one outlier-fast
            # sample (clock jitter, frequency scaling) can't become a
            # permanent floor that biases every later reading down either.
            self.baseline_s = max(t, 0.9 * self.baseline_s)
        avail = 1.0 if t <= 0 else min(1.0, self.baseline_s / t)
        self._ema = (avail if self._ema is None
                     else self.alpha * avail + (1 - self.alpha) * self._ema)
        self.samples += 1
        return avail

    def maybe_sample(self, now: float | None = None) -> bool:
        """One sample if the interval elapsed; True when it ran."""
        if not self.enabled:
            return False
        now = self._clock() if now is None else now
        if self._last_at is not None and now - self._last_at < self.interval_s:
            return False
        try:
            self.sample()
        except Exception:
            # a failed launch must not kill the monitor loop; disable
            # rather than retry-spin against a broken device
            log.exception("duty probe failed; disabling")
            self.enabled = False
            return False
        return True

    @property
    def availability(self) -> float | None:
        return self._ema

    @property
    def last_ms(self) -> float | None:
        return None if self._last_s is None else self._last_s * 1e3

    @property
    def baseline_ms(self) -> float | None:
        return None if self.baseline_s is None else self.baseline_s * 1e3

    def age_s(self) -> float | None:
        """Seconds since the last COMPLETED sample — the staleness signal
        when an in-flight launch wedges and samples silently stop."""
        return None if self._last_at is None else self._clock() - self._last_at

    def run_background(self, stop=None) -> "threading.Thread":
        """Calibrate + sample on a dedicated daemon thread.

        The probe must never sit on the monitor's critical path: a wedged
        device hangs the synchronize without raising, and a hang inside
        the daemon loop would stop cache scans and feedback for every
        tenant. On this thread a wedge only freezes the probe — scrapes
        then see ``age_s`` grow and ``availability`` go stale.
        """
        import threading

        def loop():
            try:
                base = self.calibrate()
                log.info("duty probe calibrated: %.2f ms idle", base * 1e3)
            except Exception as e:
                log.warning("duty probe unavailable: %s", e)
                self.enabled = False
                return
            while self.enabled and (stop is None or not stop.is_set()):
                self.maybe_sample()
                if stop is None:
                    time.sleep(min(1.0, self.interval_s))
                else:
                    stop.wait(min(1.0, self.interval_s))

        t = threading.Thread(target=loop, daemon=True, name="duty-probe")
        t.start()
        return t
