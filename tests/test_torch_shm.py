"""Cooperative limiter and shared region: the port against the JAX package.

The port keeps its own copies of ``shm/region.py`` and the limiter; these
tests hold the copies to the originals: the ctypes ABI field by field, the
env contract, the usage poll, and the duty-cycle token bucket step by step
on a region in a tmpdir under a scripted clock.
"""

import ctypes

import pytest

from k8s_device_plugin_torch import api as tapi
from k8s_device_plugin_torch.shm import limiter as tlimiter
from k8s_device_plugin_torch.shm import region as tregion
from k8s_device_plugin_tpu import api
from k8s_device_plugin_tpu.shm import limiter as jlimiter
from k8s_device_plugin_tpu.shm import region as jregion

STRUCTS = ["DeviceMemory", "ProcSlot", "SharedRegionV1", "SharedRegion"]


@pytest.mark.parametrize("name", STRUCTS)
def test_region_abi_matches_the_jax_mirror(name):
    ours, theirs = getattr(tregion, name), getattr(jregion, name)
    assert ctypes.sizeof(ours) == ctypes.sizeof(theirs)
    assert [f[0] for f in ours._fields_] == [f[0] for f in theirs._fields_]
    for field, _ in ours._fields_:
        a, b = getattr(ours, field), getattr(theirs, field)
        assert (a.offset, a.size) == (b.offset, b.size), field


def test_region_constants_and_layout_dump_match():
    for const in ("VTPU_SHM_MAGIC", "VTPU_SHM_VERSION", "MAX_DEVICES",
                  "MAX_PROCS", "MEM_KINDS", "KIND_BUFFER"):
        assert getattr(tregion, const) == getattr(jregion, const), const
    assert tregion.abi_layout() == jregion.abi_layout()


def test_env_contract_names_match():
    for const in ("TPU_DEVICE_MEMORY_LIMIT", "TPU_DEVICE_CORE_LIMIT",
                  "TPU_DEVICE_CACHE_PATH", "TPU_OVERSUBSCRIBE",
                  "TASK_PRIORITY", "TPU_DISABLE_CONTROL",
                  "TPU_DEVICE_HBM_BYTES", "TPU_CORE_UTILIZATION_POLICY",
                  "ACTIVE_OOM_KILLER"):
        assert getattr(tapi, const) == getattr(api, const), const


def test_a_region_written_by_the_port_reads_back_in_the_jax_mirror(tmp_path):
    path = str(tmp_path / "vtpu.cache")
    ours = tregion.Region(path)
    slot = ours.attach(4242)
    ours.data.procs[slot].used[0].total = 123 << 20
    ours.set_limits([1 << 30], core_percent=40)
    theirs = jregion.Region(path, create=False)
    try:
        assert theirs.device_used(0) == 123 << 20
        assert theirs.data.limit[0] == 1 << 30
        assert theirs.data.sm_limit[0] == 40
        assert [p.pid for p in theirs.active_procs()] == [4242]
    finally:
        theirs.close()
        ours.close()


def _contract(monkeypatch, cache, **extra):
    for var in ("VTPU_DISABLE_CONTROL", "VTPU_OVERSUBSCRIBE",
                "VTPU_TASK_PRIORITY", "VTPU_DEVICE_CORE_LIMIT",
                "VTPU_CORE_UTILIZATION_POLICY", "LD_PRELOAD",
                "TPU_LIBRARY_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", str(cache))
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_LIMIT_0", str(1 << 30))
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_LIMIT_1", str(2 << 30))
    for k, v in extra.items():
        monkeypatch.setenv(k, v)


def _installed(cls, monkeypatch, cache, **extra):
    _contract(monkeypatch, cache, **extra)
    lim = cls(poll_interval=3600)  # the poll thread never fires in a test
    assert lim.install()
    return lim


# views copy values out of the mapped region: a live ctypes view would keep
# the mmap exported and Region.close() would refuse to unmap it

def _contract_view(lim):
    d = lim.region.data
    return (d.num_devices, list(d.limit[:3]), list(d.sm_limit[:2]),
            d.priority, d.oversubscribe, lim.slot)


def _usage_view(lim):
    slot = lim.region.data.procs[lim.slot]
    return ([slot.used[d].total for d in (0, 1)],
            [slot.used[d].kinds[tregion.KIND_BUFFER] for d in (0, 1)],
            [slot.monitor_used[d] for d in (0, 1)])


def _bucket_view(lim):
    d = lim.region.data
    return d.duty_tokens_us[0], d.duty_refill_us[0], d.last_kernel_time


def test_install_parses_the_same_contract(monkeypatch, tmp_path):
    regions = []
    for i, cls in enumerate((jlimiter.CooperativeLimiter,
                             tlimiter.CooperativeLimiter)):
        lim = _installed(cls, monkeypatch, tmp_path / str(i),
                         VTPU_DEVICE_CORE_LIMIT="30",
                         VTPU_TASK_PRIORITY="1")
        regions.append(_contract_view(lim))
        lim.uninstall()
    assert regions[0] == regions[1]
    assert regions[1] == (2, [1 << 30, 2 << 30, 0], [30, 30], 1, 0, 0)


def test_kill_switch_and_missing_contract_disable_the_port(monkeypatch,
                                                          tmp_path):
    _contract(monkeypatch, tmp_path, VTPU_DISABLE_CONTROL="true")
    assert not tlimiter.CooperativeLimiter().install()
    monkeypatch.delenv("VTPU_DISABLE_CONTROL")
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE")
    assert not tlimiter.CooperativeLimiter().install()


@pytest.mark.parametrize("preload,observe", [
    ("", False),
    ("/usr/local/vtpu/libvtpu_cuda.so", True),
    ("/lib/libother.so:/usr/local/vtpu/libvtpu_cuda.so", True),
    ("/usr/local/vtpu/libvtpu_cuda.so.bak", False),
    ("/repo/build/kernels/libvtpu_cuda-0123456789abcdef.so", True),
    # HAMi-core's shim never writes this region: the poll owns used
    ("/usr/local/vgpu/libvgpu.so", False),
])
def test_poll_once_against_a_fake_stats_source(monkeypatch, tmp_path,
                                               preload, observe):
    stats = [(0, {"bytes_in_use": 512 << 20}),
             (1, {"bytes_in_use": 3 << 30})]
    results = []
    for i, cls in enumerate((jlimiter.CooperativeLimiter,
                             tlimiter.CooperativeLimiter)):
        lim = _installed(cls, monkeypatch, tmp_path / str(i))
        if cls is tlimiter.CooperativeLimiter:
            monkeypatch.setenv("LD_PRELOAD", preload)
            assert lim.observe_only is observe
        elif observe:
            # the JAX limiter's observe-only signal is its PJRT wrapper,
            # the port's its CUDA shim
            monkeypatch.setenv("TPU_LIBRARY_PATH", "/usr/local/vtpu/libvtpu.so")
        results.append((lim.poll_once(stats), _usage_view(lim)))
        lim.uninstall()
        monkeypatch.delenv("LD_PRELOAD", raising=False)
        monkeypatch.delenv("TPU_LIBRARY_PATH", raising=False)
    assert results[0] == results[1]
    assert results[1][0] == [1]  # only device 1 is over its 2 GiB cap


def test_poll_reports_nothing_before_cuda_is_initialised(monkeypatch,
                                                        tmp_path):
    lim = _installed(tlimiter.CooperativeLimiter, monkeypatch, tmp_path)
    try:
        assert lim._device_stats() == []
        assert lim.poll_once() == []
        assert lim.memory_fractions == {}  # no CUDA device: nothing bound
    finally:
        lim.uninstall()


class _Clock:
    """Deterministic stand-in for the ``time`` module inside a limiter."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return self.now

    def sleep(self, s):
        self.now += s


# costs stay within the bucket's 200 ms capacity: a larger one can never
# be granted and would wait forever, in both limiters alike
@pytest.mark.parametrize("core,costs", [
    ("25", [150000, 1000, 120000, 60000, 200000, 5000]),
    ("60", [1000] * 5 + [190000, 90000]),
    ("100", [500000, 1]),
])
def test_throttle_bucket_matches_the_jax_limiter(monkeypatch, tmp_path, core,
                                                 costs):
    traces = []
    for i, (mod, cls) in enumerate(
            ((jlimiter, jlimiter.CooperativeLimiter),
             (tlimiter, tlimiter.CooperativeLimiter))):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        lim = _installed(cls, monkeypatch, tmp_path / str(i),
                         VTPU_DEVICE_CORE_LIMIT=core)
        trace = []
        for cost in costs:
            trace.append((lim.throttle(cost), _bucket_view(lim)))
            clock.now += 0.01  # the dispatch itself
        lim.uninstall()
        traces.append(trace)
    assert traces[0] == traces[1]
    if core != "100":
        assert any(t[0] > 0 for t in traces[1])  # the bucket did throttle


def test_utilization_policy_disable_frees_the_duty_cycle(monkeypatch,
                                                        tmp_path):
    lim = _installed(tlimiter.CooperativeLimiter, monkeypatch, tmp_path,
                     VTPU_DEVICE_CORE_LIMIT="10",
                     VTPU_CORE_UTILIZATION_POLICY="disable")
    try:
        assert lim.throttle(10 ** 9) == 0.0
    finally:
        lim.uninstall()
