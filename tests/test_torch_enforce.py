"""The port's enforcement shim (``libvtpu_cuda.so``) on the CPU.

Counterpart of ``tests/test_pjrt_wrap.py`` for the CUDA driver API: the
shim (``k8s_device_plugin_torch/csrc/vtpu_cuda_preload.c``) and the mock
driver (``csrc/mock_cuda.c``) are built with cc into a temp dir, and each
scenario runs in a subprocess with the shim in ``LD_PRELOAD``, the mock as
``VTPU_REAL_CUDA_LIBRARY`` and the ``VTPU_*`` contract set, driving the
driver API through ``tests/cuda_ctypes.py`` the way a CUDA runtime does:
OOM at allocation time for every allocation entry point, release
accounting, the context's footprint, the duty-cycle bucket on every launch
entry point, the measured-cost EMA, the monitor's priority block, the
clamped memory info, oversubscription, a slice shared across processes,
fail-open, and interception by a direct call, by ``dlsym`` on the driver's
handle and by ``cuGetProcAddress_v2``.

The port is also held against the reference: one seeded trace of
allocations, frees and launches goes through ``libvtpu.so`` over
``libtpu_mock.so`` (built from ``lib/tpu``, driven with
``tests/pjrt_ctypes.py``) and through the port's shim over the mock
driver, and both must refuse the same allocations, end with the same
usage and spill, and wait on the bucket as often. The region both write
is held to ``lib/tpu/vtpu_shm.h``'s layout.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.shm import region as tregion
from k8s_device_plugin_torch.shm.region import Region

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
LIB_TPU = os.path.join(REPO, "lib", "tpu")
MB = 1 << 20


def _cc(out: str, *args: str) -> None:
    subprocess.run(["cc", *args, "-o", out], check=True, capture_output=True)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The shim and the mock driver, built with cc from the port's
    sources into a temp dir."""
    out = tmp_path_factory.mktemp("enforce")
    paths = {}
    for name in ("vtpu_cuda", "cuda_mock"):
        paths[name] = str(out / f"lib{name}.so")
        _cc(paths[name], *_build.CC_FLAGS,
            *(os.path.join(_build.CSRC_DIR, f)
              for f in _build.HOST_LIBRARIES[name]), *_build.CC_LIBS)
    return paths


def _env(libs, cache, limit, extra=None, preload=True):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("VTPU_") and k != "LD_PRELOAD"}
    env.update({"VTPU_DEVICE_MEMORY_SHARED_CACHE": str(cache),
                "VTPU_DEVICE_MEMORY_LIMIT_0": str(limit),
                "VTPU_DEVICE_CORE_LIMIT": "100",
                "VTPU_REAL_CUDA_LIBRARY": libs["cuda_mock"],
                "PYTHONPATH": REPO})
    if preload:
        env["LD_PRELOAD"] = libs["vtpu_cuda"]
    env.update(extra or {})
    return env


def run_wrapped(libs, cache, body, limit=512 * MB, extra_env=None,
                route="dlsym", flags=0, preload=True):
    """Run ``body`` (Python with ``cu``, a :class:`cuda_ctypes.Cuda` whose
    device 0 has its primary context current, ``cc`` and ``region()``) in
    a subprocess under the shim."""
    os.makedirs(cache, exist_ok=True)
    script = f"""
import os, sys, time
sys.path.insert(0, {TESTS!r})
import cuda_ctypes as cc
from k8s_device_plugin_torch.shm.region import Region
MB = 1 << 20
cu = cc.Cuda(os.environ["VTPU_REAL_CUDA_LIBRARY"], route={route!r},
             flags={flags})
cu.init()

def region():
    return Region(os.path.join({str(cache)!r}, "vtpu.cache"), create=False)

{textwrap.dedent(body)}
"""
    return subprocess.run([sys.executable, "-c", script],
                          env=_env(libs, cache, limit, extra_env, preload),
                          capture_output=True, text=True, timeout=120)


def _ok(res, marker):
    assert marker in res.stdout, res.stdout + res.stderr


# ---------------------------------------------------------------- memory

@pytest.mark.parametrize("how", ["alloc", "pitch", "async", "pool",
                                 "create"])
def test_hbm_oom_at_alloc(libs, tmp_path, how):
    """Allocate until OOM through each allocation entry point: the
    over-cap request fails AT ALLOCATION TIME with
    CUDA_ERROR_OUT_OF_MEMORY, nothing of it is charged, and freeing makes
    room again."""
    body = f"""
    held = []
    for _ in range(3):
        rc, h = cu.alloc(100 * MB, {how!r})
        assert rc == cc.CUDA_SUCCESS, rc
        held.append(h)
    rc, _ = cu.alloc(300 * MB, {how!r})
    assert rc == cc.CUDA_ERROR_OUT_OF_MEMORY, rc
    r = region()
    assert r.device_used(0) == 300 * MB, r.device_used(0)
    assert cu.counters()[3] == 300 * MB  # the driver never saw it
    assert cu.free(held[0], {how!r}) == cc.CUDA_SUCCESS
    rc, _ = cu.alloc(300 * MB, {how!r})
    assert rc == cc.CUDA_SUCCESS, rc
    assert r.device_used(0) == 500 * MB, r.device_used(0)
    r.close()
    print("OOM_OK")
    """
    res = run_wrapped(libs, tmp_path / "cache", body)
    _ok(res, "OOM_OK")
    assert "HBM limit exceeded on device 0" in res.stderr
    r = Region(str(tmp_path / "cache" / "vtpu.cache"), create=False)
    try:
        assert r.data.limit[0] == 512 * MB
        assert r.active_procs() == []  # the shim detached at exit
    finally:
        r.close()


def test_release_accounting(libs, tmp_path):
    """Every release entry point returns exactly what its allocation
    charged (the pitch allocation's padded bytes too), and a release the
    driver refuses leaves the charge in place."""
    body = """
    r = region()
    for how in ("alloc", "pitch", "async", "pool", "create"):
        rc, h = cu.alloc(3 * MB + 100, how)
        assert rc == cc.CUDA_SUCCESS, (how, rc)
        held = r.device_used(0)
        assert held >= 3 * MB + 100, (how, held)
        assert cu.free(h, how) == cc.CUDA_SUCCESS, how
        assert r.device_used(0) == 0, (how, r.device_used(0))
    rc, h = cu.alloc(8 * MB)
    assert cu.free(h + 1) != cc.CUDA_SUCCESS  # not an allocation
    assert r.device_used(0) == 8 * MB
    assert cu.free(h) == cc.CUDA_SUCCESS and r.device_used(0) == 0
    r.close()
    print("RELEASE_OK")
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body), "RELEASE_OK")


def test_usage_visible_to_monitor_while_running(libs, tmp_path):
    """The shim publishes per-kind usage into the region the monitor
    mmaps, in a slot of this process."""
    body = """
    from k8s_device_plugin_torch.shm.region import KIND_BUFFER
    rc, _ = cu.alloc(128 * MB)
    assert rc == cc.CUDA_SUCCESS
    r = region()
    assert r.device_used(0) == 128 * MB, r.device_used(0)
    procs = r.active_procs()
    assert len(procs) == 1 and procs[0].pid == os.getpid()
    assert procs[0].used[0].kinds[KIND_BUFFER] == 128 * MB
    del procs
    r.close()
    print("MONITOR_OK")
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body), "MONITOR_OK")


@pytest.mark.parametrize("case", ["kill_switch", "no_cache"])
def test_fail_open(libs, tmp_path, case):
    """The kill switch, or no cache path: the shim accounts and refuses
    nothing, and dlsym hands out the driver's own entry points."""
    body = """
    import ctypes
    rc, _ = cu.alloc(1 << 30)  # 1 GiB > the 512 MiB cap
    assert rc == cc.CUDA_SUCCESS, rc
    assert cu.mem_info()[1] == 80 << 30  # the whole (mock) card
    shim = ctypes.CDLL(os.environ["LD_PRELOAD"])
    assert cu.address("cuMemAlloc_v2") != ctypes.cast(
        shim.cuMemAlloc_v2, ctypes.c_void_p).value
    print("FAIL_OPEN_OK")
    """
    cache = tmp_path / "cache"
    if case == "kill_switch":
        res = run_wrapped(libs, cache, body,
                          extra_env={"VTPU_DISABLE_CONTROL": "true"})
    else:
        res = _run_without_cache(libs, cache, body)
    _ok(res, "FAIL_OPEN_OK")
    assert not os.path.exists(cache / "vtpu.cache")


def _run_without_cache(libs, cache, body):
    """run_wrapped with no VTPU_DEVICE_MEMORY_SHARED_CACHE at all."""
    os.makedirs(cache, exist_ok=True)
    env = _env(libs, cache, 512 * MB)
    del env["VTPU_DEVICE_MEMORY_SHARED_CACHE"]
    script = f"""
import os, sys
sys.path.insert(0, {TESTS!r})
import cuda_ctypes as cc
cu = cc.Cuda(os.environ["VTPU_REAL_CUDA_LIBRARY"])
cu.init()
{textwrap.dedent(body)}
"""
    return subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)


def test_context_accounting(libs, tmp_path):
    """A primary context's footprint (the drop in free bytes around its
    creation) lands in the context kind, once; releasing the last retain
    releases it, and a new context charges it again."""
    body = """
    from k8s_device_plugin_torch.shm.region import KIND_CONTEXT

    def ctx_bytes():
        r = region()
        v = r.active_procs()[0].used[0].kinds[KIND_CONTEXT]
        r.close()
        return v

    assert ctx_bytes() == 32 * MB, ctx_bytes()
    ctx = cc.c_void_p()
    assert cu.fn("cuDevicePrimaryCtxRetain")(cc.ctypes.byref(ctx), 0) == 0
    assert ctx_bytes() == 32 * MB, ctx_bytes()  # a second retain: no charge
    assert cu.release() == 0 and ctx_bytes() == 32 * MB
    assert cu.release() == 0 and ctx_bytes() == 0, ctx_bytes()
    cu.init()
    assert ctx_bytes() == 32 * MB, ctx_bytes()
    print("CONTEXT_OK")
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body,
                    extra_env={"VTPU_MOCK_CUDA_CTX_BYTES": str(32 * MB)}),
        "CONTEXT_OK")


def test_memory_info_clamped_to_slice(libs, tmp_path):
    """cuMemGetInfo (torch.cuda.mem_get_info) inside the container sees
    the slice: total is the cap and free the cap less the slice's usage,
    floored at 0 under oversubscription."""
    body = """
    rc, _ = cu.alloc(64 * MB)
    assert rc == cc.CUDA_SUCCESS
    assert cu.mem_info() == (448 * MB, 512 * MB), cu.mem_info()
    print("STATS_OK")
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body), "STATS_OK")
    body = """
    for _ in range(3):
        assert cu.alloc(256 * MB)[0] == cc.CUDA_SUCCESS
    assert cu.mem_info() == (0, 512 * MB), cu.mem_info()
    print("FLOOR_OK")
    """
    _ok(run_wrapped(libs, tmp_path / "cache2", body,
                    extra_env={"VTPU_OVERSUBSCRIBE": "true"}), "FLOOR_OK")


def test_oversubscription_spill_visible(libs, tmp_path):
    """VTPU_OVERSUBSCRIBE admits allocations past the cap, and the region
    the monitor reads shows the spill (used less the cap)."""
    body = """
    for _ in range(3):
        rc, _ = cu.alloc(256 * MB)
        assert rc == cc.CUDA_SUCCESS, "oversubscribe must admit past the cap"
    r = region()
    assert r.data.oversubscribe == 1
    print("SPILL", r.device_used(0) - r.data.limit[0])
    r.close()
    """
    res = run_wrapped(libs, tmp_path / "cache", body,
                      extra_env={"VTPU_OVERSUBSCRIBE": "true"})
    assert f"SPILL {256 * MB}" in res.stdout, res.stdout + res.stderr


def test_cross_process_shared_slice_enforced(libs, tmp_path):
    """Two processes of one container share one 4 GiB slice: the second
    one's 3 GiB would fit an empty slice, but not beside the first's."""
    cache = tmp_path / "cache"
    ready, release = tmp_path / "ready", tmp_path / "release"
    holder = f"""
    assert cu.alloc(3 << 30)[0] == cc.CUDA_SUCCESS
    open({str(ready)!r}, "w").write("1")
    deadline = time.time() + 60
    while not os.path.exists({str(release)!r}) and time.time() < deadline:
        time.sleep(0.02)
    print("HOLDER_DONE")
    """
    os.makedirs(cache)
    script = f"""
import os, sys, time
sys.path.insert(0, {TESTS!r})
import cuda_ctypes as cc
cu = cc.Cuda(os.environ["VTPU_REAL_CUDA_LIBRARY"])
cu.init()
{textwrap.dedent(holder)}
"""
    proc = subprocess.Popen([sys.executable, "-c", script],
                            env=_env(libs, cache, 4 << 30),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        for _ in range(3000):
            if ready.exists() or proc.poll() is not None:
                break
            time.sleep(0.02)
        assert ready.exists(), proc.communicate(timeout=10)
        body = """
        rc, _ = cu.alloc(3 << 30)
        assert rc == cc.CUDA_ERROR_OUT_OF_MEMORY, rc
        assert cu.alloc(512 * MB)[0] == cc.CUDA_SUCCESS
        r = region()
        assert len(r.active_procs()) == 2
        r.close()
        print("CONTENDER_OK")
        """
        _ok(run_wrapped(libs, cache, body, limit=4 << 30), "CONTENDER_OK")
    finally:
        release.write_text("1")
        out, err = proc.communicate(timeout=60)
    assert "HOLDER_DONE" in out, err


def test_active_oom_killer(libs, tmp_path):
    body = """
    cu.alloc(1 << 30)
    print("SHOULD_NOT_REACH")
    """
    res = run_wrapped(libs, tmp_path / "cache", body,
                      extra_env={"VTPU_ACTIVE_OOM_KILLER": "true"})
    assert res.returncode == 137, res.stderr
    assert "SHOULD_NOT_REACH" not in res.stdout


def test_thread_safety(libs, tmp_path):
    """Concurrent allocations and frees from 8 threads (ctypes releases
    the GIL, so the C paths really race): usage ends at 0."""
    body = """
    import threading
    errors = []

    def worker(tid):
        try:
            cu.make_current()
            for i in range(200):
                how = ("alloc", "async", "create")[(tid + i) % 3]
                rc, h = cu.alloc(256 * 1024, how)
                assert rc == cc.CUDA_SUCCESS, rc
                assert cu.free(h, how) == cc.CUDA_SUCCESS
        except Exception as e:
            errors.append((tid, repr(e)))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    r = region()
    assert r.device_used(0) == 0, r.device_used(0)
    r.close()
    assert cu.counters()[4] == 0  # the driver holds nothing either
    print("THREADS_OK")
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body), "THREADS_OK")


# ------------------------------------------------------------ duty cycle

@pytest.mark.parametrize("how", ["kernel", "ex", "cooperative", "graph"])
def test_duty_cycle_throttle(libs, tmp_path, how):
    """sm_limit 20% at a pinned 40 ms a launch, through each launch entry
    point: the 200 ms burst covers 5 launches, and the 6th waits about
    200 ms of wall clock."""
    body = f"""
    for _ in range(5):
        assert cu.launch(how={how!r}) == cc.CUDA_SUCCESS
    t0 = time.time()
    assert cu.launch(how={how!r}) == cc.CUDA_SUCCESS
    dt = time.time() - t0
    assert dt >= 0.15, dt
    print("THROTTLE_OK", dt)
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body,
                    extra_env={"VTPU_DEVICE_CORE_LIMIT": "20",
                               "VTPU_EXEC_COST_US": "40000"}),
        "THROTTLE_OK")


def test_core_policy_disable_frees_duty_cycle(libs, tmp_path):
    """VTPU_CORE_UTILIZATION_POLICY=disable: memory still capped, no
    throttle."""
    body = """
    t0 = time.time()
    for _ in range(10):
        cu.launch()
    assert time.time() - t0 < 0.5
    rc, _ = cu.alloc(1 << 30)
    assert rc == cc.CUDA_ERROR_OUT_OF_MEMORY, rc
    print("POLICY_OK")
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body,
                    extra_env={"VTPU_CORE_UTILIZATION_POLICY": "disable",
                               "VTPU_DEVICE_CORE_LIMIT": "20",
                               "VTPU_EXEC_COST_US": "40000"}), "POLICY_OK")


def test_measured_exec_cost_ema(libs, tmp_path):
    """With no VTPU_EXEC_COST_US, each CUfunction drains the bucket by the
    EMA of its own timed device time (event pairs read at a later
    launch): a kernel of 10 blocks at 5 ms a block pays about 10 times
    one of 1 block."""
    body = """
    light, heavy = 0x1000, 0x2000
    for _ in range(2):  # time each once, then settle the EMA
        cu.launch(light, grid=1)
        cu.launch(heavy, grid=10)
    r = region()
    cap = 200000

    def drained(func, grid):
        time.sleep(0.25)  # the bucket refills to its cap
        cu.launch(func, grid=grid)
        return cap - r.data.duty_tokens_us[0]

    dl, dh = drained(light, 1), drained(heavy, 10)
    r.close()
    assert dl >= 4000, dl  # measured, not the 2000 us bootstrap
    assert dh >= 40000, dh
    assert 5 <= dh / dl <= 30, (dl, dh)
    print("EMA_OK", dl, dh)
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body,
                    extra_env={"VTPU_DEVICE_CORE_LIMIT": "99",
                               "VTPU_MOCK_CUDA_LAUNCH_US": "5000"}),
        "EMA_OK")


@pytest.mark.parametrize("core", ["", "50"])
def test_priority_block(libs, tmp_path, core):
    """The monitor's hard block (recent_kernel=-1 and
    utilization_switch=1) freezes launches until it is lifted, on an
    uncapped container as on a capped one."""
    body = """
    import threading
    cu.launch()
    r = region()
    with r.locked():
        r.data.recent_kernel = -1
        r.data.utilization_switch = 1

    def unblock():
        time.sleep(0.4)
        with r.locked():
            r.data.recent_kernel = 1

    t = threading.Thread(target=unblock)
    t.start()
    t0 = time.time()
    for _ in range(20):  # a capped shim charges in batches of 1 ms
        cu.launch()
    dt = time.time() - t0
    t.join()
    r.close()
    assert dt >= 0.3, dt
    print("BLOCK_OK", dt)
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body,
                    extra_env={"VTPU_DEVICE_CORE_LIMIT": core,
                               "VTPU_EXEC_COST_US": "100"}), "BLOCK_OK")


# ---------------------------------------------------------- interception

DIRECT = r"""
#include "cuda_driver_abi.h"
#include <stdio.h>
int main(void) {
    CUcontext ctx;
    CUdeviceptr p;
    if (cuInit(0) || cuDevicePrimaryCtxRetain(&ctx, 0) ||
        cuCtxSetCurrent(ctx)) {
        return 1;
    }
    printf("RC %d\n", (int)cuMemAlloc_v2(&p, 600u << 20));
    return 0;
}
"""


@pytest.mark.parametrize("route", ["direct", "dlsym", "proc", "proc_ptsz"])
def test_interception_routes(libs, tmp_path, route):
    """The shim catches a call by each route a client reaches the driver
    by: a direct call of a program linked against the driver, dlsym on
    the driver's handle, and cuGetProcAddress_v2 (matching the version
    and, for a stream-ordered call, the per-thread stream flag). Names it
    does not hook resolve to the driver's own entry points."""
    cache = tmp_path / "cache"
    if route == "direct":
        src = tmp_path / "direct.c"
        src.write_text(DIRECT)
        prog = str(tmp_path / "direct")
        _cc(prog, "-I", _build.CSRC_DIR, str(src), libs["cuda_mock"],
            f"-Wl,-rpath,{os.path.dirname(libs['cuda_mock'])}")
        os.makedirs(cache)
        for preload, want in ((True, 2), (False, 0)):
            res = subprocess.run([prog], capture_output=True, text=True,
                                 env=_env(libs, cache, 512 * MB,
                                          preload=preload), timeout=60)
            assert f"RC {want}" in res.stdout, (preload, res.stdout,
                                                res.stderr)
        return
    flags = 2 if route == "proc_ptsz" else 0
    body = """
    import ctypes
    shim = ctypes.CDLL(os.environ["LD_PRELOAD"])
    ours = lambda name: ctypes.cast(getattr(shim, name), ctypes.c_void_p).value
    suffix = "_ptsz" if cu.flags else ""
    assert cu.address("cuMemAlloc_v2") == ours("cuMemAlloc_v2")
    assert cu.address("cuLaunchKernel") == ours("cuLaunchKernel" + suffix)
    assert cu.alloc(600 * MB)[0] == cc.CUDA_ERROR_OUT_OF_MEMORY
    assert cu.launch() == cc.CUDA_SUCCESS
    assert cu.counters()[:2] == ([0, 1] if cu.flags else [1, 0])
    if cu.route == "proc":
        fn = cu.fn("cuGetProcAddress_v2")
        pfn, st = ctypes.c_void_p(), ctypes.c_int()
        # an unhooked name: the driver's own entry point
        assert fn(b"cuCtxGetDevice", ctypes.byref(pfn), 12080, 0,
                  ctypes.byref(st)) == 0
        assert pfn.value == ctypes.cast(cu.lib.cuCtxGetDevice,
                                        ctypes.c_void_p).value
        # the 32-bit cuMemAlloc of CUDA < 3.2: not this hook's ABI
        assert fn(b"cuMemAlloc", ctypes.byref(pfn), 3010, 0,
                  ctypes.byref(st)) != 0 and not pfn.value
    print("ROUTE_OK")
    """
    _ok(run_wrapped(libs, cache, body, route=route[:5], flags=flags),
        "ROUTE_OK")


# -------------------------------------------- parity with libvtpu.so

@pytest.fixture(scope="module")
def native(tmp_path_factory):
    out = tmp_path_factory.mktemp("native")
    subprocess.run(["make", "-C", LIB_TPU, f"OUT={out}",
                    f"{out}/libvtpu.so", f"{out}/libtpu_mock.so"],
                   check=True, capture_output=True)
    return str(out)


def _trace(seed: int = 0, ops: int = 60) -> list:
    """A seeded trace: ("alloc", MiB), ("free", k-th live allocation)
    and ("launch",)."""
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(ops):
        u = rng.random()
        if u < 0.5:
            trace.append(("alloc", int(rng.integers(1, 64))))
        elif u < 0.75:
            trace.append(("free", int(rng.integers(0, 1 << 16))))
        else:
            trace.append(("launch",))
    return trace


#: the trace's runner, on either side: alloc(MiB) -> (failed, handle),
#: free(handle), launch(); prints the refusal indices, the final usage and
#: the launches that waited on the bucket (over 10 ms: a wait is ~40 ms)
_REPLAY = """
refused, live, waited = [], [], 0
for i, op in enumerate(TRACE):
    if op[0] == "alloc":
        failed, h = alloc(op[1] * MB)
        if failed:
            refused.append(i)
        else:
            live.append(h)
    elif op[0] == "free" and live:
        free(live.pop(op[1] % len(live)))
    elif op[0] == "launch":
        t0 = time.perf_counter()
        launch()
        waited += time.perf_counter() - t0 > 0.010
r = Region(os.path.join(CACHE, "vtpu.cache"), create=False)
used = r.device_used(0)
r.close()
print("RESULT", json.dumps({"refused": refused, "used": used,
                            "spill": max(0, used - CAP), "waits": waited}))
"""


def _replay(cmd_env, prelude, trace, cache, cap):
    script = (f"import json, os, sys, time\nMB = 1 << 20\n"
              f"TRACE = {trace!r}\nCACHE = {str(cache)!r}\nCAP = {cap}\n"
              f"sys.path.insert(0, {TESTS!r})\n"
              "from k8s_device_plugin_torch.shm.region import Region\n"
              + textwrap.dedent(prelude) + _REPLAY)
    os.makedirs(cache)
    res = subprocess.run([sys.executable, "-c", script], env=cmd_env,
                         capture_output=True, text=True, timeout=120)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")]
    assert line, res.stdout + res.stderr
    return json.loads(line[0][len("RESULT "):])


@pytest.mark.parametrize("oversubscribe", [False, True])
def test_trace_parity_with_libvtpu(libs, native, tmp_path, oversubscribe):
    """One seeded trace through libvtpu.so over libtpu_mock.so and through
    the port's shim over the mock driver, under a 256 MiB cap, a 50% core
    limit and a pinned 20 ms a launch: the same refusal indices, the same
    final usage and spill, the same number of bucket waits. Exact."""
    cap = 256 * MB
    trace = _trace()
    contract = {"VTPU_DEVICE_CORE_LIMIT": "50", "VTPU_EXEC_COST_US": "20000"}
    if oversubscribe:
        contract["VTPU_OVERSUBSCRIBE"] = "1"

    jax_env = _env(libs, tmp_path / "jax", cap, contract, preload=False)
    jax_env.update({"VTPU_REAL_TPU_LIBRARY":
                    os.path.join(native, "libtpu_mock.so"),
                    "VTPU_MOCK_PJRT_DEVS": "1", "VTPU_MOCK_OUT_BYTES": "0"})
    jax = _replay(jax_env, f"""
        import pjrt_ctypes as pc
        api = pc.PjrtApi({os.path.join(native, 'libvtpu.so')!r})
        client = api.client_create()
        # the program the launches run holds 1 byte (module kind); the
        # port's side holds a 1-byte allocation in its place
        err, exe = api.compile(client, code=b"x")
        assert not err

        def alloc(n):
            err, buf = api.buffer_from_host(client, [n // 4])
            if err:
                assert api.error_code(err) == \\
                    pc.PJRT_Error_Code_RESOURCE_EXHAUSTED
                api.error_destroy(err)
            return bool(err), buf

        def free(buf):
            api.buffer_destroy(buf)

        def launch():
            err, outs = api.execute(exe)
            assert not err
        """, trace, tmp_path / "jax", cap)

    port = _replay(_env(libs, tmp_path / "port", cap, contract), """
        import cuda_ctypes as cc
        cu = cc.Cuda(os.environ["VTPU_REAL_CUDA_LIBRARY"])
        cu.init()
        assert cu.alloc(1)[0] == cc.CUDA_SUCCESS

        def alloc(n):
            rc, h = cu.alloc(n)
            assert rc in (cc.CUDA_SUCCESS, cc.CUDA_ERROR_OUT_OF_MEMORY)
            return rc != cc.CUDA_SUCCESS, h

        def free(h):
            assert cu.free(h) == cc.CUDA_SUCCESS

        def launch():
            assert cu.launch() == cc.CUDA_SUCCESS
        """, trace, tmp_path / "port", cap)
    assert port == jax
    # the trace exercises what it compares
    assert port["waits"] >= 3
    if oversubscribe:
        assert port["refused"] == [] and port["spill"] > 0
    else:
        assert len(port["refused"]) >= 3 and port["spill"] == 0


# --------------------------------------------------------- region layout

def _abi_dump(tmp_path, include_dir: str, name: str) -> dict:
    """``lib/tpu/vtpu_abi_dump.c`` compiled against the ``vtpu_shm.h`` in
    ``include_dir``; {field: (offset, size)}."""
    src = tmp_path / f"{name}.c"
    with open(os.path.join(LIB_TPU, "vtpu_abi_dump.c")) as f:
        src.write_text(f.read())  # away from lib/tpu's own header
    prog = str(tmp_path / name)
    _cc(prog, "-I", include_dir, str(src))
    out = subprocess.run([prog], capture_output=True, text=True,
                         check=True).stdout
    layout = {}
    for line in out.splitlines():
        field, *nums = line.split()
        layout[field] = (int(nums[0]), int(nums[1]) if len(nums) > 1 else 0)
    return layout


def test_region_layout_matches_lib_tpu(tmp_path):
    """The port's copy of the region header lays the region out as
    lib/tpu/vtpu_shm.h does, field by field, and so does the port's
    Python mirror: the monitor reads a region the port's shim wrote as
    one libvtpu.so wrote."""
    ours = _abi_dump(tmp_path, _build.CSRC_DIR, "port_dump")
    theirs = _abi_dump(tmp_path, LIB_TPU, "jax_dump")
    assert ours == theirs
    assert len(ours) == 18
    assert tregion.abi_layout() == ours


def test_the_abi_check_catches_a_drifted_header(tmp_path):
    """csrc/cuda_abi_check.c turns every declaration of
    cuda_driver_abi.h into a static assertion against cuda.h. Without the
    toolkit here, it is compiled against a cuda.h made of the header
    itself (it must hold), and against one with an enum value, a struct
    field and a prototype each changed (each must fail)."""
    with open(os.path.join(_build.CSRC_DIR, "cuda_driver_abi.h")) as f:
        header = f.read().replace("VTPU_CUDA_DRIVER_ABI_H", "FAKE_CUDA_H")
    fake = tmp_path / "inc"
    fake.mkdir()

    def check(text):
        (fake / "cuda.h").write_text(text)
        return subprocess.run(
            ["cc", "-std=gnu11", "-fsyntax-only", "-w", "-I", str(fake),
             "-I", _build.CSRC_DIR,
             os.path.join(_build.CSRC_DIR, "cuda_abi_check.c")],
            capture_output=True, text=True)

    assert check(header).returncode == 0, check(header).stderr
    for old, new in (
            ("X(CUDA_ERROR_OUT_OF_MEMORY, 2)",
             "X(CUDA_ERROR_OUT_OF_MEMORY, 3)"),
            ("F(CUlaunchConfig, CUstream, hStream, )",
             "F(CUlaunchConfig, unsigned int, hStream, )"),
            ("X(cuMemFree_v2, (CUdeviceptr dptr))",
             "X(cuMemFree_v2, (CUdeviceptr dptr, int extra))")):
        assert old in header
        res = check(header.replace(old, new))
        assert "static assertion failed" in res.stderr, (old, res.stderr)


def test_the_port_loads_no_library_from_lib_tpu(tmp_path):
    """The region's native lock comes from the port's own build of
    csrc/vtpu_shm.c; no library of lib/tpu is mapped into the process."""
    script = """
import os
from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.shm import region
r = region.Region(os.path.join(os.environ["CACHE"], "vtpu.cache"))
r.attach(os.getpid())
lib = region._native_shm()
assert lib is not None and lib._name == _build.host_library("vtpu_shm"), lib
maps = open("/proc/self/maps").read()
assert "/lib/tpu/" not in maps
r.close()
print("OWN_LIB_OK")
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    env.update({"CACHE": str(tmp_path), "PYTHONPATH": REPO})
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    _ok(res, "OWN_LIB_OK")


def test_the_limiter_observes_only_under_the_shim(libs, tmp_path):
    """With the port's shim in LD_PRELOAD, the cooperative limiter's poll
    writes what it sees into monitor_used and leaves the shim's used
    alone."""
    body = """
    from k8s_device_plugin_torch.shm.limiter import CooperativeLimiter
    assert cu.alloc(100 * MB)[0] == cc.CUDA_SUCCESS
    lim = CooperativeLimiter(poll_interval=3600)
    assert lim.install() and lim.observe_only
    lim.poll_once(stats=[(0, {"bytes_in_use": 7 * MB})])
    slot = lim.region.data.procs[lim.slot]
    seen = (slot.used[0].total, slot.monitor_used[0])
    del slot
    lim.uninstall()
    assert seen == (100 * MB, 7 * MB), seen
    print("OBSERVE_OK")
    """
    _ok(run_wrapped(libs, tmp_path / "cache", body), "OBSERVE_OK")


# ------------------------------------------------------------- the bench

def test_the_bench_wraps_the_share_and_never_the_native_run(libs,
                                                            monkeypatch):
    """A wrapped share child runs with the shim first in LD_PRELOAD; the
    native child never does, whatever it inherited. The mode defaults to
    wrapped on a card and plain on the CPU."""
    from k8s_device_plugin_torch import bench
    monkeypatch.setenv("LD_PRELOAD", f"/x/libother.so {libs['vtpu_cuda']}")
    wrapped = bench._child_env({"VTPU_DEVICE_MEMORY_LIMIT_0": "1"},
                               "/usr/local/vtpu/libvtpu_cuda.so")
    assert wrapped["LD_PRELOAD"] == \
        "/usr/local/vtpu/libvtpu_cuda.so /x/libother.so"
    assert wrapped["VTPU_DEVICE_MEMORY_LIMIT_0"] == "1"
    assert bench._child_env({})["LD_PRELOAD"] == "/x/libother.so"
    assert bench.parse_args([]).child_mode == "wrapped"
    assert bench.parse_args(["--device", "cpu"]).child_mode == "plain"
    assert bench._child_cmd("share", bench.parse_args([]))[4:7] == [
        "share", "--child-mode", "wrapped"]


def test_a_wrapped_child_that_the_shim_does_not_hold_fails_the_run(
        tmp_path, monkeypatch):
    """No fallback: a wrapped share child that cannot show the shim live
    (here no CUDA device at all) fails the run instead of measuring
    unenforced."""
    from k8s_device_plugin_torch import bench
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = bench.parse_args(["--device", "cpu", "--child-mode", "wrapped",
                             "--batch", "1", "--image-size", "32",
                             "--iters", "1", "--share-procs", "1"])
    with pytest.raises(RuntimeError, match="the shim enforces on a CUDA"):
        bench.run_share(args, 1 << 30, str(tmp_path))
