"""The enforcement shim's own counters and bucket-wait spans on the CPU.

The shim (``libvtpu_cuda.so``) counts, per ordinal and in its own process
only, the launches through its hooks, the cost it charged the duty bucket
and the cost the bucket granted, the bucket's waits and their sleep, its
own time in the hooks and the driver's launch time, and the event-timed
launches that fed its cost estimate; and it records one span a wait on
``CLOCK_REALTIME``. ``k8s_device_plugin_torch/shm/counters.py`` reads
both. Each scenario runs in a subprocess under the shim over the mock
driver (``tests/test_torch_enforce.py``'s ``libs`` and ``run_wrapped``),
by the routes a client reaches the driver by. The port's
``vtpu_rate_limit`` now returns the time it slept, held here against the
wall clock.
"""

import ctypes
import json
import os
import subprocess
import textwrap
import threading
import time

import numpy as np
import pytest

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.shm import counters
from k8s_device_plugin_torch.shm.region import Region
from test_torch_enforce import _cc, _env, libs, run_wrapped  # noqa: F401

#: the shim's batch of bucket charges (CHARGE_BATCH_US)
CHARGE_BATCH_US = 1000
#: a pinned cost a launch and a core limit at which the bucket's 200 ms
#: burst covers 10 launches and each later one waits about 40 ms
CAPPED = {"VTPU_DEVICE_CORE_LIMIT": "50", "VTPU_EXEC_COST_US": "20000"}
LAUNCHES = 14

#: prints the counters, the spans and ``extra`` as one RESULT line
REPORT = """
import json
from k8s_device_plugin_torch.shm import counters

def report(**extra):
    got = counters.spans(0)
    spans = None if got is None else list(got)
    print("RESULT", json.dumps({"counters": counters.counters(0),
                                "spans": spans, **extra}))
"""


def _body(text: str) -> str:
    """``text`` (indented) after :data:`REPORT`, for ``run_wrapped``."""
    return REPORT + textwrap.dedent(text)


def _result(res) -> dict:
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")]
    assert line, res.stdout + res.stderr
    return json.loads(line[0][len("RESULT "):])


#: a program linked against the driver: LAUNCHES launches by a direct
#: call, then the counters read through the process's own symbols
DIRECT = r"""
#include "cuda_driver_abi.h"
#include <dlfcn.h>
#include <stdio.h>
typedef struct {
    uint32_t size, version;
    uint64_t field[9];
} counters_t;
int main(void) {
    CUcontext ctx;
    if (cuInit(0) || cuDevicePrimaryCtxRetain(&ctx, 0) ||
        cuCtxSetCurrent(ctx)) {
        return 1;
    }
    for (int i = 0; i < %d; i++) {
        if (cuLaunchKernel((CUfunction)0x1000, 1, 1, 1, 32, 1, 1, 0, NULL,
                           NULL, NULL)) {
            return 2;
        }
    }
    int (*read)(int, counters_t *) =
        (int (*)(int, counters_t *))dlsym(RTLD_DEFAULT, "vtpu_cuda_counters");
    counters_t c = {sizeof(c), 0, {0}};
    if (!read || read(0, &c)) {
        return 3;
    }
    printf("COUNTERS");
    for (int i = 0; i < 9; i++) {
        printf(" %%llu", (unsigned long long)c.field[i]);
    }
    printf("\n");
    return 0;
}
""" % LAUNCHES


@pytest.mark.parametrize("route", ["direct", "dlsym", "proc", "proc_ptsz"])
def test_bucket_counters_and_spans(libs, tmp_path, route):
    """Under a 50% core limit at a pinned 20 ms a launch, by each route:
    every launch is counted and charged its 20 ms, the bucket grants all
    but what waits for the next batch, the launches past the burst wait,
    the counted sleep lies inside those launches' wall time and accounts
    for most of what they took beyond the grant-at-once path, and each
    wait's span lies inside the ``time.time_ns()`` stamps of the launch
    that waited: the shared clock."""
    cache = tmp_path / "cache"
    if route == "direct":
        src = tmp_path / "direct.c"
        src.write_text(DIRECT)
        prog = str(tmp_path / "direct")
        _cc(prog, "-I", _build.CSRC_DIR, str(src), libs["cuda_mock"],
            f"-Wl,-rpath,{os.path.dirname(libs['cuda_mock'])}", "-ldl")
        os.makedirs(cache)
        res = subprocess.run([prog], capture_output=True, text=True,
                             env=_env(libs, cache, 512 << 20, CAPPED),
                             timeout=60)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("COUNTERS")]
        assert res.returncode == 0 and line, (res.stdout, res.stderr)
        got = dict(zip(counters.FIELDS, map(int, line[0].split()[1:])))
        assert got["launches"] == LAUNCHES
        assert got["charged_us"] == got["granted_us"] == LAUNCHES * 20000
        assert got["waits"] >= 1 and got["slept_ns"] > 0
        assert got["hook_ns"] > 0 and got["driver_ns"] > 0
        return
    body = _body(f"""
    stamps = []
    for _ in range({LAUNCHES}):
        a = time.time_ns()
        assert cu.launch() == cc.CUDA_SUCCESS
        stamps.append((a, time.time_ns()))
    assert counters.spans(1 << 40)[::2] == ([], 0)  # past the last
    report(stamps=stamps)
    """)
    res = _result(run_wrapped(libs, cache, body, extra_env=CAPPED,
                              route=route[:5],
                              flags=2 if route == "proc_ptsz" else 0))
    c, (spans, nxt, lost) = res["counters"], res["spans"]
    stamps = np.asarray(res["stamps"], dtype=np.int64)
    assert c["launches"] == LAUNCHES
    assert c["charged_us"] == LAUNCHES * 20000
    assert 0 <= c["charged_us"] - c["granted_us"] < CHARGE_BATCH_US
    assert c["waits"] >= 1 and len(spans) == nxt == c["waits"] and lost == 0
    assert c["hook_ns"] > 0 and c["driver_ns"] > 0
    assert c["timed"] == c["timed_us"] == 0  # a pinned cost times nothing
    waited = set()
    for start, end, cost, dev, kinds in spans:
        assert (cost, dev, kinds) == (20000, 0, counters.WAIT_BUCKET)
        inside = np.flatnonzero((stamps[:, 0] <= start) & (end <= stamps[:, 1]))
        assert len(inside) == 1, (start, end, stamps)
        waited.add(int(inside[0]))
    took = stamps[:, 1] - stamps[:, 0]
    fast = np.median([t for i, t in enumerate(took) if i not in waited])
    beyond = sum(took[i] - fast for i in waited)
    slept = c["slept_ns"]
    assert 0.03e9 <= slept <= sum(took[i] for i in waited), (c, took)
    assert beyond <= 1.5 * slept + 0.02e9 * len(waited), (c, beyond)


@pytest.mark.parametrize("how", ["kernel", "ex", "cooperative", "graph"])
def test_counters_without_a_core_limit(libs, tmp_path, how):
    """With no core limit every launch entry point is counted (a graph's
    launch as one), in the hooks' and the driver's time, and nothing is
    charged, waited or spanned. A caller's smaller struct is filled no
    further than its size."""
    body = _body(f"""
    import ctypes
    for _ in range(5):
        assert cu.launch(how={how!r}) == cc.CUDA_SUCCESS
    read = ctypes.CDLL(None).vtpu_cuda_counters
    head = (ctypes.c_uint32 * 6)(16, 0, 0, 0, 7, 7)  # size, version, launches
    assert read(0, head) == 0 and list(head) == [16, 1, 5, 0, 7, 7]
    head[0] = 4
    assert read(0, head) == -1
    head[0] = 16
    assert read(16, head) == -1
    report()
    """)
    res = _result(run_wrapped(libs, tmp_path / "cache", body))
    c = res["counters"]
    assert c["launches"] == 5
    assert c["hook_ns"] > 0 and c["driver_ns"] > 0
    quiet = ("charged_us", "granted_us", "waits", "slept_ns")
    assert [c[k] for k in quiet] == [0] * len(quiet)
    assert res["spans"] == [[], 0, 0]


def test_timed_launches_read_the_device_time(libs, tmp_path):
    """Without a pinned cost each launch's event pair is read at the next
    launch: the mock's 5 ms launches read 5000 us each."""
    body = _body("""
    for _ in range(8):
        cu.launch()
    report()
    """)
    c = _result(run_wrapped(libs, tmp_path / "cache", body,
                            extra_env={"VTPU_DEVICE_CORE_LIMIT": "99",
                                       "VTPU_MOCK_CUDA_LAUNCH_US": "5000"})
                )["counters"]
    assert c["launches"] == 8 and c["timed"] == 7
    assert c["timed_us"] / c["timed"] == pytest.approx(5000, rel=0.01)


def test_priority_block_spans_an_uncapped_launch(libs, tmp_path):
    """The monitor's block holds an uncapped container: its wait is
    counted and spanned as a block, at no cost asked."""
    body = _body("""
    import threading
    r = region()
    with r.locked():
        r.data.recent_kernel = -1
        r.data.utilization_switch = 1

    def unblock():
        time.sleep(0.3)
        with r.locked():
            r.data.recent_kernel = 1

    t = threading.Thread(target=unblock)
    t.start()
    a = time.time_ns()
    cu.launch()
    b = time.time_ns()
    t.join()
    r.close()
    report(stamps=[a, b])
    """)
    res = _result(run_wrapped(libs, tmp_path / "cache", body))
    c, (spans, _, _) = res["counters"], res["spans"]
    assert c["waits"] == 1 and c["charged_us"] == 0
    ((start, end, cost, dev, kinds),) = spans
    a, b = res["stamps"]
    assert (cost, dev, kinds) == (0, 0, counters.WAIT_BLOCK)
    assert a <= start and end <= b and end - start >= 0.25e9
    assert end - start == pytest.approx(c["slept_ns"], abs=1e6)


@pytest.mark.parametrize("case", ["unloaded", "kill_switch"])
def test_reader_without_the_shim(libs, tmp_path, case):
    """A process without the shim, or one where it failed open, has no
    counters or spans to read: the reader returns None (here too)."""
    assert counters.counters() is None and counters.spans() is None
    body = _body("""
    cu.launch()
    report()
    """)
    res = _result(run_wrapped(
        libs, tmp_path / "cache", body, preload=case != "unloaded",
        extra_env={"VTPU_DISABLE_CONTROL": "true"}
        if case == "kill_switch" else None))
    assert res["counters"] is None and res["spans"] is None


def test_rate_limit_returns_what_it_slept(tmp_path):
    """The port's vtpu_rate_limit returns 0 and no wait where it grants
    at once, and otherwise the ns it slept, what the wall clock shows,
    with what it slept for: the bucket, the monitor's block."""
    lib = ctypes.CDLL(_build.host_library("vtpu_shm"))
    lib.vtpu_rate_limit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_uint64,
                                    ctypes.POINTER(ctypes.c_uint32)]
    lib.vtpu_rate_limit.restype = ctypes.c_uint64
    r = Region(str(tmp_path / "vtpu.cache"))
    r.set_limits([0], core_percent=50)
    kinds = ctypes.c_uint32(7)

    def wait(cost):
        t0 = time.monotonic_ns()
        slept = lib.vtpu_rate_limit(ctypes.addressof(r.data), 0, cost,
                                    ctypes.byref(kinds))
        return slept, time.monotonic_ns() - t0, kinds.value

    assert wait(200000)[::2] == (0, 0)  # the burst, granted at once
    slept, wall, waited = wait(20000)  # 40 ms at 50%
    assert waited == counters.WAIT_BUCKET
    assert 0.03e9 <= slept <= wall <= 1.5 * slept + 0.02e9, (slept, wall)
    with r.locked():
        r.data.recent_kernel, r.data.utilization_switch = -1, 1
    threading.Timer(0.1, setattr, (r.data, "recent_kernel", 1)).start()
    slept, wall, waited = wait(0)
    assert waited & counters.WAIT_BLOCK and slept >= 0.09e9
    assert slept <= wall <= 1.5 * slept + 0.02e9, (slept, wall)
    r.close()
