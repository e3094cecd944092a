"""``hack/shim_counters_harness.py`` on the CPU: its edits apply to the
benchmark's harness as it stands, and its five readers of the shim's
counters and spans give what they should on synthetic runs, and nothing
where a run has no counters or no trace."""

import importlib.util
import json
import os
import py_compile
import shutil
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HARNESS = _load(os.path.join(REPO, "hack", "shim_counters_harness.py"),
                "shim_counters_harness")


def _reader(name: str):
    """The ``read`` of the harness's metric ``name``."""
    mod = types.ModuleType(name)
    exec(compile(HARNESS.METRICS[name], name, "exec"), mod.__dict__)
    return mod.read


def _tenant(calls=4, start=0, end=10**9, **shim):
    """A tenant of a synthetic run: ``calls`` rows of stamps, and the
    window's counters where any are given."""
    t = {"calls": np.zeros((calls, 3), dtype=np.int64),
         "start_ns": start, "end_ns": end}
    if shim:
        t["shim"] = {k: shim.get(k, 0) for k in (
            "launches", "charged_us", "granted_us", "waits", "slept_ns",
            "hook_ns", "driver_ns", "timed", "timed_us")}
    return t


def _run(tenants, trace=None):
    return types.SimpleNamespace(tenants=tenants, trace=trace)


def test_patch_applies_to_the_harness(tmp_path):
    """The edits find their text in ``vgpu_bench`` as it stands, the files
    they give compile, and ``BENCHMARK.json`` gains the five entries at the
    end of ``per_layer`` with nothing else changed."""
    shutil.copytree(os.path.join(REPO, "vgpu_bench"), tmp_path / "vgpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    HARNESS.patch(str(tmp_path))
    for path in ("tenant.py", "run.py", "trace.py",
                 *(f"metrics/{m}.py" for m in HARNESS.METRICS)):
        py_compile.compile(str(tmp_path / "vgpu_bench" / path), doraise=True)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        before = json.load(f)
    with open(tmp_path / "BENCHMARK.json") as f:
        after = json.load(f)
    n = len(before["per_layer"])
    assert after["per_layer"][:n] == before["per_layer"]
    assert after["per_layer"][n:] == HARNESS.PER_LAYER
    assert {k: v for k, v in after.items() if k != "per_layer"} == \
        {k: v for k, v in before.items() if k != "per_layer"}
    layers = {m["layer"] for m in before["per_layer"]}
    assert {m["layer"] for m in HARNESS.PER_LAYER} <= layers
    cells = {w["name"] for w in before["workloads"]}
    assert all(set(m["workloads"]) <= cells for m in HARNESS.PER_LAYER)
    assert {m["name"].split(".")[0] for m in HARNESS.PER_LAYER} == \
        set(HARNESS.METRICS)


def test_counter_readers_mean_over_wrapped_tenants():
    """Launches a call, hook us a launch and sleep ms a call are each
    tenant's window difference over its calls or launches, meaned over the
    wrapped tenants; an unwrapped tenant is left out."""
    run = _run([_tenant(4, launches=400, hook_ns=40_000, slept_ns=80_000_000),
                _tenant(2, launches=400, hook_ns=80_000, slept_ns=0),
                _tenant(3)])
    assert _reader("launches_per_call")(run) == pytest.approx(150.0)
    assert _reader("shim_hook_us")(run) == pytest.approx(0.15)
    assert _reader("shim_sleep_ms")(run) == pytest.approx(10.0)


@pytest.mark.parametrize("name", sorted(HARNESS.METRICS))
def test_readers_give_none_without_counters(name):
    """A run whose tenants ran without the shim (the parent's, or an
    unwrapped mix) has nothing to read: every reader gives None, with a
    trace or without one."""
    tenants = [_tenant(3), _tenant(3)]
    trace = {"attributed_s": [1.0, 1.0],
             "idle": np.asarray([[0, 10]], dtype=np.int64)}
    assert _reader(name)(_run(tenants)) is None
    assert _reader(name)(_run(tenants, trace)) is None


def test_charge_over_device_needs_the_trace():
    """What the bucket granted over each tenant's device time in the
    trace, in %: none without a trace."""
    tenants = [_tenant(granted_us=1_400_000), _tenant(granted_us=600_000)]
    read = _reader("charge_over_device")
    assert read(_run(tenants)) is None
    trace = {"attributed_s": [1.0, 0.5]}
    assert read(_run(tenants, trace)) == pytest.approx(130.0)


def _spanned(spans, start=0, end=1000):
    t = _tenant(start=start, end=end, launches=1)
    t["spans"] = np.asarray([[a, b, 20000, 0, 1] for a, b in spans],
                            dtype=np.int64).reshape(-1, 5)
    return t


def test_bucket_idle_share():
    """Idle time counts where some tenant is inside a bucket wait: a gap
    a wait covers counts whole, a gap with no wait not at all, waits of
    two tenants over one gap once, and a span past the window's edge only
    up to the edge."""
    read = _reader("bucket_idle_share")
    idle = np.asarray([[100, 200], [400, 500], [900, 1000]], dtype=np.int64)
    trace = {"idle": idle}
    # the first gap held by one tenant's wait, the second by none
    held = _run([_spanned([(50, 250)]), _spanned([])], trace)
    assert read(held) == pytest.approx(10.0)
    # two tenants' overlapping waits over the first gap count once
    both = _run([_spanned([(50, 250)]), _spanned([(150, 300)])], trace)
    assert read(both) == pytest.approx(10.0)
    # a wait that runs past the window's end is clipped to it
    edge = _run([_spanned([(950, 5000)]), _spanned([])], trace)
    assert read(edge) == pytest.approx(5.0)
    # no gap at all: nothing held
    assert read(_run([_spanned([(50, 250)])],
                     {"idle": np.zeros((0, 2), np.int64)})) == 0.0
    # no trace, or no idle intervals in it (the parent's merge)
    assert read(_run([_spanned([(50, 250)])])) is None
    assert read(_run([_spanned([(50, 250)])], {"attributed_s": [1.0]})) \
        is None
