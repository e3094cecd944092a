"""The port's bench phases after the share, on the CPU: the oversubscribe
phase and the duty-cycle check, held against the JAX bench
(``bench.py``'s ``_run_oversubscribe``, ``_run_duty_check`` and
``_assemble_result``), a share child under ``VTPU_OVERSUBSCRIBE=1``, and
the token bucket's duty under a core limit of 50 on a mocked clock. Rates
from a CPU run say nothing about a card: only keys, accounting and the
bucket's arithmetic are checked here.
"""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

import bench as jbench
from k8s_device_plugin_torch import bench as tbench
from k8s_device_plugin_torch.shm import limiter as tlimiter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_line(img_per_s=10.0, start=0.0, spill=0, violations=0):
    return {"img_per_s": img_per_s, "best_pass_img_per_s": img_per_s,
            "images": 10, "start": start, "end": start + 1.0,
            "platform": "cpu", "device": "cpu", "total_bytes": 0, "batch": 1,
            "image_size": 32, "hbm_used_bytes": 0, "hbm_module_bytes": 0,
            "hbm_cap_bytes": 0,
            "violations": violations, "spill_bytes": spill,
            "flops_per_img": 1.0}


def _jax_phases(monkeypatch, tmp_path):
    """The JAX bench's two phase entries, from its own functions with the
    children it would start replaced by fixed lines."""
    monkeypatch.setattr(jbench, "_BENCH_START", time.time())
    monkeypatch.setattr(jbench, "_fan_out_children",
                        lambda *a, **k: [dict(_child_line(), spill_bytes=5)])
    monkeypatch.setattr(jbench, "_run_child", lambda *a, **k: _child_line())
    args = jbench.parse_args([])
    return (jbench._run_oversubscribe(args, str(tmp_path)),
            jbench._run_duty_check(args, str(tmp_path)))


def test_extra_phases_carry_the_jax_benchs_keys(monkeypatch, tmp_path):
    """extra.oversubscribe and extra.duty_check: the JAX bench's keys,
    under the same names in the assembled result."""
    oversub, duty = _jax_phases(monkeypatch, tmp_path)
    line = {"img_per_s": 10.0, "batch": 1, "image_size": 32,
            "platform": "cpu", "device": "cpu", "flops_per_img": 1.0}
    want = jbench._assemble_result(jbench.parse_args([]), line,
                                   dict(line, share_procs=4), oversub,
                                   duty)["extra"]

    lines = [_child_line(10.0, 0.0, spill=3), _child_line(10.0, 0.5,
                                                          spill=4)]
    t_over = tbench.oversubscribe_result(2, lines)
    t_duty = tbench.duty_result(_child_line(20.0), _child_line(10.0))
    share = dict(tbench.aggregate(lines), share_procs=2)
    probe = types.SimpleNamespace(availability=1.0, samples=1,
                                  baseline_ms=1.0, last_ms=1.0)
    runner = types.SimpleNamespace(size=32, steps=4)
    got = tbench.assemble(tbench.parse_args(["--device", "cpu"]),
                          dict(_child_line(), window_s=1.0,
                               native_img_per_s=10.0), share, probe, runner,
                          t_over, t_duty)["extra"]
    for key in ("oversubscribe", "duty_check"):
        assert sorted(got[key]) == sorted(want[key]), key
    assert t_over == {"replicas": 2, "spill_bytes": 7, "violations": 0,
                      "img_per_s": 20 / 1.5}
    assert t_duty == {"uncapped_img_per_s": 20.0, "capped50_img_per_s": 10.0,
                      "ratio": 0.5, "within_band": True}
    assert not tbench.duty_result(_child_line(20.0), _child_line(19.0))[
        "within_band"]
    assert tbench.DUTY_BAND == (0.35, 0.65)
    assert (tbench.QUICK_TIER, tbench.OVERSUB_CAP_BYTES) == (
        tuple(jbench.TIERS[0]), 64 << 20)


def test_oversubscribed_usage_is_spill_not_a_violation(tmp_path,
                                                       monkeypatch):
    """memory_accounting: usage above the cap is spill under
    VTPU_OVERSUBSCRIBE and no violation; without it, no spill."""
    cap = 1 << 20
    for oversub in (True, False):
        monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE",
                           str(tmp_path / str(oversub)))
        monkeypatch.setenv("VTPU_DEVICE_MEMORY_LIMIT_0", str(cap))
        if oversub:
            monkeypatch.setenv("VTPU_OVERSUBSCRIBE", "1")
        else:
            monkeypatch.delenv("VTPU_OVERSUBSCRIBE", raising=False)
        lim = tlimiter.CooperativeLimiter(poll_interval=60)
        assert lim.install()
        try:
            lim.poll_once(stats=[(0, {"bytes_in_use": 3 * cap})])
            used, spill, violations = tbench.memory_accounting(
                lim, cap, torch.device("cpu"))
        finally:
            lim.uninstall()
        assert used == 3 * cap and violations == 0
        assert spill == (2 * cap if oversub else 0)


def test_a_cpu_share_child_under_oversubscription(tmp_path):
    """One share child on the CPU under VTPU_OVERSUBSCRIBE=1 and the
    phase's 64 MiB cap: it finishes, reports spill_bytes beside the share
    line's keys, and no violation."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    env.update({"VTPU_DEVICE_MEMORY_SHARED_CACHE": str(tmp_path),
                "VTPU_DEVICE_MEMORY_LIMIT_0": str(tbench.OVERSUB_CAP_BYTES),
                "VTPU_OVERSUBSCRIBE": "1", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO})
    run = subprocess.run(
        [sys.executable, "-m", "k8s_device_plugin_torch.bench",
         "--child-phase", "share", "--device", "cpu", "--batch", "1",
         "--image-size", "32", "--iters", "1"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert sorted(line) == sorted(_child_line())
    assert line["violations"] == 0 and line["spill_bytes"] == 0  # no card
    assert line["hbm_cap_bytes"] == 64 << 20


class _Clock:
    """A clock that only ``sleep`` and the test move."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s

    def time(self):
        return self.t


@pytest.mark.parametrize("call_us", [2000, 50000, 150000])
def test_the_bucket_holds_a_50_percent_duty(tmp_path, monkeypatch,
                                            call_us):
    """The limiter's token bucket on a mocked clock: a tenant whose calls
    each hold the device for ``call_us`` and are charged once they are
    done, as the bench's metered child charges each call before the next,
    after draining the full bucket, gets 50% of the time under
    VTPU_DEVICE_CORE_LIMIT=50 (within 1% over 40 calls) and all of it at
    0."""
    clock = _Clock()
    monkeypatch.setattr(tlimiter, "time", clock)
    for pct, want in ((50, 0.5), (0, 1.0)):
        monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE",
                           str(tmp_path / str(pct)))
        monkeypatch.setenv("VTPU_DEVICE_CORE_LIMIT", str(pct))
        lim = tlimiter.CooperativeLimiter(poll_interval=60)
        assert lim.install()
        try:
            lim.throttle(tlimiter.BUCKET_CAPACITY_US)  # drain the burst
            start = clock.t
            for _ in range(40):
                clock.t += call_us / 1e6  # the call holds the device
                lim.throttle(call_us)
            duty = 40 * call_us / 1e6 / (clock.t - start)
        finally:
            lim.uninstall()
        assert duty == pytest.approx(want, rel=0.01), (pct, duty)
