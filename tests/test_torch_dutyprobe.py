"""Duty-probe chain: the PyTorch port against the JAX package's probe.

``PallasProbe`` runs its Pallas kernel in interpret mode on the CPU; the
port's ``probe_chain`` runs its plain version there (the CUDA kernel is
held against that plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.monitor import dutyprobe as tprobe
from k8s_device_plugin_tpu.monitor.dutyprobe import DutyProbe, PallasProbe


@pytest.mark.parametrize("size,steps", [(8, 3), (32, 4)])
def test_chain_matches_pallas_probe(size, steps):
    ref = PallasProbe(size=size, steps=steps, interpret=True)
    ref()  # builds the kernel and its operands
    want = np.asarray(ref._fn(ref._x, ref._w))
    x, w = tprobe.probe_operands(size)
    np.testing.assert_array_equal(x, np.asarray(ref._x))
    np.testing.assert_array_equal(w, np.asarray(ref._w))
    got = tprobe.probe_chain(torch.from_numpy(x), torch.from_numpy(w), steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_torch_probe_runs_on_cpu_without_launching_the_kernel():
    before = tprobe.probe_chain.launches
    runner = tprobe.TorchProbe(size=32, steps=4, device="cpu")
    assert runner._x is None  # lazy: nothing built at construction
    elapsed = runner()
    assert elapsed > 0
    assert runner._x.shape == (32, 32)
    assert tprobe.probe_chain.launches == before


def test_torch_probe_calibrates_its_chain_length():
    runner = tprobe.TorchProbe(size=16, steps=None, device="cpu")
    runner()
    assert runner.steps >= 16


@pytest.mark.parametrize("probe_cls", [DutyProbe, tprobe.DutyProbe])
def test_duty_probe_copy_behaves_like_the_original(probe_cls):
    # scripted runner: idle 2 ms, then contended samples
    times = iter([0.003, 0.002, 0.004, 0.004, 0.008, 0.001, 0.002])
    clock = iter(range(100))
    probe = probe_cls(runner=lambda: next(times), interval_s=0.5,
                      clock=lambda: float(next(clock)))
    assert probe.calibrate(n=2) == 0.002
    readings = [probe.sample() for _ in range(4)]
    assert readings == [0.5, 0.5, 0.25, 1.0]
    assert probe.baseline_s == pytest.approx(0.0018)
    assert probe.availability == pytest.approx(
        0.4 * 1.0 + 0.6 * (0.4 * 0.25 + 0.6 * (0.4 * 0.5 + 0.6 * 0.5)))


def test_duty_probe_copies_agree_sample_for_sample():
    rng = np.random.default_rng(0)
    script = list(rng.uniform(0.001, 0.01, 40))
    probes = []
    for cls in (DutyProbe, tprobe.DutyProbe):
        it = iter(script)
        clock = iter(np.arange(0.0, 400.0, 0.3))
        probes.append(cls(runner=lambda it=it: next(it), interval_s=1.0,
                          clock=lambda c=clock: float(next(c))))
    for p in probes:
        p.calibrate()
        while p.samples < 10:
            p.maybe_sample()
    a, b = probes
    assert (a.availability, a.baseline_s, a.last_ms) == \
        (b.availability, b.baseline_s, b.last_ms)


def test_probe_chain_rejects_a_device_without_a_kernel():
    x = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tprobe.probe_chain(x, x, 2)
