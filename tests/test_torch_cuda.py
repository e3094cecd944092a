"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build at
first use) and skips without one. Run them on the card with:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.monitor import dutyprobe
from k8s_device_plugin_torch.workloads import harness, pallas_ops
from k8s_device_plugin_torch.workloads.lstm import LSTMClassifier

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("size", [8, 32, 128])
def test_probe_chain_kernel_matches_plain(cuda, size):
    x, w = (torch.from_numpy(a).to(cuda)
            for a in dutyprobe.probe_operands(size))
    before = dutyprobe.probe_chain.launches
    got = dutyprobe.probe_chain(x, w, 16)
    torch.cuda.synchronize()
    assert dutyprobe.probe_chain.launches == before + 1
    want = dutyprobe.probe_chain_reference(x, w, 16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("batch,features,hidden", [
    (8, 128, 128), (3, 30, 100), (100, 300, 1024)])
def test_lstm_cell_kernel_matches_plain(cuda, dtype, tol, batch, features,
                                        hidden):
    rng = np.random.default_rng(0)
    shapes = [(batch, features), (batch, hidden), (batch, hidden),
              (features, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,)]
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             * (0.1 if i >= 3 else 1.0)).to(cuda, dtype)
            for i, s in enumerate(shapes)]
    before = pallas_ops.lstm_cell.launches
    got = pallas_ops.lstm_cell(*args)
    torch.cuda.synchronize()
    assert pallas_ops.lstm_cell.launches == before + 1
    want = pallas_ops.lstm_cell_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("batch,features,hidden", [
    (8, 128, 128), (100, 300, 1024)])
def test_lstm_cell_kernel_reads_unaligned_bf16_inputs(cuda, batch, features,
                                                      hidden):
    # each input one element past an aligned address: no vector load fits,
    # so every chunk takes the element-wise path
    rng = np.random.default_rng(1)
    shapes = [(batch, features), (batch, hidden), (batch, hidden),
              (features, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,)]
    args = []
    for i, s in enumerate(shapes):
        flat = torch.from_numpy(rng.standard_normal(int(np.prod(s)) + 1)
                                .astype(np.float32) * (0.1 if i >= 3 else 1.0))
        args.append(flat.to(cuda, torch.bfloat16)[1:].view(s))
    assert all(a.data_ptr() % 4 == 2 and a.is_contiguous() for a in args)
    got = pallas_ops.lstm_cell(*args)
    want = pallas_ops.lstm_cell_reference(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)


def test_lstm_classifier_on_the_card_matches_the_cpu(cuda):
    model = harness.init_model(
        LSTMClassifier(300, hidden=1024, dtype=torch.float32), 0, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8, 300)).astype(np.float32))
    want = harness.make_infer_fn(model)(x)
    got = harness.make_infer_fn(model.to(cuda))(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
