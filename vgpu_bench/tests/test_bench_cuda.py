"""The benchmark on the card: one short run of a real cell, and the
control at a cell's own size. Skips without a card (decided in the
fixture, never at import)."""

import json
import subprocess
import sys

import pytest

import rehearse
from rehearse import REPO


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def bench(*args, timeout=900):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["resnet50.solo", "lstm.share4"])
def test_cell_on_the_card(card, workload):
    proc = bench("vgpu_bench.run", "--workload", workload, "--seed",
                 "3000000019", "--seconds", "2", "--trace", "0")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    proc = bench("vgpu_bench.control", "--workload", "lstm.share4",
                 "--seeds", "5")
    assert proc.returncode == 0, proc.stderr[-3000:]
    reading = json.loads(proc.stdout.splitlines()[-1])
    limit = rehearse.config("lstm.case5.1")["limits"]["logit_err"]
    assert reading["logit_err"] > limit
