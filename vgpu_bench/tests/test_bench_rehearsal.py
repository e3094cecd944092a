"""The harness rehearsed on the CPU: tiny cells in a copy of the
benchmark, unwrapped, with the supervisor told to use the CPU (which a
run from the command line cannot do)."""

import json
import os
import subprocess
import sys

import pytest

import rehearse
from rehearse import REPO, result, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return rehearse.root(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("workload", ["l.duo", "r.solo"])
def test_run_prints_the_contract(checkout, workload):
    rc, lines, err = run(checkout, workload)
    assert rc == 0, err
    line = result(lines)
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True, err
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"items_per_s", "call_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    assert "check logit_err" in err.splitlines()[-2]
    assert json.loads(lines[-2])["calls"] == line["attempted"]


def test_traced_run_reads_the_per_layer_metrics(checkout):
    rc, lines, err = run(checkout, "l.duo", trace=1)
    assert rc == 0, err
    line = result(lines)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert line["correct"] is True
    # no core limit, no K2 on the CPU: those readers find nothing
    assert set(line["metrics"]) == {"host_enqueue_ms", "mfu",
                                    "device_idle_share",
                                    "tenant_rate_spread"}
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 < len(line["breakdown"]["device_ops"]) <= 10
    assert len(line["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch", "raises"])
def test_planted_fault_is_not_correct(checkout, fault):
    rc, lines, err = run(checkout, "l.duo",
                         wrap=f"vgpu_bench.tests.faults:{fault}")
    assert rc == 0, err
    assert result(lines)["correct"] is False


def test_a_new_cell_is_new_files_and_an_entry(checkout, tmp_path):
    """A later change adds a traffic mix, a configuration and a metric as
    files, and a cell as an entry of BENCHMARK.json, editing no file."""
    import shutil
    root = str(tmp_path / "later")
    shutil.copytree(checkout, root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs}
    with open(os.path.join(root, "vgpu_bench/traffic/trio.json"), "w") as f:
        json.dump({**rehearse.DUO, "tenants": 3}, f)
    cfg = {**rehearse.config("lstm-tiny"), "name": "lstm-wide",
           "features": 16, "runner_size": 16, "input_shape": [2, 3, 16]}
    with open(os.path.join(root, "vgpu_bench/configs/lstm-wide.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "vgpu_bench/metrics/calls_total.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    return sum(len(t['calls']) for t in run.tenants)\n")
    bench["configs"].append({"name": "lstm-wide", "source": "tiny",
                             "file": "vgpu_bench/configs/lstm-wide.json",
                             "reduced": [], "why": "rehearsal"})
    bench["workloads"].append({"name": "l.trio", "config": "lstm-wide",
                               "traffic": "trio", "chips": 1, "why": "x"})
    bench["end_to_end"] += [
        {"name": "calls_total", "unit": "calls", "better": "higher",
         "bound": 0.1, "source": "host_clock", "workloads": ["l.trio"]},
        {"name": "items_per_s.trio", "unit": "items/s", "better": "higher",
         "bound": 0.1, "source": "host_clock", "workloads": ["l.trio"]}]
    rehearse.write_bench(root, bench)
    after = {os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs}
    assert before <= after
    rc, lines, err = run(root, "l.trio")
    assert rc == 0, err
    line = result(lines)
    assert line["correct"] is True
    assert line["metrics"]["calls_total"]["value"] == line["attempted"]
    # a metric kept apart for a cell is read by its base's reader
    assert line["metrics"]["items_per_s.trio"]["value"] \
        == line["metrics"]["items_per_s"]["value"]
    assert len(json.loads(lines[-2])["tenant_items_per_s"]) == 3


def test_no_card_no_result(checkout):
    """A real cell without a card exits with 2 and prints no result; it
    never falls back to the CPU."""
    rc, lines, err = run(REPO, "resnet50.share4", device=None)
    assert (rc, lines) == (2, [])
    assert "CUDA device" in err
    proc = subprocess.run(
        [sys.executable, "-m", "vgpu_bench.run", "--workload", "lstm.share4",
         "--seed", "4294967311", "--seconds", "10", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert (proc.returncode, proc.stdout) == (2, "")


def test_wrapped_mix_needs_the_card(checkout, tmp_path):
    rc, lines, err = run(REPO, "resnet50.share4")
    assert rc == 1 and lines == []
    assert "on a card" in err


def test_unknown_workload(checkout):
    rc, lines, err = run(checkout, "nope")
    assert rc == 1 and lines == []
    assert "no workload" in err
