"""No process of the benchmark loads JAX or the JAX package, compared by
whole top-level names, and the references load nothing of the port."""

import subprocess
import sys

import rehearse
from rehearse import REPO, result, run
from vgpu_bench import tenant


def loaded(code: str) -> set:
    proc = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.partition('.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(proc.stdout.splitlines()[-1]))


def test_benchmark_processes_load_no_jax():
    names = loaded(
        "import vgpu_bench.run, vgpu_bench.tenant, vgpu_bench.build\n"
        "import torch\n"
        "from vgpu_bench import tenant, weights\n"
        "from rehearse import config\n"
        "m = tenant.build(config('lstm-tiny'), 1, torch.device('cpu'))\n"
        "from k8s_device_plugin_torch.workloads import harness\n"
        "harness.make_infer_fn(m)(weights.inputs(config('lstm-tiny'), 1, 0,"
        " 0, 'cpu'))\n"
        "from k8s_device_plugin_torch.shm import region\n".replace(
            "import torch\n", "import torch, sys\n"
            f"sys.path.insert(0, {rehearse.__file__.rsplit('/', 1)[0]!r})\n"))
    assert "k8s_device_plugin_torch" in names
    assert not names & set(tenant.FORBIDDEN)


def test_references_load_nothing_of_the_port():
    names = loaded(
        "import sys, torch\n"
        f"sys.path.insert(0, {rehearse.__file__.rsplit('/', 1)[0]!r})\n"
        "from rehearse import config\n"
        "from vgpu_bench import check\n"
        "for n in ('lstm-tiny', 'resnet-tiny'):\n"
        "    check.logit_err(config(n), 5, {0: [(0, torch.zeros(1))]}, 'cpu',"
        " control=True)\n")
    assert "torch" in names
    assert not names & ({"k8s_device_plugin_torch"} | set(tenant.FORBIDDEN))


def test_a_forbidden_module_fails_the_run(tmp_path, monkeypatch):
    """The check compares whole top-level names: with ``json`` forbidden
    the run refuses to print a result."""
    checkout = rehearse.root(str(tmp_path))
    monkeypatch.setattr(tenant, "FORBIDDEN", ("json",))
    rc, lines, err = run(checkout, "l.duo")
    assert rc == 1 and lines == [] or not lines[-1].startswith('{"correct"')
    assert "loaded json" in err
    monkeypatch.setattr(tenant, "FORBIDDEN", ("k8s_device_plugin",))
    rc, lines, err = run(checkout, "l.duo")
    assert rc == 0 and result(lines)["correct"] is True
