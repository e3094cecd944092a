"""Import hygiene: the port and its chip scripts import no JAX.

Walks the AST of every module of ``k8s_device_plugin_torch/`` and of
``chip_smoke.py`` and ``chip_compare.py`` and fails on any import of ``jax``, ``flax``, ``optax``
or ``k8s_device_plugin_tpu`` — at top level or inside a function.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "k8s_device_plugin_tpu"}


def _port_files():
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                             "chip_compare.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "k8s_device_plugin_torch")):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_the_port_has_modules_to_check():
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    assert "chip_smoke.py" in rel
    assert "k8s_device_plugin_torch/workloads/resnet.py" in rel
    assert len(rel) >= 15


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_detector_catches_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from flax import linen\n"
                   "def f():\n"
                   "    import optax\n"
                   "    from k8s_device_plugin_tpu.shm import region\n"
                   "    importlib.import_module('jax')\n"
                   "from . import sibling\n")
    assert [m for _, m in _imported_roots(str(src))] == \
        ["jax", "flax", "optax", "k8s_device_plugin_tpu", "jax"]
