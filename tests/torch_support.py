"""What the port's parity tests share.

:func:`one_torch_thread`, imported into a test module, runs that module's
tests on one torch thread: tier-1 runs six workers at once, beside
``tests/test_stress.py``, whose scheduler bench has a wall-clock timeout.

:func:`seeded_variables` fills the tree of a Flax model's init with numpy
draws instead of running the init: ``jax.eval_shape`` gives the tree
without tracing it into XLA or compiling it, which for a ResNet-50 saves
about 20 CPU-seconds a test. Both import JAX when called, so a test file
that needs only the fixture does not pay for it.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(model, x, seed: int, train: bool = True) -> dict:
    """Variables in the tree of ``model``'s init on ``x``, fp32, drawn from
    ``seed`` (see :func:`seeded_tree`)."""
    import jax

    from k8s_device_plugin_tpu.workloads import harness as jh
    shapes = jax.eval_shape(
        lambda b: jh.init_model(model, b, train=train), x)
    return seeded_tree(shapes, seed)


def seeded_tree(shapes, seed: int) -> dict:
    """Arrays for the shapes of a Flax variable tree, fp32, drawn from
    ``seed``: kernels normal over sqrt(fan-in), BatchNorm scales near 1,
    other vectors and running means near 0, running variances in
    [0.5, 1.5]."""
    import jax
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if len(shape) > 1:
            fan_in = np.prod(shape[:-1])
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return (float(name == "scale")
                + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))
