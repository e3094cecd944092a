"""Checkpoint and elastic resize in the port, on CPU ranks over gloo.

The contract of ``tests/test_checkpoint.py`` and ``tests/test_elastic.py``:
training saved at step 2 and resumed (on the same mesh, on another mesh
shape, on another number of ranks) continues the loss trajectory of the
run that never stopped, and a sharded save restores whole in one process
with no process group. Checkpointing holds no kernel and no JAX numerics,
so it is held on the port's own uninterrupted trajectory.

* ResNet-V2-50 cut to one bottleneck a stage (``DEPTHS[50]`` patched in
  each rank, as ``tests/test_torch_sharded.py`` cuts it, for the CPU's
  sake), 8 classes, fp32, SGD-momentum 0.9 at 1e-2 (the JAX tests'
  ``optax.sgd``), a batch of 8 @ 16 x 16 split over dp with BatchNorm over
  the whole batch: saved from (dp, mp) = (4, 2) after 2 steps; resumed on
  (4, 2) (losses within rtol 1e-6) and on (2, 4) (rtol 1e-5); the save
  restored in this process with no mesh equals, leaf by leaf, what the
  ranks held (the head put together from its mp columns) and the momentum
  buffers.
* JAX's ``TinyNet`` (Dense 16 -> 32, a head of 4; batch 12) through
  ``elastic``: grown 4 -> 8 ranks, shrunk 8 -> 6, and 4 x 2 -> 2 x 4 in one
  call of ``checkpoint_replan_resume``, each within rtol 1e-5; grown
  without the momentum buffers, it leaves the trajectory.

Three spawns: 4 ranks (TinyNet trains, saves A), 8 ranks (grows from A;
TinyNet saves B by ``checkpoint_replan_resume``; the ResNet's legs), 6
ranks (shrinks from B). The checkpoints live under the module's
temporary directory.
"""

import ast
import os

import numpy as np
import pytest
import torch

from k8s_device_plugin_torch import dryrun
from k8s_device_plugin_torch.workloads import checkpoint, elastic, harness
from k8s_device_plugin_torch.workloads import resnet as tresnet
from torch_support import one_torch_thread  # noqa: F401 (autouse)

BLOCKS = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(80)
    out = {name: str(d / name) for name in ("tiny_a", "tiny_b", "resnet")}
    out["tiny_batch"] = str(d / "tiny_batch.npz")
    out["resnet_batch"] = str(d / "resnet_batch.npz")
    np.savez(out["tiny_batch"],
             x=rng.standard_normal((12, 16)).astype(np.float32),
             labels=rng.integers(0, 4, (12,)))
    np.savez(out["resnet_batch"],
             x=rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
             labels=rng.integers(0, 8, (8,)))
    return out


@pytest.fixture(scope="module")
def ranks(paths):
    tiny = {"net": "tiny", "inputs": paths["tiny_batch"]}
    res = {"net": "resnet", "inputs": paths["resnet_batch"],
           "blocks": BLOCKS}
    four = dryrun.spawn(4, [("resize_step", dict(tiny, mp=2,
                                                 save=paths["tiny_a"]))])
    eight = dryrun.spawn(8, [
        ("resize_step", dict(tiny, mp=2, restore=paths["tiny_a"])),
        ("resize_step", dict(tiny, mp=2, save=paths["tiny_b"], replan_mp=4)),
        ("resize_step", dict(res, mp=2, save=paths["resnet"],
                             state_ranks=(0, 1))),
        ("resize_step", dict(res, mp=2, restore=paths["resnet"])),
        ("resize_step", dict(res, mp=4, restore=paths["resnet"])),
        ("resize_step", dict(tiny, mp=2, restore=paths["tiny_a"],
                             momentum=False))])
    six = dryrun.spawn(6, [("resize_step", dict(tiny, mp=2,
                                                restore=paths["tiny_b"]))])
    return {"four": four, "eight": eight, "six": six}


def _check_resumed(resumed: list, ref: list, mesh: dict, rtol: float):
    for r, got in enumerate(resumed):
        assert got["mesh"] == mesh
        assert got["restored_step"] == 2
        np.testing.assert_allclose(got["losses"], ref, rtol=rtol,
                                   err_msg=f"rank {r}")


def test_resume_same_mesh_exact(ranks):
    """Saved from (4, 2) after 2 steps and restored onto (4, 2) by fresh
    ranks' models: the next 2 losses within rtol 1e-6 of the run that
    never stopped."""
    eight = ranks["eight"]
    ref = eight[0][2]["losses"]
    _check_resumed([r[3] for r in eight], ref, {"dp": 4, "mp": 2}, 1e-6)


def test_resume_across_mesh_shapes(ranks):
    """Saved from (dp, mp) = (4, 2), restored onto (2, 4): each rank reads
    the blocks of its own quarter of the head, and the trajectory holds
    within rtol 1e-5."""
    eight = ranks["eight"]
    _check_resumed([r[4] for r in eight], eight[0][2]["losses"],
                   {"dp": 2, "mp": 4}, 1e-5)


def test_momentum_buffers_are_part_of_the_state(ranks):
    """TinyNet's save of 4 ranks grown to 8 without the optimizer's
    momentum buffers: SGD takes the first gradient for the buffer and the
    trajectory leaves the reference by far more than the resumes' rtol,
    so a restore that dropped them would fail the tests above."""
    ref = ranks["four"][0][0]["losses"]
    got = ranks["eight"][0][5]["losses"]
    assert got[0] == pytest.approx(ref[0], rel=1e-5)  # the same weights
    assert abs(got[1] - ref[1]) > 1e-3 * abs(ref[1])


def test_restore_without_a_mesh_is_whole(ranks, paths):
    """The sharded save restored in this process, with no process group:
    every tensor whole and equal to what the ranks held (the head's two mp
    column blocks joined), every momentum buffer too, and step 2."""
    assert not torch.distributed.is_initialized()
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(tresnet.DEPTHS, 50, BLOCKS)
        model = tresnet.ResNetV2(depth=50, num_classes=8,
                                 dtype=torch.float32)
    optimizer = harness.sgd(model, lr=1e-2)
    state = checkpoint.restore_checkpoint(paths["resnet"], model, optimizer)
    assert state == {"step": 2}
    saved = [ranks["eight"][r][2] for r in (0, 1)]
    momentum = {n: optimizer.state[p]["momentum_buffer"]
                for n, p in model.named_parameters()}
    assert sorted(momentum) == sorted(saved[0]["momentum"])
    for key, got in (("state", model.state_dict()), ("momentum", momentum)):
        for name, t in got.items():
            want = saved[0][key][name]
            if name.startswith("head."):
                want = torch.cat([saved[0][key][name], saved[1][key][name]])
            assert tuple(t.shape) == tuple(want.shape), name
            torch.testing.assert_close(t, want, rtol=0, atol=0, msg=name)


def test_grow_4_to_8_resumes_exact(ranks):
    """Trained on 4 ranks ((2, 2)) and saved; resumed by 8 ((4, 2)) within
    rtol 1e-5 of the 4 ranks' next 2 losses."""
    ref = ranks["four"][0][0]["losses"]
    _check_resumed([r[0] for r in ranks["eight"]], ref, {"dp": 4, "mp": 2},
                   1e-5)


def test_shrink_8_to_6_resumes_exact(ranks):
    """Trained on 8 ranks ((4, 2)) and saved; resumed by 6 ((3, 2)) within
    rtol 1e-5 of the 8 ranks' next 2 losses."""
    ref = ranks["eight"][0][1]["losses"]
    _check_resumed([r[0] for r in ranks["six"]], ref, {"dp": 3, "mp": 2},
                   1e-5)


def test_checkpoint_replan_resume_in_one_world(ranks):
    """``checkpoint_replan_resume`` saves from (4, 2) and restores onto
    (2, 4) in one call: the resumed model's 2 losses within rtol 1e-5 of
    the saved run's next 2."""
    for r, got in enumerate(r[1] for r in ranks["eight"]):
        np.testing.assert_allclose(got["replan_losses"], got["losses"],
                                   rtol=1e-5, err_msg=f"rank {r}")


def _jax_resize_signal_env() -> str:
    """JAX's ``elastic.RESIZE_SIGNAL_ENV``, read from its source: importing
    the module imports JAX and orbax (about 6 CPU-seconds) for one
    string."""
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "k8s_device_plugin_tpu", "workloads", "elastic.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return next(node.value.value for node in tree.body
                if isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["RESIZE_SIGNAL_ENV"])


def test_resize_signal_env_parsing(monkeypatch):
    """JAX's cases: unset, a size, garbage and a negative value; and the
    env var's name is JAX's."""
    assert elastic.RESIZE_SIGNAL_ENV == _jax_resize_signal_env() \
        == "VTPU_GANG_RESIZE"
    monkeypatch.delenv(elastic.RESIZE_SIGNAL_ENV, raising=False)
    assert elastic.resize_signal() == 0
    monkeypatch.setenv(elastic.RESIZE_SIGNAL_ENV, "6")
    assert elastic.resize_signal() == 6
    monkeypatch.setenv(elastic.RESIZE_SIGNAL_ENV, "garbage")
    assert elastic.resize_signal() == 0  # never crash a worker
    monkeypatch.setenv(elastic.RESIZE_SIGNAL_ENV, "-3")
    assert elastic.resize_signal() == 0


def test_restore_refuses_a_checkpoint_without_the_models_tensors(
        ranks, paths):
    """A checkpoint that lacks a tensor of the model fails to restore;
    nothing falls back to the fresh weights."""
    net = dryrun.TinyNet()
    net.extra = torch.nn.Linear(2, 2)
    with pytest.raises(KeyError, match="has no extra.weight"):
        checkpoint.restore_checkpoint(paths["tiny_a"], net)
