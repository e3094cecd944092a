"""The port's sharded ResNet train step on 8 CPU ranks over gloo, against
JAX's ``shard_train_step`` on the 8-device CPU mesh (``tests/conftest.py``
gives JAX 8 virtual CPU devices).

Both sides take one SGD-momentum step of a ResNet-V2-50 cut to one
bottleneck per stage (``DEPTHS[50]`` patched on both, as
``tests/test_torch_run.py`` cuts the JAX runner's), 8 classes, in fp32 with
BatchNorm in train mode, from the same seeded weights (in the Flax tree,
carried across by ``convert.flax_to_state_dict``) on the same seeded batch
of 16 @ 16 x 16. JAX's sharded step is jit of the global program, so the
port's must compute the unsharded step: BatchNorm over the whole batch,
the gradients averaged over dp, the head's columns split over mp.

One spawn of 8 ranks per module (the ``ranks`` fixture, through
``dryrun.spawn``, whose rank functions live in the port) runs every leg;
each test asserts on its cached results. The ranks run torch on one thread
each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from k8s_device_plugin_torch import api as tapi
from k8s_device_plugin_torch import dryrun
from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import harness as th
from k8s_device_plugin_torch.workloads import resnet as tresnet
from k8s_device_plugin_tpu import api as japi
from k8s_device_plugin_tpu.workloads import harness as jh
from k8s_device_plugin_tpu.workloads import resnet as jresnet
from torch_support import one_torch_thread, seeded_variables  # noqa: F401

BLOCKS = (1, 1, 1, 1)
CLASSES = 8
BATCH, SIZE = 16, 16
N = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded weights (the Flax tree, fp32) and batch, as the JAX side
    takes them and as ``.npz`` files for the ranks."""
    d = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(30)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, (BATCH,))
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(jresnet.DEPTHS, 50, BLOCKS)
        model = jresnet.ResNetV2(depth=50, num_classes=CLASSES,
                                 dtype=jnp.float32)
        init = seeded_variables(model, x, seed=31)
    state = {k: v.numpy() for k, v in
             convert.flax_to_state_dict(init).items()}
    # the indivisible leg: 5 classes (mp 2 does not divide) on 6 images
    # (dp 4 does not divide), the same body
    odd = dict(state, **{"head.weight": state["head.weight"][:5],
                         "head.bias": state["head.bias"][:5]})
    paths = {name: str(d / f"{name}.npz") for name in
             ("weights", "batch", "odd_weights", "odd_batch")}
    np.savez(paths["weights"], **state)
    np.savez(paths["batch"], x=x, labels=labels)
    np.savez(paths["odd_weights"], **odd)
    np.savez(paths["odd_batch"], x=x[:6], labels=labels[:6] % 5)
    return {"init": init, "x": x, "labels": labels, "state": state,
            "odd": odd, **paths}


def _jax_step(inputs, mesh):
    """JAX's shard_train_step on ``mesh``: (loss, new variables, the
    gradients), the last two as state_dicts of numpy arrays; the gradient
    is the momentum trace after the first step."""
    tx = optax.sgd(1e-3, momentum=0.9)
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(jresnet.DEPTHS, 50, BLOCKS)
        model = jresnet.ResNetV2(depth=50, num_classes=CLASSES,
                                 dtype=jnp.float32)
        params = inputs["init"]["params"]
        state = {"params": params,
                 "batch_stats": inputs["init"]["batch_stats"],
                 "opt_state": tx.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        fn, state, x, labels = jh.shard_train_step(
            jh.make_train_fn(model, tx), mesh, state,
            jnp.asarray(inputs["x"]), jnp.asarray(inputs["labels"]))
        new, loss = fn(state, x, labels)
    assert int(new["step"]) == 1

    def state_dict(tree):
        return {k: v.numpy()
                for k, v in convert.flax_to_state_dict(_np(tree)).items()}
    return (float(loss), state_dict({"params": new["params"],
                                     "batch_stats": new["batch_stats"]}),
            state_dict({"params": new["opt_state"][0].trace}))


@pytest.fixture(scope="module")
def jax_steps(inputs):
    return {"2d": _jax_step(inputs, jh.make_mesh(N, mp=2)),
            "3d": _jax_step(inputs, jh.make_mesh_3d(N))}


@pytest.fixture(scope="module")
def gang_env():
    """The env the JAX control plane renders for gang member 0: the real
    scheduler places a 2-member gang on two v5e-16 hosts and the device
    plugin's ``gang_process_env`` renders it (the JAX dry run's gang leg,
    its ResNet step left out)."""
    envs = []
    real = japi.gang_process_env

    def capture(*args):
        envs.append(real(*args))
        return envs[-1]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(japi, "gang_process_env", capture)
        patch.setattr(graft, "_one_step", lambda jax, mesh: 0.0)
        bounds, _ = graft._one_gang_step(jax, N)
    assert envs[0][japi.TPU_PROCESS_BOUNDS] == bounds == "2,1,1"
    return envs[0]


@pytest.fixture(scope="module")
def ranks(inputs, gang_env):
    common = {"num_classes": CLASSES, "dtype": "float32",
              "blocks": BLOCKS, "weights": inputs["weights"],
              "inputs": inputs["batch"]}
    legs = [("resnet_step", dict(common, layout="2d", state_ranks=(0, 1))),
            ("resnet_step", dict(common, layout="3d", state_ranks=(0, 1))),
            ("resnet_step", dict(common, layout="gang", gang_env=gang_env,
                                 state_ranks=(0,))),
            ("resnet_step", dict(common, layout="2d", num_classes=5,
                                 weights=inputs["odd_weights"],
                                 inputs=inputs["odd_batch"],
                                 state_ranks=(0,)))]
    return dryrun.spawn(N, legs)


def _assert_step_close(got: dict, grads: dict, want: dict,
                       want_grads: dict, before: dict, tol: float) -> int:
    """Every gradient within ``tol`` of its own L2 norm; every parameter
    after the step within ``tol`` of its update's largest magnitude plus
    2 ulps of its fp32 value (an update of 1e-3 times a gradient sits near
    the rounding of a weight near 1, a BatchNorm scale's); every running
    statistic within ``tol`` of its largest magnitude. Returns the number
    of arrays checked."""
    checked = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        g = got[name].numpy()
        if name in want_grads:
            gw = want_grads[name]
            err = np.linalg.norm(grads[name].numpy() - gw)
            assert err <= tol * np.linalg.norm(gw), (name, err)
            update = np.abs(w - before[name]).max()
            floor = 2 * np.spacing(np.abs(w).astype(np.float32))
            assert np.all(np.abs(g - w) <= tol * update + floor), name
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=name)
        checked += 1
    return checked


@pytest.mark.parametrize("layout,mesh", [
    ("2d", {"dp": 4, "mp": 2}), ("3d", {"dp": 2, "fsdp": 2, "mp": 2})])
def test_sharded_step_matches_jax(ranks, jax_steps, inputs, layout, mesh):
    """The loss within 1e-5 relative on every rank, and every gradient,
    updated parameter (the head put together from the two mp ranks'
    columns) and running statistic within 1e-4 of JAX's (see
    :func:`_assert_step_close`)."""
    leg = ["2d", "3d"].index(layout)
    want_loss, want, want_grads = jax_steps[layout]
    for r in range(N):
        got = ranks[r][leg]
        assert got["mesh"] == mesh and got["step"] == 1
        assert got["loss"] == pytest.approx(want_loss, rel=1e-5)
        assert got["local_batch"] == BATCH // mesh["dp"]
    state, grads = (dict(ranks[0][leg][key]) for key in ("state", "grads"))
    for name in ("head.weight", "head.bias"):
        for got in (state, grads):
            key = "state" if got is state else "grads"
            got[name] = torch.cat([ranks[0][leg][key][name],
                                   ranks[1][leg][key][name]])
    assert _assert_step_close(state, grads, want, want_grads,
                              inputs["state"], 1e-4) == len(
        [n for n in want if not n.endswith("num_batches_tracked")])


def test_the_heads_local_shard_is_its_column_slice(ranks, jax_steps):
    """Rank 1 of the 2-D mesh (dp 0, mp 1) holds classes 4-7 of the head:
    the updated Flax kernel's columns 4:8, transposed."""
    want = jax_steps["2d"][1]
    got = ranks[1][0]["state"]
    assert tuple(got["head.weight"].shape) == (CLASSES // 2, 2048)
    np.testing.assert_allclose(got["head.weight"].numpy(),
                               want["head.weight"][4:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["head.bias"].numpy(),
                               want["head.bias"][4:], rtol=0, atol=1e-6)
    # the rest of the model is whole on every rank
    assert got["conv_root.weight"].shape == (64, 3, 7, 7)


def test_gang_leg_shapes_dp_from_the_rendered_bounds(ranks, jax_steps,
                                                     gang_env):
    """Fed the env the JAX control plane renders (process bounds 2,1,1:
    two member hosts), the gang leg puts the hosts on dp and each host's
    four local ranks on mp, and its step is JAX's step (the same global
    program on another mesh). The port's copy of ``gang_process_env``
    renders the same env."""
    for r in range(N):
        got = ranks[r][2]
        assert got["bounds"] == "2,1,1"
        assert got["mesh"] == {"dp": 2, "mp": 4}
        assert got["loss"] == pytest.approx(jax_steps["2d"][0], rel=1e-5)
    head = ranks[0][2]["state"]["head.weight"]
    assert tuple(head.shape) == (2, 2048)
    np.testing.assert_allclose(head.numpy(), jax_steps["2d"][1][
        "head.weight"][:2], rtol=0, atol=1e-6)
    assert tapi.gang_process_env(2, 0, gang_env[tapi.TPU_WORKER_HOSTNAMES]
                                 .split(","), 16) == gang_env


def test_indivisible_batch_and_head_replicate(ranks, inputs):
    """Batch 6 on dp 4 and 5 classes on mp 2, as
    ``test_shardings_degrade_on_indivisible_shapes`` holds for JAX: the
    batch and the head stay whole on every rank, and the step is the
    unsharded step (run here on the same weights)."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(tresnet.DEPTHS, 50, BLOCKS)
        model = tresnet.ResNetV2(depth=50, num_classes=5,
                                 dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in inputs["odd"].items()})
    step = th.make_train_fn(model, th.sgd(model))
    _, loss = step(th.init_train_state(model),
                   torch.from_numpy(inputs["x"][:6]),
                   torch.from_numpy(inputs["labels"][:6] % 5))
    for r in range(N):
        got = ranks[r][3]
        assert got["local_batch"] == 6 and got["mesh"] == {"dp": 4, "mp": 2}
        assert got["loss"] == pytest.approx(loss.item(), rel=1e-5)
    state = ranks[0][3]["state"]
    assert tuple(state["head.weight"].shape) == (5, 2048)
    for name, p in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[name].numpy(), p.numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
