"""The port's expert parallelism, the MoE LM over a mesh and the pipeline,
on 8 CPU ranks over gloo, against the JAX package's on its 8-device CPU
mesh (``tests/conftest.py``), on the same weights and inputs drawn with
numpy.

* The Switch layer (dim 16, hidden 32, 8 experts, x [8, 12, 16]) through
  ``moe_forward`` at (dp, ep) = (2, 4), (1, 8) and (4, 2): every rank's
  block and the aux against JAX's ``moe_forward`` and against the port's
  dense ``moe_reference``, at 1e-5 (``tests/test_moe.py``); ``moe_loss``'s
  gradients at (2, 4), the gate and every rank's expert slice, at 1e-5
  absolute and 1e-4 relative; and the capacity-overflow case of
  ``tests/test_moe.py`` (16 tokens a shard, capacity factor 0.01 and 8).
* The MoE LM of the JAX dry run (vocab 64, dim 16, 4 heads, 2 layers, 8
  experts, tokens [2, 17]) at sp 4, ring and Ulysses: the loss at 1e-5
  against JAX's ``moe_lm_loss`` on the mesh in the same mode, and the
  gradients, the experts' by rank, at 1e-4 absolute and 1e-3 relative,
  against ``jax.grad`` of its ring loss (``tests/test_moe.py``'s bounds).
* The pipeline (dim 16, hidden 32) at (dp, pp, M) = (2, 4, 6), (1, 8, 8)
  and (4, 2, 3) with 8 tokens a microbatch, and the all-bubble M = 1 on pp
  8 with 4: every rank's outputs at 1e-5 (``tests/test_pipeline.py``)
  and its stage's gradients at 1e-4 of their norm, and at (2, 4, 6) at
  1e-5 absolute and 1e-4 relative (``tests/test_pipeline.py``'s gradient
  case), against JAX's ``pipeline_forward`` and ``jax.grad`` of
  ``pipeline_loss``.
* ``dryrun_legs`` adds the JAX dry run's ep, pp and sp+ep (moe-lm) lines.

One spawn of 8 ranks for the module (the ``ranks`` fixture, through
``dryrun.spawn``) runs every leg, and one jit runs every JAX case; each
test asserts on the cached results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from k8s_device_plugin_torch import dryrun
from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import moe as tmoe
from k8s_device_plugin_tpu.workloads import moe as jmoe
from k8s_device_plugin_tpu.workloads import pipeline as jpipe
from torch_support import one_torch_thread  # noqa: F401 (autouse)

N = 8
DIM, HIDDEN, EXPERTS = 16, 32, 8
#: (dp, ep) of the Switch layer's forward cases
EP_MESHES = [(2, 4), (1, 8), (4, 2)]
#: capacity factors of the overflow case: one slot an expert, and room
TIGHT, ROOMY = 0.01, 8.0
#: (dp, pp, microbatches, tokens a microbatch)
PP_CASES = [(2, 4, 6, 8), (1, 8, 8, 8), (4, 2, 3, 8), (1, 8, 1, 4)]
LM_MODES = ("ring", "ulysses")
LM_VOCAB, LM_DIM, LM_HEADS, LM_LAYERS, LM_SP = 64, 16, 4, 2, 4


def _mesh(dp, n, name):
    return Mesh(np.array(jax.devices()[:dp * n]).reshape(dp, n),
                ("dp", name))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _moe_params(rng, dim, hidden, experts):
    """A Switch layer's weights at the JAX init's scales."""
    return {"gate": _normal(rng, (dim, experts), dim ** -0.5),
            "w_in": _normal(rng, (experts, dim, hidden), dim ** -0.5),
            "w_out": _normal(rng, (experts, hidden, dim), hidden ** -0.5)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(70)
    moe = _moe_params(rng, DIM, HIDDEN, EXPERTS)
    x = _normal(rng, (N, 12, DIM))
    lm = {"embed": _normal(rng, (LM_VOCAB, LM_DIM), LM_DIM ** -0.5),
          "layers": [{"qkv": _normal(rng, (LM_DIM, 3 * LM_DIM),
                                     LM_DIM ** -0.5),
                      "proj": _normal(rng, (LM_DIM, LM_DIM), LM_DIM ** -0.5),
                      "moe": _moe_params(rng, LM_DIM, 4 * LM_DIM,
                                         2 * LM_SP)}
                     for _ in range(LM_LAYERS)]}
    pp = {}
    for dp, stages, m, b in PP_CASES:
        pp[(dp, stages, m)] = (
            {"w_in": _normal(rng, (stages, DIM, HIDDEN), DIM ** -0.5),
             "w_out": _normal(rng, (stages, HIDDEN, DIM), HIDDEN ** -0.5)},
            _normal(rng, (m, b, DIM)), _normal(rng, (m, b, DIM)))
    return {"moe": moe, "x": x, "targets": _normal(rng, x.shape),
            "x16": _normal(rng, (N, 16, DIM)), "lm": lm,
            "tokens": rng.integers(0, LM_VOCAB, (N // LM_SP, 4 * LM_SP + 1)),
            "pp": pp}


@pytest.fixture(scope="module")
def files(tmp_path_factory, data):
    """The weights and inputs as ``.npz`` files for the ranks."""
    d = tmp_path_factory.mktemp("ep_pp")

    def save(name, arrays):
        path = str(d / f"{name}.npz")
        np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
        return path
    out = {"moe": save("moe", convert.moe_params_to_state_dict(data["moe"])),
           "x": save("x", {"x": data["x"], "targets": data["targets"]}),
           "x16": save("x16", {"x": data["x16"], "targets": data["x16"]}),
           "lm": save("lm", convert.moe_lm_params_to_state_dict(data["lm"])),
           "tokens": save("tokens", {"tokens": data["tokens"]})}
    for key, (params, x, t) in data["pp"].items():
        out[key] = (save(f"pp{key}", convert.stage_params_to_state_dict(
            params)), save(f"pp{key}_x", {"x": x, "targets": t}))
    return out


#: the legs of the spawn, in order: (label, leg)
def _legs(files):
    legs = [(f"ep{dp}x{ep}", ("ep_step", {
        "ep": ep, "weights": files["moe"], "inputs": files["x"],
        "grads": (dp, ep) == (2, 4)})) for dp, ep in EP_MESHES]
    legs += [(f"cap{cf}", ("ep_step", {
        "ep": 8, "weights": files["moe"], "inputs": files["x16"],
        "capacity_factor": cf})) for cf in (TIGHT, ROOMY)]
    legs += [(f"lm-{mode}", ("moe_lm_step", {
        "sp": LM_SP, "seq_mode": mode, "weights": files["lm"],
        "inputs": files["tokens"], "grads": True})) for mode in LM_MODES]
    legs += [(f"pp{dp}x{pp}x{m}", ("pp_step", {
        "pp": pp, "weights": files[(dp, pp, m)][0],
        "inputs": files[(dp, pp, m)][1], "grads": True}))
        for dp, pp, m, _ in PP_CASES]
    # the dry run's own legs (its weights and inputs)
    legs += [(f"dryrun{name}", leg)
             for name, leg in dryrun.dryrun_legs(N)
             if leg[0] in ("ep_step", "pp_step", "moe_lm_step")]
    return legs


@pytest.fixture(scope="module")
def ranks(files):
    """{label: [rank 0's result, ..., rank 7's]}."""
    legs = _legs(files)
    results = dryrun.spawn(N, [leg for _, leg in legs])
    return {label: [results[r][i] for r in range(N)]
            for i, (label, _) in enumerate(legs)}


@pytest.fixture(scope="module")
def jax_out(data):
    """Every JAX case in one jit: the Switch layer's outputs and aux by
    mesh and capacity, ``moe_loss``'s gradients at (2, 4), the MoE LM's
    loss and gradients by mode, and each pipeline case's outputs, loss and
    gradients (the loss of ``pipeline_loss``, the MSE of
    ``pipeline_forward``, with the outputs as its aux)."""
    x, x16 = jnp.asarray(data["x"]), jnp.asarray(data["x16"])
    tgt, tokens = jnp.asarray(data["targets"]), jnp.asarray(data["tokens"])
    lm_mesh = _mesh(N // LM_SP, LM_SP, "sp")

    def every_case(moe, lm, pp):
        out = {f"ep{dp}x{ep}": jmoe.moe_forward(x, moe, _mesh(dp, ep, "ep"))
               for dp, ep in EP_MESHES}
        out.update({f"cap{cf}": jmoe.moe_forward(
            x16, moe, _mesh(1, 8, "ep"), capacity_factor=cf)
            for cf in (TIGHT, ROOMY)})
        out["moe_grads"] = jax.grad(lambda p: jmoe.moe_loss(
            p, x, tgt, _mesh(2, 4, "ep")))(moe)
        # Ulysses computes the ring's function (tests/test_moe.py holds
        # JAX's two losses equal): its gradients are held to the ring's
        out["lm-ring"] = jax.value_and_grad(lambda p: jmoe.moe_lm_loss(
            p, tokens, mesh=lm_mesh, heads=LM_HEADS))(lm)
        out["lm-ulysses"] = (jmoe.moe_lm_loss(
            lm, tokens, mesh=lm_mesh, heads=LM_HEADS, seq_mode="ulysses"),
            out["lm-ring"][1])
        for dp, stages, m, _ in PP_CASES:
            params, xm, tm = pp[f"{dp}x{stages}x{m}"]
            mesh = _mesh(dp, stages, "pp")

            def loss(p, xm=xm, tm=tm, mesh=mesh):
                # pipeline_loss's body, with the forward it takes the MSE
                # of as the aux (one compiled pipeline a case, not two)
                y = jpipe.pipeline_forward(p, xm, mesh)
                return jnp.mean((y - tm) ** 2), y
            (value, y), grads = jax.value_and_grad(loss, has_aux=True)(
                params)
            out[f"pp{dp}x{stages}x{m}"] = (y, (value, grads))
        return out
    pp = {f"{dp}x{stages}x{m}": data["pp"][(dp, stages, m)]
          for dp, stages, m, _ in PP_CASES}
    out = jax.jit(every_case)(data["moe"], data["lm"], pp)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("dp,ep", EP_MESHES)
def test_moe_forward_matches_jax_and_the_dense_reference(ranks, jax_out,
                                                         data, dp, ep):
    """Every rank's [1, 12, 16] block (rank r holds shard r: the shards
    split dp-major) and the aux within 1e-5 of JAX's ``moe_forward`` on
    the same mesh and of the port's ``moe_reference``."""
    got = ranks[f"ep{dp}x{ep}"]
    want, want_aux = jax_out[f"ep{dp}x{ep}"]
    module = tmoe.MoE(DIM, HIDDEN, EXPERTS)
    module.load_state_dict(convert.moe_params_to_state_dict(data["moe"]))
    with torch.no_grad():
        ref, ref_aux = tmoe.moe_reference(torch.from_numpy(data["x"]),
                                          module)
    for r in range(N):
        assert got[r]["mesh"] == {"dp": dp, "ep": ep}
        block = got[r]["out"].numpy()
        np.testing.assert_allclose(block, want[r:r + 1],
                                   atol=1e-5, rtol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(block, ref[r:r + 1].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"rank {r}")
        assert got[r]["aux"] == pytest.approx(float(want_aux), abs=1e-5,
                                              rel=1e-5)
        assert got[r]["aux"] == pytest.approx(ref_aux.item(), abs=1e-5,
                                              rel=1e-5)


def test_moe_loss_gradients_match_jax(ranks, jax_out):
    """At (2, 4), the gate's gradient (summed over the world) on every
    rank and each rank's slice of the experts' (summed over dp) against
    ``jax.grad`` of JAX's ``moe_loss``; the losses agree too."""
    got = ranks["ep2x4"]
    want = jax_out["moe_grads"]
    e_loc = EXPERTS // 4
    for r in range(N):
        j = r % 4  # the rank's ep index
        g = got[r]["grads"]
        np.testing.assert_allclose(g["gate"].numpy(), want["gate"],
                                   atol=1e-5, rtol=1e-4)
        for name in ("w_in", "w_out"):
            assert g[name].shape[0] == e_loc
            np.testing.assert_allclose(
                g[name].numpy(), want[name][j * e_loc:(j + 1) * e_loc],
                atol=1e-5, rtol=1e-4, err_msg=f"rank {r} {name}")
        assert got[r]["loss"] == got[0]["loss"]


def test_moe_capacity_drops_overflow(ranks, jax_out):
    """Capacity 1 slot an expert (cf 0.01 on 16 tokens) against a roomy
    one (cf 8): each matches JAX's, the tight run really dropped tokens,
    and it keeps no more tokens than the roomy run."""
    tight = np.concatenate([r["out"].numpy() for r in ranks[f"cap{TIGHT}"]])
    roomy = np.concatenate([r["out"].numpy() for r in ranks[f"cap{ROOMY}"]])
    np.testing.assert_allclose(tight, jax_out[f"cap{TIGHT}"][0], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(roomy, jax_out[f"cap{ROOMY}"][0], atol=1e-5,
                               rtol=1e-5)
    assert not np.allclose(tight, roomy)
    assert np.any(tight != 0, axis=-1).sum() \
        <= np.any(roomy != 0, axis=-1).sum()


@pytest.mark.parametrize("mode", LM_MODES)
def test_moe_lm_on_the_mesh_matches_jax(ranks, jax_out, mode):
    """The MoE LM at (dp, sp) = (2, 4): the loss on every rank within 1e-5
    of JAX's ``moe_lm_loss`` on the mesh in the same mode, and every
    gradient (the attention weights and the gates summed over the world,
    each rank's experts over dp) within 1e-4 absolute and 1e-3 relative of
    ``jax.grad`` of JAX's ring loss (Ulysses computes the same function,
    as ``tests/test_moe.py`` holds for the losses)."""
    got = ranks[f"lm-{mode}"]
    loss, grads = jax_out[f"lm-{mode}"]
    want = {k: v.numpy() for k, v in
            convert.moe_lm_params_to_state_dict(grads).items()}
    e_loc = 2 * LM_SP // LM_SP
    for r in range(N):
        assert got[r]["mesh"] == {"dp": N // LM_SP, "sp": LM_SP}
        assert got[r]["loss"] == pytest.approx(float(loss), abs=1e-5,
                                               rel=1e-5)
        j = r % LM_SP
        g = got[r]["grads"]
        assert sorted(g) == sorted(want)
        for name, w in want.items():
            if name.endswith(("w_in", "w_out")):
                w = w[j * e_loc:(j + 1) * e_loc]
            np.testing.assert_allclose(g[name].numpy(), w, atol=1e-4,
                                       rtol=1e-3, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("dp,pp,m,b", PP_CASES)
def test_pipeline_matches_jax(ranks, jax_out, dp, pp, m, b):
    """Every rank's [M, B/dp, 16] outputs within 1e-5 of JAX's
    ``pipeline_forward`` (M = 1 on pp 8 is all bubble but one pass), the
    loss within 1e-5, and each rank's stage gradients (summed over dp)
    against ``jax.grad`` of ``pipeline_loss``: within 1e-4 of each
    gradient's norm, and at (2, 4, 6), the case ``tests/test_pipeline.py``
    takes gradients of, within its 1e-5 absolute and 1e-4 relative. (On
    pp 8 one element in 512 of a stage's gradient, through 8 stages of
    fp32 products summed in another order than XLA's, sits 1.3e-5 from
    JAX's.)"""
    got = ranks[f"pp{dp}x{pp}x{m}"]
    out, (loss, grads) = jax_out[f"pp{dp}x{pp}x{m}"]
    b_loc = b // dp
    for r in range(N):
        i, s = divmod(r, pp)  # the (dp, pp) mesh in rank order
        assert got[r]["mesh"] == {"dp": dp, "pp": pp}
        np.testing.assert_allclose(got[r]["out"].numpy(),
                                   out[:, i * b_loc:(i + 1) * b_loc],
                                   atol=1e-5, rtol=1e-5, err_msg=f"rank {r}")
        assert got[r]["loss"] == pytest.approx(float(loss), abs=1e-5,
                                               rel=1e-5)
        for name in ("w_in", "w_out"):
            g, want = got[r]["grads"][name].numpy(), grads[name][s:s + 1]
            err = np.linalg.norm(g - want)
            assert err <= 1e-4 * np.linalg.norm(want), (r, name, err)
            if (dp, pp, m) == (2, 4, 6):
                np.testing.assert_allclose(g, want, atol=1e-5, rtol=1e-4,
                                           err_msg=f"rank {r} {name}")


def test_dry_run_prints_the_ep_pp_and_moe_lm_lines(ranks):
    """``dryrun_legs`` puts ep, pp and sp+ep (moe-lm) between sp+gqa and
    gang, as the JAX dry run does, and ``dryrun_lines`` prints them in its
    format with finite losses from the legs' own weights and inputs."""
    names = [name for name, _ in dryrun.dryrun_legs(N)]
    assert names[-4:] == [" ep", " pp", " sp+ep (moe-lm)", " gang"]
    results = [ranks[f"dryrun{name}"][0] for name in names[-4:-1]]
    lines = dryrun.dryrun_lines(names[-4:-1], results)
    assert lines[0].startswith("dryrun_multichip ep ok: mesh={'dp': 2, "
                               "'ep': 4} loss=")
    assert lines[1].startswith("dryrun_multichip pp ok: mesh={'dp': 2, "
                               "'pp': 4} loss=")
    assert lines[2].startswith("dryrun_multichip sp+ep (moe-lm) ok: mesh="
                               "{'dp': 2, 'sp': 4} loss=")
    for leg in names[-4:-1]:
        losses = {r["loss"] for r in ranks[f"dryrun{leg}"]}
        assert len(losses) == 1 and np.isfinite(losses.pop())
