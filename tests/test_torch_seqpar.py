"""The port's sequence parallelism on 8 CPU ranks over gloo against the
JAX package's on the 8-device CPU mesh (``tests/conftest.py``).

* Attention: the ring (plain, and through the flash absorb, whose CPU
  version is K3's plain one) and Ulysses, causal and not, MHA (8 heads)
  and GQA (2 K/V heads), at sp 2, 4 and 8 on a (8 / sp, sp) mesh, each
  rank's block held against JAX's ``ring_attention`` under ``shard_map``
  at 1e-5, the bound of ``tests/test_attention.py``.
* The LM's train step of the JAX dry run (``_one_sp_step``'s recipe:
  vocab 64, dim 32, 4 heads, 2 layers, fp32, tokens [8 / sp, 4 sp + 1],
  the weights and tokens JAX draws, carried across): the losses of the
  sp 2, 4 and 8 ring legs and of the sp 4 flash, Ulysses and GQA legs
  against JAX's at 1e-5 relative, and ``lm_loss``'s gradients at sp 4
  against ``jax.grad`` of JAX's ``lm_loss`` on the mesh at 1e-4 of each
  norm (the flash leg against the plain ring's: the absorb computes the
  same function, and JAX's flash leg loses nothing to it).
* ``dryrun_lines`` prints these legs in the JAX dry run's lines.

One spawn of 8 ranks per module (the ``ranks`` fixture, through
``dryrun.spawn``) runs every leg; each test asserts on its cached results.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from k8s_device_plugin_torch import dryrun
from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_tpu.workloads import attention as jatt
from k8s_device_plugin_tpu.workloads.compat import shard_map

N = 8
SPS = (2, 4, 8)
IMPLS = ("ring", "flash", "ulysses")
#: (causal, the k/v suffix: "" 8 heads, "_gqa" 2 heads)
VARIANTS = [(causal, kv) for causal in (True, False) for kv in ("", "_gqa")]
#: the LM legs: (label, sp, sp_step kwargs)
LM_LEGS = [("sp2", 2, {}), ("sp4", 4, {}), ("sp8", 8, {}),
           ("sp+flash", 4, {"use_flash": True}),
           ("sp-ulysses", 4, {"seq_mode": "ulysses"}),
           ("sp+gqa", 4, {"kv_heads": 2})]


def _mesh(sp):
    return Mesh(np.array(jax.devices()[:N]).reshape(N // sp, sp),
                ("dp", "sp"))


@pytest.fixture(scope="module")
def qkv(tmp_path_factory):
    rng = np.random.default_rng(40)
    b, t, h, d = 4, 32, 8, 8
    arrays = {"q": rng.standard_normal((b, t, h, d)),
              "k": rng.standard_normal((b, t, h, d)),
              "v": rng.standard_normal((b, t, h, d)),
              "k_gqa": rng.standard_normal((b, t, 2, d)),
              "v_gqa": rng.standard_normal((b, t, 2, d))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    path = str(tmp_path_factory.mktemp("seqpar") / "qkv.npz")
    np.savez(path, **arrays)
    return arrays, path


def _lm_params(kv_heads):
    """The weights ``__graft_entry__._one_sp_step`` draws."""
    return jatt.init_lm_params(jax.random.PRNGKey(0), vocab=64, dim=32,
                               heads=4, layers=2, kv_heads=kv_heads)


def _lm_tokens(sp):
    """The tokens ``__graft_entry__._one_sp_step`` draws at ``sp``."""
    return jax.random.randint(jax.random.PRNGKey(1), (N // sp, 4 * sp + 1),
                              0, 64)


@pytest.fixture(scope="module")
def jax_inputs():
    """{label: (JAX params, tokens)} of the LM legs (the weights drawn once
    a layout: every leg but GQA's has the same)."""
    params = {kv: _lm_params(kv) for kv in (None, 2)}
    return {label: (params[kwargs.get("kv_heads")], _lm_tokens(sp))
            for label, sp, kwargs in LM_LEGS}


@pytest.fixture(scope="module")
def lm_inputs(tmp_path_factory, jax_inputs):
    """{label: (weights path, tokens path)} for the LM legs."""
    d = tmp_path_factory.mktemp("seqpar_lm")
    out = {}
    for label, (params, tokens) in jax_inputs.items():
        w, t = str(d / f"{label}_w.npz"), str(d / f"{label}_t.npz")
        np.savez(w, **{k: v.numpy() for k, v in
                       convert.lm_params_to_state_dict(
                           jax.tree.map(np.asarray, params)).items()})
        np.savez(t, tokens=np.asarray(tokens))
        out[label] = (w, t)
    return out


@pytest.fixture(scope="module")
def ranks(qkv, lm_inputs):
    _, path = qkv
    legs = [("attention_blocks", {"sp": sp, "inputs": path, "cases": [
        (impl, causal, kv) for impl in IMPLS for causal, kv in VARIANTS]})
        for sp in SPS]
    legs += [("sp_step", dict(kwargs, sp=sp, weights=lm_inputs[label][0],
                              inputs=lm_inputs[label][1], grads=sp == 4))
             for label, sp, kwargs in LM_LEGS]
    return dryrun.spawn(N, legs)


@pytest.fixture(scope="module")
def jax_attention(qkv):
    """JAX's ring under shard_map, [sp][variant] -> the whole output, all
    in one jit."""
    arrays, _ = qkv
    spec = P("dp", "sp", None, None)

    def every_variant(q, k, v, kg, vg):
        return {sp: [shard_map(functools.partial(jatt.ring_attention,
                                                 causal=causal),
                               mesh=_mesh(sp), in_specs=(spec,) * 3,
                               out_specs=spec)(
            q, *((k, v) if kv == "" else (kg, vg)))
            for causal, kv in VARIANTS] for sp in SPS}
    out = jax.jit(every_variant)(*(jnp.asarray(arrays[n]) for n in (
        "q", "k", "v", "k_gqa", "v_gqa")))
    return {sp: [np.asarray(o) for o in outs] for sp, outs in out.items()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sp", SPS)
def test_attention_matches_jax_shard_map(ranks, jax_attention, sp, impl):
    """Every rank's [B/dp, T/sp] block, causal and not, MHA and GQA,
    within 1e-5 of JAX's ring on the same mesh."""
    leg = SPS.index(sp)
    b_loc, t_loc = 4 * sp // N, 32 // sp
    for r in range(N):
        i, j = divmod(r, sp)  # the (dp, sp) mesh in rank order
        outs = ranks[r][leg]
        for v, (causal, kv) in enumerate(VARIANTS):
            got = outs[IMPLS.index(impl) * len(VARIANTS) + v].numpy()
            want = jax_attention[sp][v][i * b_loc:(i + 1) * b_loc,
                                        j * t_loc:(j + 1) * t_loc]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {causal} {kv}")


def _jax_loss_fn(sp, kwargs):
    mesh = _mesh(sp)
    return lambda p, t: jatt.lm_loss(
        p, t, mesh=mesh, heads=4, seq_mode=kwargs.get("seq_mode", "ring"))


@pytest.fixture(scope="module")
def jax_lm(jax_inputs):
    """{label: loss} for every LM leg, and {label: grads} (a state_dict
    of numpy arrays) for the sp 4 legs but flash (whose JAX value is the
    plain ring's), all in one jit."""
    legs = [(label, sp, kwargs) for label, sp, kwargs in LM_LEGS
            if label != "sp+flash"]
    inputs = {label: jax_inputs[label] for label, _, _ in legs}

    def every_leg(inputs):
        return {label: (jax.value_and_grad if sp == 4 else
                        lambda f: f)(_jax_loss_fn(sp, kwargs))(
            *inputs[label]) for label, sp, kwargs in legs}
    out = jax.jit(every_leg)(inputs)
    losses, grads = {}, {}
    for label, sp, _ in legs:
        if sp == 4:
            loss, g = out[label]
            grads[label] = {k: v.numpy() for k, v in
                            convert.lm_params_to_state_dict(
                                jax.tree.map(np.asarray, g)).items()}
        else:
            loss = out[label]
        losses[label] = float(loss)
    losses["sp+flash"], grads["sp+flash"] = losses["sp4"], grads["sp4"]
    return losses, grads


@pytest.mark.parametrize("label", [leg[0] for leg in LM_LEGS])
def test_lm_legs_match_jax(ranks, jax_lm, label):
    """The loss on every rank within 1e-5 of JAX's, and at sp 4 every
    weight's gradient (summed over the world) within 1e-4 of its norm."""
    leg = len(SPS) + [lg[0] for lg in LM_LEGS].index(label)
    sp = LM_LEGS[leg - len(SPS)][1]
    losses, grads = jax_lm
    for r in range(N):
        got = ranks[r][leg]
        assert got["mesh"] == {"dp": N // sp, "sp": sp}
        assert got["loss"] == pytest.approx(losses[label], rel=1e-5)
    if sp != 4:
        return
    got = ranks[0][leg]["grads"]
    assert sorted(got) == sorted(grads[label])
    for name, want in grads[label].items():
        err = np.linalg.norm(got[name].numpy() - want)
        assert err <= 1e-4 * np.linalg.norm(want), (name, err)


def test_dry_run_lines_name_every_leg(ranks):
    """``dryrun_legs`` orders the legs as the JAX dry run does and
    ``dryrun_lines`` prints them in its format, finite losses only."""
    names = [name for name, _ in dryrun.dryrun_legs(N)]
    assert names == ["", " 3d", " sp", " sp", " sp", " sp+flash",
                     " sp-ulysses", " sp+gqa", " ep", " pp",
                     " sp+ep (moe-lm)", " gang"]
    results = [r for r in ranks[0][len(SPS):]]
    lines = dryrun.dryrun_lines(names[2:8], results)
    assert lines[0].startswith("dryrun_multichip sp ok: mesh={'dp': 4, "
                               "'sp': 2} loss=")
    assert lines[3].startswith("dryrun_multichip sp+flash ok: mesh="
                               "{'dp': 2, 'sp': 4} loss=")
    with pytest.raises(AssertionError, match="not finite|nan"):
        dryrun.dryrun_lines([" sp"], [dict(results[0], loss=float("nan"))])
