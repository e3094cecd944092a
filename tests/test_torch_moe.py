"""Switch MoE and the MoE decoder: the PyTorch port against the JAX package,
on the CPU at tiny sizes.

The same seeded numpy weights (in the JAX tree ``{embed, layers: [{qkv,
proj, moe: {gate, w_in, w_out}}]}``, carried across by
``convert.moe_lm_params_to_state_dict``) and tokens go through both, in
fp32. JAX's single-device oracle (``mesh=None`` with ``shard_shape``) is
the reference; its flash path runs the Pallas kernel in interpret mode,
the port's the plain absorb under its ``autograd.Function``. Each case
states its tolerance: routing, the layer and the LM's bounds are those of
``tests/test_moe.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import decode as tdec
from k8s_device_plugin_torch.workloads import moe as tmoe
from k8s_device_plugin_tpu.workloads import decode as jdec
from k8s_device_plugin_tpu.workloads import moe as jmoe
from torch_support import one_torch_thread  # noqa: F401 (autouse)

DIM, HIDDEN, EXPERTS = 16, 32, 8
VOCAB, HEADS = 32, 4


def _moe_params(rng, dim=DIM, hidden=HIDDEN, experts=EXPERTS):
    def draw(shape, fan):
        return (rng.standard_normal(shape) / math.sqrt(fan)).astype(
            np.float32)
    return {"gate": draw((dim, experts), dim),
            "w_in": draw((experts, dim, hidden), dim),
            "w_out": draw((experts, hidden, dim), hidden)}


def _layer(params):
    layer = tmoe.MoE(DIM, HIDDEN, EXPERTS)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return layer


def _lm(layers=2, seed=0):
    """(JAX tree of numpy arrays, the port's MoELM holding them)."""
    rng = np.random.default_rng(seed)
    scale = 1 / math.sqrt(DIM)
    params = {
        "embed": (rng.standard_normal((VOCAB, DIM)) * scale).astype(
            np.float32),
        "layers": [{"qkv": (rng.standard_normal((DIM, 3 * DIM)) * scale
                            ).astype(np.float32),
                    "proj": (rng.standard_normal((DIM, DIM)) * scale
                             ).astype(np.float32),
                    "moe": _moe_params(rng, hidden=4 * DIM)}
                   for _ in range(layers)]}
    model = tmoe.MoELM(VOCAB, DIM, HEADS, layers, EXPERTS)
    model.load_state_dict(convert.moe_lm_params_to_state_dict(params))
    return params, model


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n_tok,capacity", [(12, 2), (16, 1), (12, 12)])
def test_route_matches_jax(n_tok, capacity):
    """dispatch, combine and aux at 1e-6; at capacity 1 and 2 tokens
    overflow their expert's queue and must be dropped (zero rows), not
    raise as F.one_hot would."""
    params = _moe_params(np.random.default_rng(0))
    x = _x((n_tok, DIM), seed=1)
    want = jax.jit(lambda x, g: jmoe._route(x, g, EXPERTS, capacity))(
        jnp.asarray(x), jnp.asarray(params["gate"]))
    got = tmoe._route(torch.from_numpy(x), torch.from_numpy(params["gate"]),
                      EXPERTS, capacity)
    for name, g, w in zip(("dispatch", "combine", "aux"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    assert got[0].shape == (n_tok, EXPERTS, capacity)
    per_token = got[0].sum(dim=(1, 2))
    assert ((per_token == 0) | (per_token == 1)).all()  # one slot at most
    if capacity < 3:
        assert per_token.sum() < n_tok  # some token was dropped


def test_moe_layer_dense_and_reference_match_jax_and_drop_overflow():
    """tests/test_moe.py's capacity case on 8 shards of 16 tokens: at
    capacity factor 0.01 (1 slot an expert) and 8.0, the layer and the
    oracle against JAX's at 1e-5; the tight run drops tokens the roomy one
    keeps."""
    params = _moe_params(np.random.default_rng(0))
    layer = _layer(params)
    x = _x((8, 16, DIM), seed=2)
    outs = {}
    for cf in (0.01, 8.0):
        want, aux_want = jax.jit(lambda x, p: jmoe.moe_reference(
            x, p, capacity_factor=cf))(jnp.asarray(x), params)
        got, aux_got = tmoe.moe_reference(torch.from_numpy(x), layer,
                                          capacity_factor=cf)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(aux_got.item(), float(aux_want),
                                   atol=1e-5, rtol=1e-5)
        one, aux_one = tmoe.moe_layer_dense(torch.from_numpy(x[3]), layer,
                                            capacity_factor=cf)
        want_one, aux_want_one = jax.jit(lambda x, p: jmoe.moe_layer_dense(
            x, p, capacity_factor=cf))(jnp.asarray(x[3]), params)
        np.testing.assert_allclose(one.detach().numpy(),
                                   np.asarray(want_one), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(aux_one.item(), float(aux_want_one),
                                   atol=1e-5, rtol=1e-5)
        outs[cf] = got.detach().numpy()
    tight, roomy = outs[0.01], outs[8.0]
    assert not np.allclose(tight, roomy)
    assert (np.any(tight != 0, -1).sum() < np.any(roomy != 0, -1).sum())


@pytest.mark.parametrize("shard_shape", [(1, 1), (2, 4), (1, 2), (2, 1)])
def test_moe_lm_forward_matches_jax(shard_shape):
    """Logits at 1e-4 and the mean aux at 1e-5 (tests/test_moe.py's
    bounds) on [2, 16] tokens, routed in the (dp, sp) blocks of
    ``shard_shape``."""
    params, model = _lm()
    tokens = np.random.default_rng(1).integers(0, VOCAB, (2, 16))
    want, aux_want = jax.jit(lambda p, t: jmoe.moe_lm_forward(
        p, t, heads=HEADS, shard_shape=shard_shape))(params,
                                                     jnp.asarray(tokens))
    with torch.no_grad():
        got, aux_got = tmoe.moe_lm_forward(model, torch.from_numpy(tokens),
                                           shard_shape=shard_shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(aux_got.item(), float(aux_want), atol=1e-5,
                               rtol=1e-5)


def _grads_match(params, model, tokens, use_flash, shard_shape):
    """moe_lm_loss and every parameter's gradient against JAX's: the loss
    at 1e-5, the gradients at atol 1e-4 / rtol 1e-3 (tests/test_moe.py)."""
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmoe.moe_lm_loss(
        p, jnp.asarray(tokens), heads=HEADS, shard_shape=shard_shape,
        use_flash=use_flash, flash_interpret=True)))(params)
    got = tmoe.moe_lm_loss(model, torch.from_numpy(tokens),
                           shard_shape=shard_shape, use_flash=use_flash)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=1e-5,
                               rtol=1e-5)
    want = convert.moe_lm_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("shard_shape", [(1, 1), (2, 4)])
def test_moe_lm_loss_gradients_match_jax(shard_shape):
    params, model = _lm()
    tokens = np.random.default_rng(3).integers(0, VOCAB, (2, 17))
    _grads_match(params, model, tokens, False, shard_shape)


def test_moe_lm_flash_path_matches_jax_flash():
    """The flash path: on the CPU the port runs the plain absorb under
    flash._Absorb, one whole-sequence absorb a layer (no chunking, as the
    JAX moe_lm_loss passes none), against JAX's Pallas kernel interpreted
    under its custom VJP; loss and gradients at the bounds above."""
    params, model = _lm(layers=1)
    tokens = np.random.default_rng(4).integers(0, VOCAB, (2, 9))
    _grads_match(params, model, tokens, True, (2, 2))


def test_moe_generate_matches_jax_and_the_dropfree_recompute():
    """tests/test_decode.py's case (vocab 32, dim 16, heads 4, 2 layers, 8
    experts, prompt [2, 5], 6 tokens): greedy serving through the cache,
    token for token against JAX's moe_generate and against the port's
    from-scratch moe_lm_forward at drop-free capacity."""
    params, model = _lm()
    prompt = np.random.default_rng(5).integers(0, VOCAB, (2, 5))
    got = tdec.moe_generate(model, torch.from_numpy(prompt), steps=6)
    assert tuple(got.shape) == (2, 11)
    want = jax.jit(lambda p, t: jdec.moe_generate(p, t, steps=6,
                                                  heads=HEADS))(
        params, jnp.asarray(prompt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    recompute = tdec.reference_generate(
        model, torch.from_numpy(prompt), steps=6,
        forward=lambda p, t: tmoe.moe_lm_forward(
            p, t, capacity_factor=float(EXPERTS))[0])
    np.testing.assert_array_equal(got.numpy(), recompute.numpy())


def test_init_is_seeded_scaled_and_the_mesh_is_not_ported():
    """init_moe_lm_params: the JAX layout and scales (1/sqrt(dim), w_out
    1/sqrt(hidden)), the same weights from the same seed, no MLP. The
    expert-parallel layer is ported now (``test_torch_ep_pp.py`` holds it
    against JAX on 8 ranks): on a world of one, ``moe_layer`` over its
    group is the dense layer, and the MoE LM on a (1, 1) mesh is the
    oracle with ``shard_shape=(1, 1)``."""
    def build():
        return tmoe.init_moe_lm_params(torch.Generator().manual_seed(0),
                                       512, 64, 4, 2, n_experts=8,
                                       hidden=1024, device="cpu")
    model = build()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {"embed": (512, 64), **{
        f"layers.{i}.{n}": s for i in range(2) for n, s in (
            ("qkv", (64, 192)), ("proj", (64, 64)),
            ("moe.gate", (64, 8)), ("moe.w_in", (8, 64, 1024)),
            ("moe.w_out", (8, 1024, 64)))}}
    for name, p in model.named_parameters():
        want = 1024 ** -0.5 if name.endswith("w_out") else 64 ** -0.5
        assert abs(p.std().item() / want - 1) < 0.1, name
    for a, b in zip(model.parameters(), build().parameters()):
        assert torch.equal(a, b)
    assert model.layers[0].mlp_in is None
    from k8s_device_plugin_torch.workloads import harness, run
    x = torch.randn(12, 64, generator=torch.Generator().manual_seed(6))
    tokens = torch.randint(0, 512, (2, 8),
                           generator=torch.Generator().manual_seed(7))
    with torch.no_grad(), run.world(torch.device("cpu")):
        mesh = harness.device_mesh((1, 1), ("dp", "sp"))
        got = tmoe.moe_layer(x, model.layers[0].moe, mesh.get_group("sp"))
        logits, aux = tmoe.moe_lm_forward(model, tokens, mesh)
    want = tmoe.moe_layer_dense(x, model.layers[0].moe)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        want = tmoe.moe_lm_forward(model, tokens, shard_shape=(1, 1))
    torch.testing.assert_close(logits, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux, want[1], rtol=1e-6, atol=1e-6)
