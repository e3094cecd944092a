"""The long-context LM: the PyTorch port against the JAX package.

The JAX LM's parameters (numpy) are carried into the port's ``LM`` with
``convert.lm_params_to_state_dict``, and the same seeded tokens go through
both, at the small shapes of ``tests/test_attention.py`` (vocab 32,
dim 16, heads 4, layers 2) and its LM tolerance, 1e-4. JAX's flash path
runs the Pallas kernel in interpret mode; the port's runs the plain absorb
(the CUDA kernel is held against it on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.workloads import attention as tatt
from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_tpu.workloads import attention as jatt
from torch_support import one_torch_thread  # noqa: F401 (autouse)

VOCAB, DIM, HEADS, LAYERS = 32, 16, 4, 2
TOL = 1e-4  # tests/test_attention.py's LM tolerance


def _f32(a):
    return np.asarray(a, np.float32)


def _models(kv_heads=None, seed=0, dtype=torch.float32):
    params = jatt.init_lm_params(jax.random.PRNGKey(seed), VOCAB, DIM,
                                 HEADS, LAYERS, kv_heads=kv_heads)
    params = jax.tree.map(_f32, params)
    model = tatt.LM(VOCAB, DIM, HEADS, LAYERS, dtype=dtype,
                    kv_heads=kv_heads)
    model.load_state_dict(convert.lm_params_to_state_dict(params))
    return params, model.eval()


def _tokens(b=2, t=16, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t))


@pytest.mark.parametrize("use_rope", [False, True])
@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("use_flash", [True, False])
def test_lm_forward_matches_jax(use_flash, kv_heads, use_rope):
    params, model = _models(kv_heads)
    tokens = _tokens()
    with torch.no_grad():
        got = tatt.lm_forward(model, torch.from_numpy(tokens),
                              use_flash=use_flash, use_rope=use_rope)
    assert got.shape == (2, 16, VOCAB)
    for jax_flash in (True, False):
        want = jatt.lm_forward(params, jnp.asarray(tokens), heads=HEADS,
                               use_flash=jax_flash, flash_interpret=True,
                               use_rope=use_rope)
        np.testing.assert_allclose(got.numpy(), _f32(want), atol=TOL,
                                   rtol=TOL)


def test_lm_forward_flash_seq_block_matches_jax():
    params, model = _models()
    tokens = _tokens(t=32)
    with torch.no_grad():
        got = tatt.lm_forward(model, torch.from_numpy(tokens),
                              use_flash=True, flash_seq_block=8)
    want = jatt.lm_forward(params, jnp.asarray(tokens), heads=HEADS)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=TOL, rtol=TOL)


def test_lm_forward_bf16_matches_jax_bf16():
    """bf16 weights and activations on both sides. The two frameworks
    round at other places (JAX's gelu and the matmul outputs in bf16,
    PyTorch's gelu internally in fp32), so the bound is relative to the
    largest logit: 5e-2, the bound the ResNet and LSTM bf16 checks use."""
    params, model = _models(dtype=torch.bfloat16)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tokens = _tokens()
    with torch.no_grad():
        got = tatt.lm_forward(model, torch.from_numpy(tokens),
                              use_flash=True).float().numpy()
    want = _f32(jatt.lm_forward(jparams, jnp.asarray(tokens), heads=HEADS,
                                use_flash=True, flash_interpret=True))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=5e-2,
                               rtol=0)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_layer_qkv_matches_jax_in_both_layouts(kv_heads):
    params, model = _models(kv_heads)
    h = np.random.default_rng(2).standard_normal((2, 5, DIM)).astype(
        np.float32)
    with torch.no_grad():
        got = tatt.layer_qkv(model.layers[0], torch.from_numpy(h), HEADS)
    want = jatt.layer_qkv(params["layers"][0], jnp.asarray(h), HEADS)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _f32(w), atol=1e-6,
                                   rtol=1e-6)
    assert tatt.kv_heads_of(model, HEADS) == jatt.kv_heads_of(params, HEADS)


def test_expand_kv_repeats_each_head_as_jnp_repeat():
    x = np.random.default_rng(3).standard_normal((2, 5, 2, 3)).astype(
        np.float32)
    got = tatt.expand_kv(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, _f32(jatt.expand_kv(jnp.asarray(x),
                                                           4)))
    # query head k*g + i reads kv head k
    np.testing.assert_array_equal(got[:, :, 1], x[:, :, 0])
    np.testing.assert_array_equal(got[:, :, 2], x[:, :, 1])
    tx = torch.from_numpy(x)
    assert tatt.expand_kv(tx, 2) is tx  # as many kv heads as query heads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_norm_and_dense_attention_match_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    pos = np.arange(6) + 5
    tol = 1e-6 if dtype == "float32" else 1e-2
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    got = tatt.rope(tx, torch.from_numpy(pos))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               _f32(jatt.rope(jx, jnp.asarray(pos))),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(tatt._norm(tx).float().numpy(),
                               _f32(jatt._norm(jx)), atol=tol, rtol=tol)
    q, k, v = (rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
               for _ in range(3))
    for causal in (True, False):
        got = tatt.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal)
        want = jatt.reference_attention(*map(jnp.asarray, (q, k, v)),
                                        causal=causal)
        np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5,
                                   rtol=1e-5)


def test_init_is_seeded_shaped_and_validated():
    def build(kv_heads=None):
        return tatt.init_lm_params(torch.Generator().manual_seed(3), VOCAB,
                                   DIM, HEADS, LAYERS, dtype=torch.bfloat16,
                                   kv_heads=kv_heads, device="cpu")
    a, b = build(), build()
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
        assert p.dtype == torch.bfloat16
    assert sorted(a.state_dict()) == sorted(
        convert.lm_params_to_state_dict(jax.tree.map(
            _f32, jatt.init_lm_params(jax.random.PRNGKey(0), VOCAB, DIM,
                                      HEADS, LAYERS))))
    gqa = build(kv_heads=2)
    assert tuple(gqa.layers[0].wkv.shape) == (DIM, 2 * 2 * (DIM // HEADS))
    assert gqa.layers[0].qkv is None
    # normal / sqrt(dim), as the JAX init
    std = a.embed.float().std().item()
    assert abs(std * DIM ** 0.5 - 1.0) < 0.2
    with pytest.raises(ValueError, match="divisible"):
        build(kv_heads=3)
    with pytest.raises(ValueError, match="even"):
        tatt.rope(torch.ones(1, 4, 2, 3), torch.arange(4))


def test_sequence_parallelism_is_not_yet_ported():
    """The LM's sequence parallelism is ported (``test_torch_seqpar.py``
    holds it against JAX's); what stays refused is the MoE LM over a mesh
    (its expert parallelism), and without a mesh ``seq_mode`` changes
    nothing, as in JAX."""
    _, model = _models()
    tokens = torch.from_numpy(_tokens())
    torch.testing.assert_close(
        tatt.lm_forward(model, tokens, seq_mode="ulysses"),
        tatt.lm_forward(model, tokens), rtol=0, atol=0)
    from k8s_device_plugin_torch.workloads import moe as tmoe
    moe = tmoe.init_moe_lm_params(torch.Generator().manual_seed(0), 16, 8,
                                  2, 1, n_experts=2, device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tmoe.moe_lm_forward(moe, tokens % 16, mesh=object())
