"""KV-cache decoding: the PyTorch port against the JAX package.

The cache is an optimization, never an approximation: greedy generation
through the port's cache must equal the port's from-scratch recompute
(``reference_generate``) and JAX's ``generate`` on the same weights, token
for token, at the shapes of ``tests/test_decode.py`` (vocab 32, dim 16,
heads 4, layers 2). One step's logits match JAX's to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.workloads import attention as tatt
from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import decode as tdec
from k8s_device_plugin_tpu.workloads import attention as jatt
from k8s_device_plugin_tpu.workloads import decode as jdec
from torch_support import one_torch_thread  # noqa: F401 (autouse)

VOCAB, DIM, HEADS, LAYERS = 32, 16, 4, 2


def _models(kv_heads=None):
    params = jatt.init_lm_params(jax.random.PRNGKey(0), VOCAB, DIM, HEADS,
                                 LAYERS, kv_heads=kv_heads)
    model = tatt.LM(VOCAB, DIM, HEADS, LAYERS, kv_heads=kv_heads)
    model.load_state_dict(convert.lm_params_to_state_dict(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params)))
    return params, model.eval()


@pytest.fixture(scope="module")
def mha():
    return _models()


def _prompt(b, p, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, p))


def test_decode_step_logits_match_jax(mha):
    params, model = mha
    jcache = jdec.init_kv_cache(params, batch=2, max_len=8, heads=HEADS)
    tcache = tdec.init_kv_cache(model, batch=2, max_len=8)
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    assert tcache["k"].dtype == torch.float32
    for pos, tok in enumerate(([1, 2], [3, 4], [5, 31])):
        jcache, want = jdec.decode_step(params, jcache, jnp.int32(pos),
                                        jnp.asarray(tok), HEADS)
        tcache, got = tdec.decode_step(model, tcache, pos, torch.tensor(tok))
        assert got.shape == (2, VOCAB)  # one shape at every position
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_heads,use_rope", [(None, False), (2, False),
                                               (None, True), (2, True)])
def test_generate_is_token_exact(kv_heads, use_rope):
    """Against the port's own recompute and against JAX, with MHA and the
    smaller GQA cache, with and without RoPE."""
    params, model = _models(kv_heads)
    prompt = _prompt(2, 5, seed=7)
    got = tdec.generate(model, torch.from_numpy(prompt), steps=6,
                        use_rope=use_rope)
    assert tuple(got.shape) == (2, 11)
    want = tdec.reference_generate(
        model, torch.from_numpy(prompt), steps=6,
        forward=lambda p, t: tatt.lm_forward(p, t, use_rope=use_rope))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jgot = jdec.generate(params, jnp.asarray(prompt), steps=6, heads=HEADS,
                         use_rope=use_rope)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    if kv_heads:
        cache = tdec.init_kv_cache(model, batch=2, max_len=8)
        assert cache["k"].shape[3] == kv_heads  # Hkv, not H


def test_reference_generate_through_flash_equals_dense(mha):
    _, model = mha
    prompt = torch.from_numpy(_prompt(2, 5, seed=1))
    dense = tdec.reference_generate(model, prompt, steps=4)
    flash = tdec.reference_generate(
        model, prompt, steps=4,
        forward=lambda p, t: tatt.lm_forward(p, t, use_flash=True))
    np.testing.assert_array_equal(dense.numpy(), flash.numpy())


def test_oversized_cache_is_equivalent(mha):
    _, model = mha
    prompt = torch.from_numpy(_prompt(1, 4, seed=2))
    tight = tdec.generate(model, prompt, steps=5)
    roomy = tdec.generate(model, prompt, steps=5, max_len=64)
    np.testing.assert_array_equal(tight.numpy(), roomy.numpy())


def test_single_step_and_bounds(mha):
    _, model = mha
    prompt = torch.from_numpy(_prompt(1, 3, seed=3))
    assert tuple(tdec.generate(model, prompt, steps=1).shape) == (1, 4)
    with pytest.raises(ValueError, match="max_len"):
        tdec.generate(model, prompt, steps=5, max_len=4)
    with pytest.raises(ValueError, match="steps"):
        tdec.generate(model, prompt, steps=0)


def test_decoding_twice_from_one_prefilled_state_is_identical(mha):
    """The cache is written in place, but only at slots past the prefill,
    which are masked until written: the serving loop decodes from one
    prefilled state again and again."""
    _, model = mha
    state = tdec.prefill(model, torch.from_numpy(_prompt(2, 4, seed=5)),
                         steps_budget=8)
    first = tdec.decode_from(model, *state, steps=8)
    again = tdec.decode_from(model, *state, steps=8)
    np.testing.assert_array_equal(first.numpy(), again.numpy())


def test_sampling_modes(mha):
    """top_k=1 sampling == greedy; temperature > 0 varies with the
    generator's seed and repeats with it; top_k >= vocab is a no-op."""
    _, model = mha
    state = tdec.prefill(model, torch.from_numpy(_prompt(2, 4, seed=5)),
                         steps_budget=8)

    def sample(seed, **kw):
        return tdec.decode_from(model, *state, steps=8,
                                generator=torch.Generator().manual_seed(seed),
                                **kw)

    greedy = tdec.decode_from(model, *state, steps=8)
    np.testing.assert_array_equal(
        greedy.numpy(), sample(0, temperature=1.0, top_k=1).numpy())
    s_a, s_b = sample(1, temperature=5.0), sample(2, temperature=5.0)
    # 16 hot-sampled tokens with different seeds diverge somewhere
    assert not torch.equal(s_a, s_b)
    np.testing.assert_array_equal(s_a.numpy(),
                                  sample(1, temperature=5.0).numpy())
    np.testing.assert_array_equal(
        s_a.numpy(), sample(1, temperature=5.0, top_k=64).numpy())
    with pytest.raises(ValueError, match="rng"):
        tdec.decode_from(model, *state, steps=4, temperature=1.0)
    with pytest.raises(ValueError, match="steps"):
        tdec.decode_from(model, *state, steps=0)
