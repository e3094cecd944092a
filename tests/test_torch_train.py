"""Training: the PyTorch port's gradients and train steps against the JAX
package, on the CPU at tiny sizes.

The same seeded numpy inputs and weights go through both. JAX's flash
path runs the Pallas kernel in interpret mode under its custom VJP; the
port's runs the plain absorb under its ``autograd.Function``, whose
backward is the one the card runs (the CUDA forward is held against the
plain one on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``). Each case states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch.workloads import attention as tatt
from k8s_device_plugin_torch.workloads import convert
from k8s_device_plugin_torch.workloads import flash as tflash
from k8s_device_plugin_torch.workloads import harness as th
from k8s_device_plugin_tpu.workloads import attention as jatt
from k8s_device_plugin_tpu.workloads import flash as jflash
from k8s_device_plugin_tpu.workloads import harness as jh
from torch_support import one_torch_thread  # noqa: F401 (autouse)

#: tests/test_attention.py's gradient tolerance (atol, rtol)
GRAD_TOL = (1e-5, 1e-4)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _torch_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return [g.numpy() for g in torch.autograd.grad(fn(*ts), ts)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,seq_block", [
    ((2, 16, 2, 8), None),   # one whole-sequence absorb
    ((1, 16, 2, 8), 8),      # the chunked walk, kinds 0 and 1
])
def test_flash_attention_gradients_match_jax(causal, shape, seq_block):
    """Grads of sum(sin(flash_attention)) in q, k, v against the JAX
    flash_attention's custom VJP (Pallas interpreted) at 1e-5 / 1e-4."""
    q, k, v = _qkv(*shape, seed=5)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jflash.flash_attention(
        *a, causal=causal, q_tile=8, kv_tile=8, interpret=True,
        seq_block=seq_block))), argnums=(0, 1, 2))(*map(jnp.asarray,
                                                        (q, k, v)))
    got = _torch_grads(lambda *a: torch.sin(tflash.flash_attention(
        *a, causal=causal, seq_block=seq_block)).sum(), q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_TOL[0],
                                   rtol=GRAD_TOL[1])


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_flash_absorb_vjp_on_carried_state_matches_jax(kind):
    """The absorb's backward in all six inputs on a carried state, against
    jax.vjp of the JAX flash_absorb (Pallas interpreted): m's gradient is
    zero on both sides (its stabilizers are detached), kind 2 passes the
    cotangents of l and o straight through. 1e-5 / 1e-4."""
    q, k, v = _qkv(2, 8, 2, 8, seed=4)
    rng = np.random.default_rng(6)
    m = rng.standard_normal((2, 2, 8)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (2, 2, 8)).astype(np.float32)
    o = rng.standard_normal((2, 8, 2, 8)).astype(np.float32)
    cts = (rng.standard_normal(m.shape).astype(np.float32),
           rng.standard_normal(l.shape).astype(np.float32),
           rng.standard_normal(o.shape).astype(np.float32))

    def jfn(q_, k_, v_, m_, l_, o_):
        return jflash.flash_absorb(q_, k_, v_, kind, m_, l_, o_, q_tile=8,
                                   kv_tile=8, interpret=True)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, m, l, o)))
    want = vjp(tuple(map(jnp.asarray, cts)))

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, m, l, o)]
    m1, l1, o1 = tflash.flash_absorb(*ts[:3], kind, *ts[3:])
    assert not m1.requires_grad  # m carries no gradient
    got = torch.autograd.grad((l1, o1), ts, tuple(map(torch.from_numpy,
                                                      cts[1:])),
                              allow_unused=True)
    for name, g, w in zip("qkvmlo", got, want):
        g = np.zeros_like(np.asarray(w)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_TOL[0],
                                   rtol=GRAD_TOL[1], err_msg=name)


def test_flash_absorb_saves_nothing_without_autograd():
    """Serving paths (inference_mode, no_grad) get plain tensors back."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 8, seed=1))
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            out = tflash.flash_attention(q.requires_grad_(), k, v)
        assert out.grad_fn is None and not out.requires_grad


def _lm(layers, seed=0):
    params = _f32(jatt.init_lm_params(jax.random.PRNGKey(seed), 32, 16, 2,
                                      layers))
    model = tatt.LM(32, 16, 2, layers)
    model.load_state_dict(convert.lm_params_to_state_dict(params))
    return params, model


@pytest.mark.parametrize("layers", [1, 2])
def test_lm_loss_and_gradients_match_jax(layers):
    """lm_loss on [2, 17] tokens (T 16 after the shift, flash_seq_block 8
    so the chunked walk runs): the loss at 1e-5 and every parameter's
    gradient at 1e-5 / 1e-4, against the JAX lm_loss through the Pallas
    kernel's custom VJP."""
    params, model = _lm(layers)
    tokens = np.random.default_rng(1).integers(0, 32, (2, 17))
    loss, grads = jax.value_and_grad(lambda p: jatt.lm_loss(
        p, jnp.asarray(tokens), heads=2, use_flash=True,
        flash_interpret=True, flash_seq_block=8))(params)
    got = tatt.lm_loss(model, torch.from_numpy(tokens), use_flash=True,
                       flash_seq_block=8)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=1e-5,
                               rtol=1e-5)
    want = convert.lm_params_to_state_dict(_f32(grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL[0], rtol=GRAD_TOL[1],
                                   err_msg=name)


def test_lm_loss_dense_and_flash_agree():
    """Dense attention and the flash Function give one gradient (the
    runner trains dense on the CPU, flash on the card)."""
    _, model = _lm(2)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 32,
                                                                (2, 17)))
    grads = []
    for use_flash in (False, True):
        model.zero_grad()
        tatt.lm_loss(model, tokens, use_flash=use_flash).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [(4, 10), (2, 3, 5, 7)])
def test_cross_entropies_match_jax(shape):
    """cross_entropy on [B, C] and seg_cross_entropy on channels-last
    [B, H, W, C] logits, against the JAX losses at 1e-6."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    labels = rng.integers(0, shape[-1], shape[:-1])
    jfn, tfn = ((jh.cross_entropy, th.cross_entropy) if len(shape) == 2
                else (jh.seg_cross_entropy, th.seg_cross_entropy))
    want = float(jfn(jnp.asarray(logits), jnp.asarray(labels)))
    got = tfn(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # bf16 logits are taken in fp32, as the JAX loss does
    got16 = tfn(torch.from_numpy(logits).bfloat16(),
                torch.from_numpy(labels)).item()
    want16 = float(jfn(jnp.asarray(logits, jnp.bfloat16),
                       jnp.asarray(labels)))
    np.testing.assert_allclose(got16, want16, rtol=1e-6, atol=1e-6)
