"""Flash absorb and flash attention: the PyTorch port against the JAX package.

On the CPU the port's ``flash_absorb`` runs its plain version (the CUDA
kernel is held against that plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Here the same seeded
numpy inputs go through the Pallas kernel in interpret mode, the JAX dense
oracle and the port, at the shapes and tolerances of
``tests/test_attention.py``: 1e-5 in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_torch import _build
from k8s_device_plugin_torch.workloads import flash as tflash
from k8s_device_plugin_tpu.workloads import flash as jflash
from k8s_device_plugin_tpu.workloads.attention import reference_attention
from torch_support import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5  # tests/test_attention.py's flash tolerance


def _qkv(b=2, t=16, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _state(b, t, h, d, seed=1):
    """A carried state that is not the identity (m finite, l > 0)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, t)).astype(np.float32),
            rng.uniform(0.5, 2.0, (b, h, t)).astype(np.float32),
            rng.standard_normal((b, t, h, d)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_dense(causal):
    q, k, v = _qkv(b=2, t=32, h=4, d=16)
    got = tflash.flash_attention(*_t(q, k, v), causal=causal).numpy()
    _close(got, jflash.flash_attention(*_j(q, k, v), causal=causal,
                                       q_tile=8, kv_tile=16, interpret=True))
    _close(got, reference_attention(*_j(q, k, v), causal=causal))


def test_flash_masked_block_is_noop():
    """kind 2 passes the streaming state through untouched, bit for bit."""
    q, k, v = _t(*_qkv(b=1, t=8, h=2, d=4))
    m1, l1, o1 = tflash.flash_absorb(q, k, v, 1, *tflash.flash_state(q))
    m2, l2, o2 = tflash.flash_absorb(q, k, v, 2, m1, l1, o1)
    for a, b in ((m1, m2), (l1, l2), (o1, o2)):
        assert torch.equal(a, b)


def test_flash_fits_odd_block_lengths():
    q, k, v = _qkv(b=1, t=24, h=2, d=8, seed=3)
    got = tflash.flash_attention(*_t(q, k, v), causal=True).numpy()
    _close(got, jflash.flash_attention(*_j(q, k, v), causal=True,
                                       interpret=True))
    _close(got, reference_attention(*_j(q, k, v), causal=True))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_seq_block_matches_pallas_and_dense(causal):
    """The chunked Q x KV walk: kind 0 and kind 1 absorbs on carried
    state, causal pairs above the diagonal skipped."""
    q, k, v = _qkv(b=1, t=32, h=2, d=8, seed=7)
    got = tflash.flash_attention(*_t(q, k, v), causal=causal,
                                 seq_block=8).numpy()
    _close(got, jflash.flash_attention(*_j(q, k, v), causal=causal,
                                       q_tile=8, kv_tile=8, interpret=True,
                                       seq_block=8))
    _close(got, reference_attention(*_j(q, k, v), causal=causal))


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("tq,tk", [(16, 16), (8, 24)])
def test_flash_absorb_on_carried_state_matches_pallas(kind, tq, tk):
    q, _, _ = _qkv(b=2, t=tq, h=2, d=8, seed=4)
    _, k, v = _qkv(b=2, t=tk, h=2, d=8, seed=5)
    m, l, o = _state(2, tq, 2, 8)
    got = tflash.flash_absorb(*_t(q, k, v), kind, *_t(m, l, o))
    want = jflash.flash_absorb(*_j(q, k, v), kind, *_j(m, l, o), q_tile=8,
                               kv_tile=8, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)
    # and the plain absorb against the JAX mirror of the kernel
    ref = jflash._absorb_reference(*_j(q, k, v), kind, *_j(m, l, o),
                                   scale=8 ** -0.5)
    for g, w in zip(got, ref):
        _close(g.numpy(), w)


def test_state_finalize_and_tiles_match_jax():
    q, _, _ = _qkv(b=2, t=5, h=3, d=4)
    for g, w in zip(tflash.flash_state(torch.from_numpy(q)),
                    jflash.flash_state(jnp.asarray(q))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m, l, o = _state(2, 5, 3, 4)
    l[0, 0, 0] = 0.0  # a row that saw nothing: l clamps at 1e-30, no NaN
    o[0, 0, 0] = 0.0
    got = tflash.flash_finalize(*_t(m, l, o), torch.float32).numpy()
    _close(got, jflash.flash_finalize(*_j(m, l, o), jnp.float32))
    assert np.isfinite(got).all()
    for n in (1, 7, 24, 96, 128, 192, 2048):
        for want in (1, 8, 16, 100, 128, 1024):
            assert tflash._fit_tile(n, want) == jflash._fit_tile(n, want)
            assert tflash._cover_tile(n, want) == jflash._cover_tile(n, want)


def test_flash_absorb_on_cpu_counts_no_launch_and_checks_shapes():
    q, k, v = _t(*_qkv(b=1, t=8, h=2, d=4))
    m, l, o = tflash.flash_state(q)
    before = _build.launches["flash_absorb"]
    tflash.flash_absorb(q, k, v, 1, m, l, o)
    assert _build.launches["flash_absorb"] == before
    with pytest.raises(ValueError, match="kind"):
        tflash.flash_absorb(q, k, v, 3, m, l, o)
    with pytest.raises(ValueError, match="expected"):
        tflash.flash_absorb(q, k[:, :, :1], v, 0, m, l, o)
    with pytest.raises(ValueError, match="float32"):
        tflash.flash_absorb(q, k, v, 0, m, l, o.double())
    with pytest.raises(ValueError, match="no kernel for device"):
        tflash.flash_absorb(*(t.to("meta") for t in (q, k, v)), 0,
                            *(t.to("meta") for t in (m, l, o)))


def test_check_strides_takes_what_the_kernel_reads_in_place():
    """The wrapper's rule for q, k, v on the card, run here: a unit-stride
    head dim, a 16-byte aligned base, and the other strides multiples of
    16 bytes (dims of size 1 aside)."""
    ok = [torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16),
          torch.zeros(2, 8, 3, 4, 64, dtype=torch.bfloat16).unbind(2)[1],
          torch.zeros(2, 4, 8, 16).transpose(1, 2),
          torch.zeros(1, 1, 1, 4).as_strided((1, 1, 1, 4), (3, 5, 7, 1))]
    for t in ok:
        tflash.check_strides("q", t)
    with pytest.raises(ValueError, match="last dim"):
        tflash.check_strides("q", torch.zeros(2, 8, 64, 4).transpose(2, 3))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash.check_strides("k", torch.zeros(2 * 8 * 4 * 16 + 1)[1:]
                             .view(2, 8, 4, 16))
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tflash.check_strides("v", torch.zeros(2, 8, 3, 5))


def test_routes_and_kernel_strides():
    bf16 = torch.bfloat16
    assert tflash.absorb_route(torch.float32, 64, 128) == "fma"
    assert tflash.absorb_route(bf16, 64, 2048) == "wgmma"
    assert tflash.absorb_route(bf16, 64, 0) == "mma_sync"
    assert tflash.absorb_route(bf16, 128, 0) == "mma_sync"
    for dim in (16, 32):
        assert tflash.absorb_route(bf16, dim, 128) == "mma_sync"
    for dim in (64, 128):  # with or without a window
        assert tflash.absorb_route(bf16, dim, 128) == "wgmma"
        assert tflash.absorb_route(bf16, dim, 128, 100) == "wgmma"
    q = torch.zeros(2, 8, 3, 4, 64).unbind(2)[0]
    assert tflash._kernel_strides(q) == [8 * 3 * 4 * 64, 3 * 4 * 64, 64]
    # dims of size 1 get a packed layout's stride, a multiple of 16 bytes
    one = torch.zeros(1, 1, 1, 64).as_strided((1, 1, 1, 64), (7, 5, 3, 1))
    assert tflash._kernel_strides(one) == [64, 64, 64]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_reads_layer_qkv_views(causal):
    """flash_attention on the strided views that layer_qkv returns (no
    copy is made for the kernel) equals it on contiguous inputs, and the
    JAX flash_attention (Pallas in interpret mode) at 1e-5 in fp32."""
    from k8s_device_plugin_torch.workloads.attention import (init_lm_params,
                                                             layer_qkv)
    model = init_lm_params(torch.Generator().manual_seed(0), 64, 64, 4, 1,
                           device="cpu")
    h = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 32, 64)).astype(np.float32))
    with torch.no_grad():
        q, k, v = layer_qkv(model.layers[0], h, 4)
    assert not any(t.is_contiguous() for t in (q, k, v))
    for t in (q, k, v):
        tflash.check_strides("qkv", t)
    got = tflash.flash_attention(q, k, v, causal=causal)
    dense = tflash.flash_attention(*(t.contiguous() for t in (q, k, v)),
                                   causal=causal)
    assert torch.equal(got, dense)
    want = jflash.flash_attention(*_j(*(t.numpy() for t in (q, k, v))),
                                  causal=causal, q_tile=8, kv_tile=16,
                                  interpret=True)
    _close(got.numpy(), want)
