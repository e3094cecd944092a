"""Flash-attention absorb with carried streaming-softmax state: a
hand-written CUDA kernel and its plain version.

Counterpart of ``k8s_device_plugin_tpu/workloads/flash.py``. The state
(running max ``m``, normalizer ``l``, accumulator ``o``) is carried in and
out of every call, so the same kernel serves whole-sequence attention
(:func:`flash_attention`, state from :func:`flash_state`, one call) and
callers that absorb K/V block by block (the ``seq_block`` chunking here,
the ring later). On a CUDA tensor :func:`flash_absorb` launches
``csrc/flash_absorb.cu`` (see its header for the designs and what bounds
them) by the route :func:`absorb_route` picks from dtype and head dim; on
a CPU tensor it runs :func:`_absorb_reference`, the same algebra in plain
PyTorch. The kernel reads q, k and v in place through their strides
(:func:`check_strides` says which it takes), so the views of a fused QKV
projection need no copy.

Layouts follow the JAX package: q [B, Tq, H, D], k/v [B, Tk, H, D];
m/l [B, H, Tq] fp32; o [B, Tq, H, D] fp32. The mask is a runtime ``kind``:
0 attends to everything, 1 is causal on call-local row >= col, 2 masks
everything and passes the state through unchanged. A ``window`` W > 0
narrows it to the keys with row - col < W (kind 1 with W is the sliding
window: key j is visible to query i iff i - W < j <= i); the kernel then
never loads the key tiles wholly before the band, and launches as
``flash_window_kernel``, counted in ``_build.launches["flash_window"]``
where every other launch counts under ``flash_absorb``. The ``wgmma``
route takes no window: :func:`absorb_route` sends a windowed bf16 call to
``mma_sync`` at every head dim, and forcing ``wgmma`` with one raises.

Gradients: where autograd records, :func:`flash_absorb` runs as a
``torch.autograd.Function``, the counterpart of the JAX custom VJP
(``_flash_absorb_vjp``). Its forward is the kernel on a CUDA tensor and
the plain absorb on a CPU one; its backward, on both, recomputes one
absorb through :func:`absorb_block_reference` and differentiates that, as
the JAX backward differentiates ``absorb_block_jnp`` (there is no backward
kernel in either package). The stabilizers are detached, so ``m`` carries
no gradient. The backward runs under the profiler range
``flash_absorb.backward``, so a trace attributes its device time. Where
autograd records nothing (``inference_mode``, ``no_grad``) the forward
runs without the Function: an ``apply`` costs host time on every call,
which a host-bound serving path pays (``PERF.md`` §6 measures it on the
LSTM's cell). :func:`_absorb_kernel`, the measurement entry that forces
a route, still raises when autograd would need a gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30

#: largest head dim the kernel takes
MAX_HEAD_DIM = 128
#: the bf16 head dim of the wgmma + TMA route; other bf16 head dims take
#: the mma.sync route
WGMMA_HEAD_DIM = 64
#: kernel routes by name: fp32 on FMA, bf16 on mma.sync, bf16 on wgmma
#: with a TMA ring, and the last with P rounded to bf16 (measurement only:
#: it misses the LM-case check, see the kernel's header)
ROUTES = {"fma": 0, "mma_sync": 1, "wgmma": 2, "wgmma_round_p": 3}
# route, q, k, v, strides, m, l, o, m_out, l_out, o_out, batch, heads, tq,
# tk, dim, kind, window, scale
_ABSORB_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_void_p] * 6
                + [ctypes.c_int] * 7 + [ctypes.c_float])
FLASH_ABSORB = _build.Kernel("flash_absorb", "vtpu_flash_absorb",
                             _ABSORB_ARGS)
#: the same entry with a window: counted apart, as its kernel is named apart
FLASH_WINDOW = _build.Kernel("flash_absorb", "vtpu_flash_absorb",
                             _ABSORB_ARGS, name="flash_window")


def absorb_block_reference(q, k, v, allowed, m, l, o, scale: float):
    """Streaming-softmax absorb of one K/V block in plain PyTorch (the
    counterpart of ``absorb_block_jnp``). ``allowed``: [Tq, Tk] bool
    (True = attend). The max-stabilizers are detached, as the JAX mirror
    stops their gradients."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(allowed[None, None], s, NEG_INF)
    m_blk = s.amax(dim=-1).detach()                            # [B,H,Tq]
    p = torch.exp(s - m_blk[..., None])
    # fully masked rows: m_blk == NEG_INF and p == 1 at every position;
    # zero them so a masked block adds nothing to l or o
    p = torch.where((m_blk == NEG_INF)[..., None], 0.0, p)
    m_c = m.detach()
    m_new = torch.maximum(m_c, m_blk)
    corr = torch.exp(m_c - m_new)
    blk_corr = torch.exp(m_blk - m_new)
    l_new = l * corr + p.sum(dim=-1) * blk_corr
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * corr.transpose(1, 2)[..., None] \
        + pv * blk_corr.transpose(1, 2)[..., None]
    return m_new, l_new, o_new


def _absorb_reference(q, k, v, kind, m, l, o, scale: float,
                      window: int = 0):
    """The kernel's semantics in plain PyTorch: builds the [Tq, Tk] mask
    from the runtime ``kind`` and ``window`` as the kernel does (call-local
    rows and columns) and absorbs with :func:`absorb_block_reference`."""
    tq, tk = q.shape[1], k.shape[1]
    rows = torch.arange(tq, device=q.device)[:, None]
    cols = torch.arange(tk, device=q.device)[None, :]
    kind = int(kind)
    allowed = torch.full((tq, tk), kind == 0, device=q.device) \
        | ((kind == 1) & (rows >= cols))
    if window:
        allowed &= rows - cols < window
    return absorb_block_reference(q, k, v, allowed, m, l, o, scale)


def _check(q, k, v, kind, m, l, o, window: int = 0) -> int:
    """Shapes, dtypes, devices and the window, common to both versions;
    returns kind."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_absorb: q and k must be [B, T, H, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    batch, tq, heads, dim = q.shape
    tk = k.shape[1]
    shapes = {"q": (q, (batch, tq, heads, dim)),
              "k": (k, (batch, tk, heads, dim)),
              "v": (v, (batch, tk, heads, dim)),
              "m": (m, (batch, heads, tq)), "l": (l, (batch, heads, tq)),
              "o": (o, (batch, tq, heads, dim))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_absorb: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"flash_absorb: {name} is on {t.device}, q on "
                             f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"flash_absorb: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
    for name, t in (("m", m), ("l", l), ("o", o)):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_absorb: the state must be float32, "
                             f"{name} is {t.dtype}")
    kind = int(kind)
    if kind not in (0, 1, 2):
        raise ValueError(f"flash_absorb: kind must be 0, 1 or 2, got {kind}")
    if int(window) != window or window < 0:
        raise ValueError(f"flash_absorb: the window must be a whole number "
                         f">= 0 (0 for none), got {window}")
    return kind


def absorb_route(dtype, dim: int, tk: int, window: int = 0) -> str:
    """The kernel route for these shapes: fp32 on FMA; bf16 on wgmma with
    a TMA ring at head dim 64 (with at least one key and no window), else
    on mma.sync."""
    if dtype == torch.float32:
        return "fma"
    return ("wgmma" if dim == WGMMA_HEAD_DIM and tk > 0 and not window
            else "mma_sync")


def check_strides(name: str, t) -> None:
    """Raise unless the kernel can read ``t`` [B, T, H, D] in place: the
    head dim has unit stride, the base is 16-byte aligned, and every other
    stride (of a dim longer than 1) is a multiple of 16 bytes, as 16-byte
    loads and TMA need."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"flash_absorb: {name} has stride {t.stride(-1)} "
                         f"on its last dim; the kernel needs 1")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_absorb: {name} is not 16-byte aligned")
    for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
        if size > 1 and (stride * t.element_size()) % 16:
            raise ValueError(f"flash_absorb: {name} has strides "
                             f"{tuple(t.stride())}; each but the last must "
                             f"be a multiple of 16 bytes")


def _kernel_strides(t) -> list[int]:
    """Element strides (b, t, h) of ``t`` for the kernel; a dim of size 1
    gets the stride a packed layout would give it (its stride is never
    used, but TMA checks it)."""
    _, n_t, n_h, n_d = t.shape
    sh = t.stride(2) if n_h > 1 else n_d
    st = t.stride(1) if n_t > 1 else n_h * sh
    sb = t.stride(0) if t.shape[0] > 1 else n_t * st
    return [sb, st, sh]


def _absorb(q, k, v, kind, m, l, o, window: int = 0):
    """The absorb's forward: the kernel on a CUDA tensor, the plain absorb
    on a CPU one."""
    if q.device.type == "cpu":
        kind = _check(q, k, v, kind, m, l, o, window)
        return _absorb_reference(q, k, v, kind, m, l, o,
                                 1.0 / math.sqrt(q.shape[-1]), window)
    return _absorb_kernel(None, q, k, v, kind, m, l, o, window)


class _Absorb(torch.autograd.Function):
    """The absorb with the JAX custom VJP's backward: the forward is
    :func:`_absorb`; the backward recomputes the plain absorb from the
    saved inputs and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, kind, m, l, o, window):
        out = _absorb(q, k, v, kind, m, l, o, window)
        ctx.kind, ctx.window = kind, window
        ctx.save_for_backward(q, k, v, m, l, o)
        ctx.mark_non_differentiable(out[0])  # m: built from detached maxima
        return out

    @staticmethod
    def backward(ctx, dm, dl, do):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3] + ctx.needs_input_grad[4:7]
        with torch.enable_grad(), torch.profiler.record_function(
                "flash_absorb.backward"):
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, needs)]
            q, k, v, m, l, o = inputs
            _, l_new, o_new = _absorb_reference(q, k, v, ctx.kind, m, l, o,
                                                1.0 / math.sqrt(q.shape[-1]),
                                                ctx.window)
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(
                (l_new, o_new), wrt, (dl, do), allow_unused=True))
        dq, dk, dv, dm_in, dl_in, do_in = (next(grads) if need else None
                                           for need in needs)
        return dq, dk, dv, None, dm_in, dl_in, do_in, None


def flash_absorb(q, k, v, kind, m, l, o, window: int = 0):
    """One streaming-softmax absorption of K/V into (m, l, o), under the
    mask ``kind`` and ``window`` (0 for none); returns the new state in new
    tensors (the inputs are not written). Finalize with
    :func:`flash_finalize` once every block has been absorbed.
    Differentiable in q, k, v, l and o (see the module docstring); when
    autograd records nothing the forward runs without the Function."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, m, l, o)):
        return _Absorb.apply(q, k, v, int(kind), m, l, o, int(window))
    return _absorb(q, k, v, kind, m, l, o, window)


def _absorb_kernel(route: str | None, q, k, v, kind, m, l, o,
                   window: int = 0):
    """Launch the kernel by ``route`` (a key of :data:`ROUTES`), or by the
    one :func:`absorb_route` picks when it is None; measurements may force
    another route that takes the same inputs."""
    kind = _check(q, k, v, kind, m, l, o, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_absorb: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, m, l, o)):
        raise RuntimeError("flash_absorb: a forced route has no backward; "
                           "differentiate flash_absorb, or run under "
                           "torch.no_grad()")
    batch, tq, heads, dim = q.shape
    tk = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_absorb: no kernel for {q.dtype}")
    if dim > MAX_HEAD_DIM:
        raise ValueError(f"flash_absorb: head dim {dim} > {MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16 and dim % 8:
        raise ValueError(f"flash_absorb: bf16 needs a head dim that is a "
                         f"multiple of 8, got {dim}")
    window = int(window)
    if window and route and route.startswith("wgmma"):
        raise ValueError(f"flash_absorb: route {route} takes no window, got "
                         f"{window}")
    route = route or absorb_route(q.dtype, dim, tk, window)
    if (route == "fma") != (q.dtype == torch.float32) or (
            route.startswith("wgmma")
            and absorb_route(q.dtype, dim, tk) != "wgmma"):
        raise ValueError(f"flash_absorb: route {route} does not take "
                         f"{q.dtype} at head dim {dim}, {tk} keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strides(name, t)
    for name, t in (("m", m), ("l", l), ("o", o)):
        if not t.is_contiguous():
            raise ValueError(f"flash_absorb: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_absorb: {name} is not 16-byte aligned")
    strides = (ctypes.c_longlong * 9)(
        *_kernel_strides(q), *_kernel_strides(k), *_kernel_strides(v))
    m_out, l_out, o_out = (torch.empty_like(t) for t in (m, l, o))
    (FLASH_WINDOW if window else FLASH_ABSORB)(
        q, ROUTES[route], q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
        m.data_ptr(), l.data_ptr(), o.data_ptr(), m_out.data_ptr(),
        l_out.data_ptr(), o_out.data_ptr(), batch, heads, tq, tk, dim, kind,
        window, 1.0 / math.sqrt(dim), label=f"flash_absorb ({route})")
    return m_out, l_out, o_out


def _fit_tile(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is <= ``want``."""
    t = min(want, n)
    while n % t:
        t -= 1
    return t


def _cover_tile(n: int, minimum: int) -> int:
    """Smallest divisor of ``n`` that is >= ``minimum`` (worst case
    ``n`` itself)."""
    t = max(1, min(minimum, n))
    while n % t:
        t += 1
    return t


def flash_state(q):
    """Identity streaming state for a fresh attention computation."""
    b, tq, h, d = q.shape
    return (torch.full((b, h, tq), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, tq), dtype=torch.float32, device=q.device),
            torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device))


def flash_finalize(m, l, o, dtype):
    l = torch.clamp_min(l, 1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(dtype)


def flash_attention(q, k, v, causal: bool = True,
                    seq_block: int | None = None, window: int = 0):
    """Whole-sequence attention through the absorb (single device).

    Without ``seq_block`` it is one whole-sequence absorb, under a
    ``window`` if one is given (causal: query i sees keys i - window < j <=
    i). With it, Q and K/V are walked in aligned chunks of ``seq_block``
    (grown so there are at most 16): causal skips the pairs above the
    diagonal, the diagonal pair runs kind 1 and the pairs below it kind 0,
    all on carried state; a window is not taken there.
    """
    b, t, h, d = q.shape
    if window and seq_block is not None:
        raise ValueError("flash_attention: a window runs as one "
                         "whole-sequence absorb, without seq_block")
    sb = None
    if seq_block is not None and seq_block < t:
        sb = _fit_tile(t, seq_block)
        if t // sb > 16:
            sb = _cover_tile(t, -(-t // 16))
    if sb is None or sb >= t:
        m, l, o = flash_state(q)
        m, l, o = flash_absorb(q, k, v, 1 if causal else 0, m, l, o, window)
        return flash_finalize(m, l, o, q.dtype)

    nb = t // sb
    outs = []
    for i in range(nb):
        qi = q[:, i * sb:(i + 1) * sb]
        m, l, o = flash_state(qi)
        for j in range(i + 1 if causal else nb):
            kj = k[:, j * sb:(j + 1) * sb]
            vj = v[:, j * sb:(j + 1) * sb]
            kind = 1 if (causal and j == i) else 0
            m, l, o = flash_absorb(qi, kj, vj, kind, m, l, o)
        outs.append(flash_finalize(m, l, o, q.dtype))
    return torch.cat(outs, dim=1)
