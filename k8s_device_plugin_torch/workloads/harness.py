"""Model set-up, inference, training and timing helpers for the port's
workloads.

Counterpart of ``k8s_device_plugin_tpu/workloads/harness.py``
(``init_model``, ``make_infer_fn``, ``cross_entropy``,
``seg_cross_entropy``, ``make_train_fn``, ``init_train_state``,
``timed_warmup``, ``time_fn``; the meshes' ``make_mesh``,
``make_mesh_3d``, ``state_shardings``, ``batch_shardings`` and
``shard_train_step``; the compile cache's ``setup_compile_cache``,
``active_compile_cache_dir`` and ``record_compile_cache_key``), with
``torch.cuda.synchronize`` where JAX waits with ``block_until_ready``. The
JAX train state's ``params`` and ``batch_stats`` live in the module, its
``opt_state`` in a ``torch.optim`` optimizer.

A mesh is a ``DeviceMesh`` over the process group's ranks (one rank per
device) with the JAX axis names. JAX jits the global program over its
shardings and lets XLA place the collectives; here every rank runs its
own shard of it, and :func:`shard_model` puts in what XLA would: the
batch's BatchNorm statistics summed over ``dp``, the column-sharded head's
input and output collectives over ``mp``, and the gradients averaged over
``dp``.
"""

from __future__ import annotations

import json
import os
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..api import (COMPILE_CACHE_MANIFEST as CACHE_MANIFEST,
                   COMPILE_CACHE_MANIFEST_MAX_AGE_S as MAX_MANIFEST_AGE_S,
                   COMPILE_CACHE_MANIFEST_MAX_KEYS as MAX_MANIFEST_KEYS,
                   TPU_COMPILE_CACHE_DIR)


def synchronize(device: torch.device | str) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def init_model(model: nn.Module, seed: int = 0,
               device: str = "cuda") -> nn.Module:
    """Random weights from ``seed``, with Flax's default initializers:
    lecun-normal conv and dense kernels, zero biases, identity BatchNorm
    (the module defaults). A module with initializers of its own defines
    ``init_weights(generator)``, which is called in its place. Returns the
    model on ``device`` in eval mode."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif hasattr(m, "init_weights"):
            m.init_weights(g)
    return model.to(device).eval()


def make_infer_fn(model: nn.Module):
    """(batch) -> logits, without autograd bookkeeping."""
    def infer(batch):
        with torch.inference_mode():
            return model(batch)
    return infer


def cross_entropy(logits, labels):
    """Mean negative log-likelihood in fp32 of ``labels`` [...] under
    class-last ``logits`` [..., C]: [B, C] for a classifier, [B, T, V] for
    the LM's next token."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


#: the segmentation loss over channels-last [B, H, W, C] logits: the same
#: class-last mean (``F.cross_entropy`` would want the classes at dim 1)
seg_cross_entropy = cross_entropy


def sgd(model: nn.Module, lr: float = 1e-3,
        momentum: float = 0.9) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum)``: without dampening or Nesterov both
    momentum buffers start at the first gradient and the updates agree;
    ``momentum=0`` is plain ``p - lr * g``."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                           dampening=0.0, nesterov=False)


def init_train_state(model: nn.Module) -> dict:
    """Put ``model`` (weights from :func:`init_model` or a state_dict) in
    train mode and start the step counter: ``{"step": 0}``."""
    model.train()
    return {"step": 0}


def make_train_fn(model: nn.Module, optimizer: torch.optim.Optimizer,
                  loss_fn=cross_entropy, has_dropout: bool = False):
    """(state, batch, labels) -> (state, loss): one step of ``optimizer``
    on ``loss_fn(model(batch), labels)``; BatchNorm statistics update in
    the forward, as the JAX step's mutable ``batch_stats``. With
    ``has_dropout`` the model is called with ``dropout_generator``, a
    generator on the batch's device re-seeded with 0 every step, as the
    JAX step re-seeds its dropout key with ``PRNGKey(0)``: every step
    drops the same units."""
    generator = None

    def train_step(state, batch, labels):
        nonlocal generator
        optimizer.zero_grad(set_to_none=True)
        if has_dropout:
            if generator is None:
                generator = torch.Generator(device=batch.device)
            out = model(batch, dropout_generator=generator.manual_seed(0))
        else:
            out = model(batch)
        loss = loss_fn(out, labels)
        loss.backward()
        optimizer.step()
        return {"step": state["step"] + 1}, loss.detach()
    # what shard_train_step shards (the JAX state's params and opt_state)
    train_step.model, train_step.optimizer = model, optimizer
    return train_step


def count_flops(model: nn.Module, batch: torch.Tensor) -> int:
    """Forward FLOPs for ``batch``, counted from the model's own conv and
    linear layers at 2 FLOPs per multiply-add (one forward pass runs)."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        if isinstance(mod, nn.Conv2d):
            macs = mod.in_channels // mod.groups * mod.kernel_size[0] \
                * mod.kernel_size[1]
        else:
            macs = mod.in_features
        total += 2 * out.numel() * macs

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        make_infer_fn(model)(batch)
    finally:
        for h in handles:
            h.remove()
    return total


def timed_warmup(call, device) -> tuple[float, float]:
    """(compile_s, warm_step_s): the first call pays lazy set-up (CUDA
    context, cuDNN algorithm search, kernel builds) plus one execution,
    the second is pure execution; the difference is the cold-start cost."""
    t0 = time.perf_counter()
    call()
    synchronize(device)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    call()
    synchronize(device)
    warm = time.perf_counter() - t0
    return max(0.0, first - warm), warm


def time_fn(fn, *args, device, iters: int = 10, warmup: int = 2) -> float:
    """Simple wall timing; returns seconds per iteration."""
    for _ in range(warmup):
        fn(*args)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    synchronize(device)
    return (time.perf_counter() - t0) / iters


# --------------------------------------------------------------- shardings

def device_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the world's ranks, in rank order
    (as JAX reshapes ``jax.devices()``), on the process group's devices:
    the card under NCCL, the CPU under gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _world(n_devices: int | None) -> int:
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of "
                         f"as many ranks; this one has {n}")
    return n


def make_mesh(n_devices: int | None = None, mp: int = 2):
    """The (dp, mp) mesh over the world; ``mp`` falls back to 1 where it
    does not divide the world."""
    n = _world(n_devices)
    mp = mp if n % mp == 0 and n >= mp else 1
    return device_mesh((n // mp, mp), ("dp", "mp"))


def make_mesh_3d(n_devices: int | None = None):
    """The (dp, fsdp, mp) mesh of a cube host's three axes: mp and fsdp 2
    each where the world's factors of 2 allow, dp the rest. As in JAX,
    ``fsdp`` is a second replication axis: the batch rides dp only."""
    n = _world(n_devices)
    mp = 2 if n % 2 == 0 else 1
    fsdp = 2 if (n // mp) % 2 == 0 and n // mp >= 2 else 1
    return device_mesh((n // (mp * fsdp), fsdp, mp), ("dp", "fsdp", "mp"))


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size}, JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _is_head(name: str) -> bool:
    keys = name.split(".")
    return "head" in keys or "classifier" in keys


def state_shardings(mesh, model: nn.Module) -> dict:
    """The partition spec of every entry of ``model.state_dict()``, as
    JAX's ``PartitionSpec``: a tuple naming the mesh axis that splits each
    tensor dim, or None, and ``()`` for a replicated tensor. The head's
    (or classifier's) weight and bias split their output features over
    ``mp`` where ``mp`` divides them (PyTorch's dim 0 is the Flax kernel's
    last); everything else is replicated."""
    shape = mesh_shape(mesh)
    return {name: ("mp",) + (None,) * (t.dim() - 1)
            if "mp" in shape and _is_head(name) and t.dim() >= 1
            and t.shape[0] % shape["mp"] == 0
            else () for name, t in model.state_dict().items()}


def batch_shardings(mesh, batch: torch.Tensor) -> tuple:
    """The batch's partition spec: its leading dim over ``dp`` when ``dp``
    divides it, replicated otherwise (a small odd batch must degrade, not
    fail)."""
    shape = mesh_shape(mesh)
    if "dp" in shape and batch.dim() >= 1 \
            and batch.shape[0] % shape["dp"] == 0:
        return ("dp",) + (None,) * (batch.dim() - 1)
    return ()


def local_shard(t: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = t.chunk(mesh_shape(mesh)[axis], dim=dim)[
                mesh.get_local_rank(axis)]
    return t


def shard_model(model: nn.Module, mesh, batch: torch.Tensor) -> bool:
    """Put ``model`` under the mesh's shardings, in place, for ``batch``
    (the whole batch; every rank passes the same one); returns whether the
    batch is split over ``dp``.

    The head's sharded weight and bias become this rank's slices (the same
    ``Parameter`` objects, so an optimizer built on the model still holds
    them), and the head runs between :func:`collectives.copy_to` and
    :func:`collectives.gather_from` over ``mp``, so every rank sees the
    whole logits. With the batch split, every BatchNorm takes the whole
    batch's statistics over ``dp``."""
    from .collectives import copy_to, gather_from
    from .resnet import BatchNorm
    specs = state_shardings(mesh, model)
    sharded = set()
    with torch.no_grad():
        for name, t in list(model.named_parameters()) \
                + list(model.named_buffers()):
            if specs[name]:
                t.data = local_shard(t.data, mesh, specs[name]).clone()
                sharded.add(name.rpartition(".")[0])
    if sharded:
        group = mesh.get_group("mp")
    for name in sharded:
        head = model.get_submodule(name)
        dim = 1 if isinstance(head, nn.Conv2d) else -1  # NCHW or [..., C]
        head.register_forward_pre_hook(
            lambda mod, args: (copy_to(args[0], group),) + args[1:])
        head.register_forward_hook(
            lambda mod, args, out, dim=dim: gather_from(out, group, dim))
    split = bool(batch_shardings(mesh, batch))
    if split:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.group = mesh.get_group("dp")
    return split


def shard_train_step(train_step, mesh, state: dict, batch: torch.Tensor,
                     labels: torch.Tensor):
    """(step, state, batch, labels) for this rank, from a
    :func:`make_train_fn` step and the whole batch: the model under
    :func:`shard_model`, this rank's shard of the batch and labels, and a
    step that computes the unsharded step's update. The loss of a split
    batch is the mean of the ranks' means over ``dp`` (equal shards), so
    the gradients are averaged over ``dp`` before the optimizer steps, and
    the step returns the loss averaged the same way. Dropout draws each
    rank's masks for its own shard."""
    from .collectives import sum_grads
    model, optimizer = train_step.model, train_step.optimizer
    split = shard_model(model, mesh, batch)
    batch = local_shard(batch, mesh, batch_shardings(mesh, batch))
    labels = local_shard(labels, mesh, batch_shardings(mesh, labels))
    if not split:
        return train_step, state, batch, labels
    group = mesh.get_group("dp")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: sum_grads(params, group, average=True))

    def step(state, batch, labels):
        state, loss = train_step(state, batch, labels)
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        return state, loss / dist.get_world_size(group)
    return step, state, batch, labels


# -------------------------------------------------- persistent compile cache

#: the directory setup_compile_cache enabled ("" = cache off); the vouch
#: after the first call targets this, never the raw env var
_active_cache_dir = ""


def active_compile_cache_dir() -> str:
    return _active_cache_dir


def setup_compile_cache() -> str:
    """Point the kernel builds at the compile cache when the vTPU env
    contract names one (``VTPU_COMPILE_CACHE_DIR``, injected by the device
    plugin's Allocate). Returns the directory ("" = off, and the libraries
    stay in ``build/kernels``).

    Where JAX keeps XLA executables in its persistent compilation cache,
    the port has none to keep: what it compiles are the nvcc-built kernel
    libraries (``_build``). So the cache holds those, under
    ``<dir>/kernels``, and a pod re-placed on a warm host loads them
    instead of running nvcc. Call it before any kernel loads. No key is
    vouched for here: ``record_compile_cache_key`` runs after the first
    call has built what it needs, so a worker that dies before that never
    advertises the host warm."""
    global _active_cache_dir
    _active_cache_dir = ""
    cache_dir = os.environ.get(TPU_COMPILE_CACHE_DIR, "")
    kernels = os.path.join(cache_dir, "kernels") if cache_dir else None
    if kernels:
        try:
            os.makedirs(kernels, exist_ok=True)
        except OSError:  # an unwritable cache: run cold, build locally
            kernels = cache_dir = ""
    _build.set_build_dir(kernels)
    _active_cache_dir = cache_dir
    return cache_dir


def record_compile_cache_key(key: str, cache_dir: str = "") -> None:
    """Vouch for ``key`` in the host manifest (``vtpu_cache_keys.json``):
    at most ``COMPILE_CACHE_MANIFEST_MAX_KEYS`` keys, the oldest dropped
    first, none older than ``COMPILE_CACHE_MANIFEST_MAX_AGE_S``, foreign or
    corrupt entries filtered out. Best effort: a read-only cache dir never
    fails the workload.

    The manifest is shared by every workload on the host, so the
    read-modify-write holds an flock on ``<manifest>.lock``: two pods
    vouching at once must not lose each other's keys."""
    cache_dir = cache_dir or os.environ.get(TPU_COMPILE_CACHE_DIR, "")
    if not key or not cache_dir:
        return
    path = os.path.join(cache_dir, CACHE_MANIFEST)
    try:
        lock = open(f"{path}.lock", "w")
    except OSError:
        return
    try:
        try:
            import fcntl
            fcntl.flock(lock, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass  # no flock: degrade to the racy best-effort write
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
        keys = doc.get("keys") if isinstance(doc, dict) else None
        if not isinstance(keys, dict):
            keys = {}
        # numeric timestamps only (the LRU min() below compares them), and
        # none the cache's own eviction has likely removed by now
        now = time.time()
        keys = {k: ts for k, ts in keys.items()
                if isinstance(k, str) and isinstance(ts, (int, float))
                and not isinstance(ts, bool)
                and now - ts <= MAX_MANIFEST_AGE_S}
        keys[key] = now
        while len(keys) > MAX_MANIFEST_KEYS:
            del keys[min(keys, key=keys.get)]
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"keys": keys}, f)
            os.replace(tmp, path)
        except OSError:
            pass
    finally:
        lock.close()
