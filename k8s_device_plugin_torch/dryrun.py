"""Multi-device dry run of the port on CPU ranks.

Counterpart of ``dryrun_multichip`` in the repo root's
``__graft_entry__.py``: one training step of every parallel layout the
port has, on tiny shapes, printed in the same lines. Where the JAX dry run
forces a virtual mesh of CPU devices in one process, this one spawns
``n_devices`` CPU processes, one rank each, joined over gloo through a
``FileStore`` in a temporary directory (so concurrent runs never collide
on a port), and every rank runs its shard of each leg:

* the 2-D (dp, mp) ResNet-50 step (``harness.shard_train_step``), and the
  3-D (dp, fsdp, mp) one when ``n % 8 == 0``;
* the LM's sequence-parallel train step on a (dp, sp) mesh at sp 2, 4 and
  8 (the ring), and at sp 4 through the flash absorb (``sp+flash``), with
  Ulysses (``sp-ulysses``) and with grouped-query attention (``sp+gqa``);
* the gang leg: the mesh's dp axis shaped from a member's rendered
  ``TPU_PROCESS_BOUNDS`` (by default the env the device plugin gives
  member 0 of a two-member gang, ``api.gang_process_env``; the control
  plane that places the gang is not ported).

The expert-parallel, pipeline and sp+ep legs are not ported yet.

Usage::

    python -c "from k8s_device_plugin_torch.dryrun import dryrun_multichip; dryrun_multichip(8)"

:func:`spawn` runs any list of legs (``LEGS``) on n ranks and returns each
rank's results; the parity tests drive it with weights and inputs carried
across from the JAX package (``weights`` and ``inputs`` name ``.npz``
files of numpy arrays).
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import api


# ------------------------------------------------------------------- legs

def _load(path: str | None) -> dict | None:
    if path is None:
        return None
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def _resnet_mesh(layout: str, gang_env: dict | None):
    """The leg's mesh and, for the gang leg, the bounds it read."""
    from .workloads import harness
    n = dist.get_world_size()
    if layout == "2d":
        return harness.make_mesh(n, mp=2 if n % 2 == 0 else 1), None
    if layout == "3d":
        return harness.make_mesh_3d(n), None
    # the process grid's leading axis is data-parallel: one process per
    # member host, the member's local chips tensor-parallel under it
    bounds = gang_env[api.TPU_PROCESS_BOUNDS]
    hosts = math.prod(int(b) for b in bounds.split(","))
    mesh = harness.make_mesh(n, mp=n // hosts)
    if harness.mesh_shape(mesh)["dp"] != hosts:
        raise AssertionError(f"gang mesh {harness.mesh_shape(mesh)} does "
                             f"not put the {hosts} hosts of {bounds} on dp")
    return mesh, bounds


def resnet_step(layout: str = "2d", gang_env: dict | None = None,
                num_classes: int = 128, dtype: str = "bfloat16",
                blocks: tuple | None = None, weights: str | None = None,
                inputs: str | None = None,
                state_ranks: tuple = ()) -> dict:
    """One sharded SGD-momentum step of ResNet-V2-50 (``blocks`` per stage
    in place of 3, 4, 6, 3 when given): ``layout`` "2d", "3d" or "gang"
    (with ``gang_env``). Weights from ``weights`` or seed 0; the batch
    from ``inputs`` (``x``, ``labels``) or the JAX dry run's ones at 2 a dp
    rank, 32 x 32. Ranks in ``state_ranks`` return their state_dict after
    the step and the gradients it took (the head's are their shard)."""
    from .workloads import harness, resnet
    if blocks is not None:
        resnet.DEPTHS[50] = tuple(blocks)  # this rank's own process
    mesh, bounds = _resnet_mesh(layout, gang_env)
    dp = harness.mesh_shape(mesh)["dp"]
    dt = getattr(torch, dtype)
    model = resnet.ResNetV2(depth=50, num_classes=num_classes, dtype=dt,
                            param_dtype=torch.float32)
    if dt == torch.float64:  # all in fp64 but the head, as the JAX Dense
        model.double().head.float()
    state = _load(weights)
    if state is None:
        harness.init_model(model, 0, "cpu")
    else:
        model.load_state_dict(state)
    data = _load(inputs)
    if data is None:
        data = {"x": torch.ones(2 * dp, 32, 32, 3),
                "labels": torch.zeros(2 * dp, dtype=torch.long)}
    train_step = harness.make_train_fn(model, harness.sgd(model))
    state = harness.init_train_state(model)
    step, state, x, labels = harness.shard_train_step(
        train_step, mesh, state, data["x"].to(dt), data["labels"].long())
    state, loss = step(state, x, labels)
    out = {"loss": loss.item(), "mesh": harness.mesh_shape(mesh),
           "bounds": bounds, "local_batch": x.shape[0],
           "step": state["step"]}
    if dist.get_rank() in state_ranks:
        out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        out["grads"] = {k: p.grad.clone()
                        for k, p in model.named_parameters()}
    return out


def sp_step(sp: int, use_flash: bool = False, seq_mode: str = "ring",
            kv_heads: int | None = None, weights: str | None = None,
            inputs: str | None = None, grads: bool = False) -> dict:
    """The LM's sequence-parallel train step of the JAX dry run: vocab 64,
    dim 32, 4 heads, 2 layers, fp32, on a (n / sp, sp) mesh; the loss and
    its gradient (summed over the world), with weights from ``weights``
    (or seed 0) and tokens [dp, 4 sp + 1] from ``inputs`` (or seed 1).
    With ``grads`` rank 0 returns the gradients."""
    from .workloads import harness
    from .workloads.attention import init_lm_params, lm_loss
    from .workloads.collectives import sum_grads
    n = dist.get_world_size()
    dp = n // sp
    mesh = harness.device_mesh((dp, sp), ("dp", "sp"))
    model = init_lm_params(torch.Generator().manual_seed(0), 64, 32, 4, 2,
                           kv_heads=kv_heads, device="cpu")
    state = _load(weights)
    if state is not None:
        model.load_state_dict(state)
    data = _load(inputs)
    tokens = data["tokens"].long() if data is not None else torch.randint(
        0, 64, (dp, 4 * sp + 1), generator=torch.Generator().manual_seed(1))
    loss = lm_loss(model, tokens, mesh, use_flash=use_flash,
                   seq_mode=seq_mode)
    loss.backward()
    sum_grads(model.parameters())
    out = {"loss": loss.item(), "mesh": harness.mesh_shape(mesh)}
    if grads and dist.get_rank() == 0:
        out["grads"] = {k: p.grad.clone()
                        for k, p in model.named_parameters()}
    return out


def attention_blocks(sp: int, inputs: str, cases: list) -> list:
    """This rank's [B/dp, T/sp] block of attention over the whole q, k, v
    of ``inputs`` on a (n / sp, sp) mesh, for each ``(impl, causal, kv)``
    of ``cases``: ``impl`` "ring", "flash" (the ring through the flash
    absorb) or "ulysses"; ``kv`` the name suffix of the k and v to use
    (``k{kv}``, ``v{kv}``; fewer heads than q is GQA)."""
    from .workloads import harness
    from .workloads.attention import (expand_kv, ring_attention,
                                      ulysses_attention)
    n = dist.get_world_size()
    mesh = harness.device_mesh((n // sp, sp), ("dp", "sp"))
    group = mesh.get_group("sp")
    i, j = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    data = _load(inputs)
    b, t, heads = data["q"].shape[:3]

    def block(name):
        return data[name][i * (b * sp // n):(i + 1) * (b * sp // n),
                          j * (t // sp):(j + 1) * (t // sp)]
    outs = []
    for impl, causal, kv in cases:
        q, k, v = block("q"), block(f"k{kv}"), block(f"v{kv}")
        if impl == "ulysses":
            out = ulysses_attention(q, expand_kv(k, heads),
                                    expand_kv(v, heads), group,
                                    causal=causal)
        else:
            out = ring_attention(q, k, v, group, causal=causal,
                                 use_flash=impl == "flash")
        outs.append(out)
    return outs


LEGS = {"resnet_step": resnet_step, "sp_step": sp_step,
        "attention_blocks": attention_blocks}


# ------------------------------------------------------------------ ranks

def _rank_main(rank: int, n: int, workdir: str, legs: list,
               timeout_s: float) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), n),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        results = [LEGS[name](**kwargs) for name, kwargs in legs]
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(n: int, legs: list, timeout_s: float = 300.0) -> list[list[dict]]:
    """Run ``legs`` ([(name in ``LEGS``, kwargs), ...]) in order on ``n``
    CPU ranks over gloo; returns ``results[rank][leg]``. A failed rank
    raises here with its traceback (and the others are killed); ranks
    still running after ``timeout_s`` are killed and raise
    ``TimeoutError``.

    The ranks are forked from a fork server that imported this module
    (and with it torch) and ``torch._dynamo`` (which the optimizer's
    first use imports) once, in a fresh single-threaded process: spawning
    each rank from scratch would import them eight times over, about 3 s
    of CPU each."""
    import multiprocessing

    import torch.multiprocessing as mp
    multiprocessing.get_context("forkserver").set_forkserver_preload(
        [__name__, "torch._dynamo"])
    with tempfile.TemporaryDirectory(prefix="vtpu-dryrun-") as workdir:
        ctx = mp.start_processes(_rank_main,
                                 args=(n, workdir, legs, timeout_s),
                                 nprocs=n, join=False,
                                 start_method="forkserver")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dry run: ranks still running after "
                                       f"{timeout_s:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


# --------------------------------------------------------------- dry run

def gang_env(n_devices: int) -> dict[str, str]:
    """The env the device plugin renders for member 0 of a two-member gang
    holding ``n_devices // 2`` chips each."""
    return api.gang_process_env(2, 0, ["tpu-host-0", "tpu-host-1"],
                                n_devices // 2)


def dryrun_legs(n_devices: int, env: dict | None = None) -> list:
    """(the JAX line's name for the leg, (leg, kwargs)) for every leg
    ``n_devices`` admits, in the JAX dry run's order."""
    legs = [("", ("resnet_step", {"layout": "2d"}))]
    if n_devices % 8 == 0:
        legs.append((" 3d", ("resnet_step", {"layout": "3d"})))
    legs += [(" sp", ("sp_step", {"sp": sp})) for sp in (2, 4, 8)
             if n_devices % sp == 0]
    if n_devices % 4 == 0:
        legs += [(" sp+flash", ("sp_step", {"sp": 4, "use_flash": True})),
                 (" sp-ulysses", ("sp_step", {"sp": 4,
                                              "seq_mode": "ulysses"})),
                 (" sp+gqa", ("sp_step", {"sp": 4, "kv_heads": 2}))]
    if n_devices % 2 == 0:
        legs.append((" gang", ("resnet_step", {
            "layout": "gang", "gang_env": env or gang_env(n_devices)})))
    return legs


def dryrun_lines(names: list[str], results: list[dict]) -> list[str]:
    """The JAX dry run's lines for rank 0's ``results`` of the legs
    ``names``; raises on a loss that is not finite."""
    lines = []
    for name, r in zip(names, results):
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"dry run leg{name}: loss {r['loss']}")
        bounds = f" process_bounds={r['bounds']}" if r.get("bounds") else ""
        lines.append(f"dryrun_multichip{name} ok:{bounds} mesh={r['mesh']} "
                     f"loss={r['loss']:.4f}")
    return lines


def dryrun_multichip(n_devices: int) -> list[str]:
    """Run every leg on ``n_devices`` CPU ranks and print one line each;
    returns the lines."""
    legs = dryrun_legs(n_devices)
    results = spawn(n_devices, [leg for _, leg in legs])[0]
    lines = dryrun_lines([name for name, _ in legs], results)
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    dryrun_multichip(8)
