"""Sharded training checkpoint and resume.

Counterpart of ``k8s_device_plugin_tpu/workloads/checkpoint.py``. A
training job on a granted slice must survive eviction, and resume on
whatever slice shape it is given next. The port's train state is the
model's ``state_dict()`` (parameters and BatchNorm statistics), the
optimizer's per-parameter state (SGD's momentum buffers) and
``state["step"]``; all three are saved.

``torch.distributed.checkpoint`` writes it: every rank writes only its
own blocks (a tensor replicated over ranks is written once), and no rank
gathers the model. The tensors a mesh splits (``model.shard_specs``, set
by ``harness.shard_params``: the head's columns over ``mp``, expert and
stage stacks) go in as ``DTensor.from_local`` of the rank's block with the
global shape they were cut from; the wrapping is only at this boundary.
Restore reads, on each rank, the blocks that overlap the rank's own under
the target mesh, so a checkpoint saved from one mesh shape restores onto
another; with no mesh a single process reads the whole tensors.

Resume order: build a fresh model and optimizer for the target mesh,
shard them there (``harness.shard_train_step`` or
``harness.shard_params``), then restore straight into the sharded shapes.
``torch.optim.SGD`` makes a momentum buffer lazily and takes a missing one
for the first step (buffer = gradient), so restore puts every saved buffer
back into ``optimizer.state`` before the first step.
"""

from __future__ import annotations

import torch
import torch.distributed.checkpoint as dcp
from torch import nn
from torch.distributed.checkpoint.metadata import TensorStorageMetadata


def _dtensor(t: torch.Tensor, mesh, spec: tuple):
    """``t`` as the DTensor of its spec on ``mesh`` when the spec splits
    it, else ``t`` (written once, read whole)."""
    if mesh is None or not any(spec):
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    placements = [Shard(spec.index(axis)) if axis in spec else Replicate()
                  for axis in mesh.mesh_dim_names]
    return DTensor.from_local(t, mesh, placements, run_check=False)


def _specs(model: nn.Module, mesh) -> dict:
    return getattr(model, "shard_specs", {}) if mesh is not None else {}


def save_checkpoint(path: str, model: nn.Module, optimizer, state: dict,
                    mesh=None) -> None:
    """Write one checkpoint of the train state into the new directory
    ``path``. With a ``mesh`` every rank of the world calls it and writes
    its own blocks; with none this process writes everything alone."""
    specs = _specs(model, mesh)
    names = {p: name for name, p in model.named_parameters()}
    entries = {f"model.{name}": _dtensor(t, mesh, specs.get(name, ()))
               for name, t in model.state_dict().items()}
    if optimizer is not None:
        for p, st in optimizer.state.items():
            spec = specs.get(names[p], ())
            for key, val in st.items():
                if not torch.is_tensor(val):
                    raise TypeError(f"optimizer state {key} of {names[p]} "
                                    f"is not a tensor")
                entries[f"optim.{names[p]}.{key}"] = _dtensor(
                    val, mesh, spec) if val.shape == p.shape else val
    entries["step"] = int(state["step"])
    dcp.save(entries, checkpoint_id=path, no_dist=mesh is None)


def restore_checkpoint(path: str, model: nn.Module, optimizer=None,
                       mesh=None) -> dict:
    """Read the checkpoint at ``path`` into ``model`` (sharded for
    ``mesh`` by ``harness.shard_params``, or whole with no mesh) and the
    per-parameter state of ``optimizer``, in place; returns the train state
    ``{"step": ...}``. With a ``mesh`` every rank of the world calls it.
    Raises if the checkpoint lacks a tensor of the model or cannot be
    read."""
    specs = _specs(model, mesh)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    entries = {}
    for name, t in model.state_dict().items():
        if f"model.{name}" not in saved:
            raise KeyError(f"checkpoint {path} has no {name}")
        entries[f"model.{name}"] = _dtensor(t, mesh, specs.get(name, ()))
    buffers = []  # (param, state key, the local tensor the load fills)
    if optimizer is not None:
        for name, p in model.named_parameters():
            spec = specs.get(name, ())
            whole = _dtensor(p.detach(), mesh, spec).shape
            for key in (k for k in saved if k.startswith(f"optim.{name}.")):
                meta = saved[key]
                if not isinstance(meta, TensorStorageMetadata):
                    raise TypeError(f"checkpoint {path}: {key} is not a "
                                    f"tensor")
                if meta.size == whole:  # shaped, and split, as the param
                    local = torch.empty_like(p.detach())
                    entries[key] = _dtensor(local, mesh, spec)
                else:
                    local = entries[key] = torch.empty(
                        meta.size, dtype=meta.properties.dtype,
                        device=p.device)
                buffers.append((p, key.rpartition(".")[2], local))
    entries["step"] = 0
    dcp.load(entries, checkpoint_id=path, no_dist=mesh is None)
    for p, key, local in buffers:
        optimizer.state[p][key] = local
    return {"step": entries["step"]}
