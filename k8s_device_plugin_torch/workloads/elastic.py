"""Elastic gang resize, workload side: checkpoint, re-plan, resume.

Counterpart of ``k8s_device_plugin_tpu/workloads/elastic.py``. The
scheduler's ``resize_gang`` rolls a gang back after stamping
``vtpu.io/gang-resize`` on every member, which the device plugin renders
into the container as ``VTPU_GANG_RESIZE``: the checkpoint signal. The
worker polls it between steps, saves a sharded checkpoint from the old
mesh (``checkpoint.py``: each rank writes its own blocks), and when the
gang re-gathers at the new shape, a fresh model and optimizer sharded for
the new mesh restore it. The resized gang continues the loss trajectory
from the saved step; it does not retrain.
"""

from __future__ import annotations

import os

from .checkpoint import restore_checkpoint, save_checkpoint

#: the env var that carries the resize signal into the container (the
#: device plugin renders the vtpu.io/gang-resize annotation through the
#: gang env, like the worker-identity variables)
RESIZE_SIGNAL_ENV = "VTPU_GANG_RESIZE"


def resize_signal() -> int:
    """The size a pending elastic resize asks for (0: none). A malformed
    or negative value reads as no signal: a worker must never crash on a
    half-written annotation."""
    try:
        return max(0, int(os.environ.get(RESIZE_SIGNAL_ENV, "0")))
    except ValueError:
        return 0


def checkpoint_for_resize(path: str, model, optimizer, state: dict,
                          mesh) -> None:
    """The hand-off's first half, on the old mesh: one sharded checkpoint
    of the train state, each rank writing its own blocks."""
    save_checkpoint(path, model, optimizer, state, mesh)


def resume_on_new_shape(path: str, model, optimizer, new_mesh) -> dict:
    """The hand-off's second half, by the gang re-gathered at the new
    shape: ``model`` and ``optimizer`` fresh and sharded for ``new_mesh``,
    each rank reading the blocks of its own shard. Returns the train
    state."""
    return restore_checkpoint(path, model, optimizer, new_mesh)


def checkpoint_replan_resume(path: str, model, optimizer, state: dict,
                             mesh, new_model, new_optimizer,
                             new_mesh) -> dict:
    """Both halves in one call, for tests and simple workloads whose world
    holds both meshes: save from ``mesh``, restore into ``new_model`` and
    ``new_optimizer`` on ``new_mesh``. A resize to another number of ranks
    runs the halves in different worlds (the old shape's workers save and
    exit; the new shape's restore)."""
    checkpoint_for_resize(path, model, optimizer, state, mesh)
    return resume_on_new_shape(path, new_model, new_optimizer, new_mesh)
