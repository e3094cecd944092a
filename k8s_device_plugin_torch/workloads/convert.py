"""Flax variables and JAX parameter pytrees (as numpy arrays) -> PyTorch
state_dicts.

The port's modules take the Flax module names as their attribute names
(``stage1_block1.conv1``, ``cell``, ``head``), so a variable's path maps to
its state_dict key directly and only the leaf changes:

* conv ``kernel`` [H, W, I, O] -> ``weight`` [O, I, H, W];
* ``Dense`` ``kernel`` [in, out] -> ``Linear`` ``weight`` [out, in];
* BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats) -> ``weight``/``bias``/``running_mean``/``running_var``,
  plus the ``num_batches_tracked`` counter PyTorch keeps;
* anything else (the fused LSTM cell's ``wx``/``wh``/``b``, in [i|f|g|o]
  order) as it is: the kernel takes the Flax layout.

The stock LSTM layout's ``OptimizedLSTMCell_0.{ii,if,ig,io,hi,hf,hg,ho}``
kernels are ``Dense`` kernels like any other, and the port's stock cell
keeps that module name (``lstm.STOCK_CELL``), so both LSTM layouts carry
across by the same rules.

VGG-16's ``fc1`` needs no reordering: Flax flattens the NHWC activation,
so its 25,088 rows run in (h, w, c) order, and the port flattens the
channels-last view in the same order (``vgg.VGG16``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def flax_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy
    arrays; any collection works) to a state_dict for the port's module.
    Arrays keep their dtype."""
    out: dict[str, torch.Tensor] = {}
    for collection in variables.values():
        for path, arr in _leaves(collection):
            *module, leaf = path
            if leaf == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and arr.ndim == 2:
                arr = arr.T
            name = "weight" if leaf == "kernel" else _RENAME.get(leaf, leaf)
            out[".".join([*module, name])] = torch.tensor(arr)
            if leaf == "mean":
                out[".".join([*module, "num_batches_tracked"])] = \
                    torch.zeros((), dtype=torch.long)
    return out


def lm_params_to_state_dict(params: Mapping[str, Any]
                            ) -> dict[str, torch.Tensor]:
    """The JAX LM pytree (``{"embed": ..., "layers": [{...}, ...]}``, numpy
    arrays) -> a state_dict for ``attention.LM``: the same names and the
    same [in, out] layout, so only the paths flatten (``layers.0.qkv``);
    both the fused MHA and the GQA layout, and the MoE LM's nested
    ``moe`` dicts (``layers.0.moe.w_in``). Arrays keep their dtype."""
    out = {"embed": torch.tensor(np.asarray(params["embed"]))}
    for i, lyr in enumerate(params["layers"]):
        for path, arr in _leaves(lyr):
            out[".".join(["layers", str(i), *path])] = torch.tensor(arr)
    return out


#: the MoE LM pytree (``{embed, layers: [{qkv, proj, moe: {gate, w_in,
#: w_out}}]}``) -> a state_dict for ``moe.MoELM``: the same flattening
moe_lm_params_to_state_dict = lm_params_to_state_dict
