"""The flagship model as one call: ResNet-50 bf16 forward, batch 8 @ 224.

Counterpart of ``__graft_entry__.entry()`` at the repo root.
"""

from __future__ import annotations

import torch

from .workloads import harness
from .workloads.resnet import resnet50


def entry(device: str = "cuda"):
    """(forward fn, example args): ``fn(*args)`` returns [8, 1000] fp32
    logits of a ResNet-50 with random weights from seed 0."""
    model = harness.init_model(resnet50(dtype=torch.bfloat16), 0, device)
    x = torch.ones(8, 224, 224, 3, dtype=torch.bfloat16, device=device)
    return harness.make_infer_fn(model), (x,)
