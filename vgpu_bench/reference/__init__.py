"""Plain fp32 PyTorch references of the benchmark's models.

Each ``<model>.py`` gives ``layout(cfg)``, the weights in the port's own
parameter layout (name: shape, served dtype, initializer), and
``forward(weights, x, cfg, precision)``, the model written from its
published description in plain ``torch`` operations. ``precision`` is
``"fp32"`` (the reference) or ``"fp8"`` (the control: every product's
operands rounded to float8 e4m3 with one scale per tensor). Nothing here
imports the port.
"""

import torch

#: largest finite float8 e4m3 value
FP8_MAX = 448.0


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` (fp32) as the product in ``precision`` would read it."""
    if precision == "fp32":
        return t
    if precision != "fp8":
        raise ValueError(f"no precision {precision!r}")
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def strict_fp32() -> None:
    """Products in full fp32: TF32 would round their inputs to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
