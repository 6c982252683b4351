"""The precision controls: the reference's products taken one precision below what a
configuration states, the step a later change might be tempted to take.

``fp8_mm`` is for a bfloat16 configuration: both operands of every product are rounded
to float8 e4m3 with one scale per tensor (its largest magnitude mapped to e4m3's 448),
then multiplied in f32; the backward's products take the f32 gradient.  The f32
configuration's control is TF32, a flag of the
reference itself (``myia_lm.train_readings(tf32=True)``).
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, returned in f32.  The gradient
    passes the rounding unchanged, in f32, as fp8 training's does."""
    x = x.float()
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to_fp8(a) @ to_fp8(b)
