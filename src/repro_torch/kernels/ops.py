"""Public kernel ops: dispatch by device.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the CPU
goes to the plain PyTorch version in :mod:`.ref`.  A per-call ``impl="ref"``
runs the plain version on any device (the kernel-against-plain comparisons on
the card use it).  Nothing here falls back from a kernel to the plain version:
a kernel wrapper raises on what it cannot take.

The reference's global kernel mode, its ``custom_vjp``s and the Myia primitive
registration wait for the training and Myia slices: serving needs no gradient.
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_fwd
from .rmsnorm import rmsnorm_fwd

__all__ = ["flash_attention", "rmsnorm", "IMPLS"]

IMPLS = (None, "ref")


def _use_kernel(x: torch.Tensor, impl: str | None) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl is None and x.device.type != "cpu"


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    sm_scale: float | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """GQA attention. q: (B,H,Sq,D); k,v: (B,KVH,Skv,D) → (B,H,Sq,D)."""
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if _use_kernel(q, impl):
        return flash_attention_fwd(q, k, v, causal=bool(causal), window=window, sm_scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=bool(causal), window=window, sm_scale=scale)


def rmsnorm(
    x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, impl: str | None = None
) -> torch.Tensor:
    """RMSNorm over the last axis."""
    if _use_kernel(x, impl):
        return rmsnorm_fwd(x, w, eps=float(eps))
    return ref.rmsnorm_ref(x, w, float(eps))
