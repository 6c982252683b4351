"""Public kernel ops: dispatch by device, and gradients.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the CPU
goes to the plain PyTorch version in :mod:`.ref`.  Nothing here falls back from
a kernel to the plain version: a kernel wrapper raises on what it cannot take.

Gradients: one ``torch.autograd.Function`` per op, the port of the reference's
``custom_vjp``s (``repro/kernels/ops.py``).  ``impl`` picks the implementation:

* ``None``      — the kernels on a CUDA tensor (the reference's ``pallas`` mode):
                  rmsnorm is K2 forward and K3 backward; attention is K4 forward,
                  which also writes the row logsumexp, and the plain chunked
                  backward on ``(q, k, v, o, lse)``.  On a CPU tensor rmsnorm runs
                  the same Function with the plain versions of K2 and K3 (the
                  reference's ``pallas_interpret`` math), and attention is plain
                  autograd through :func:`ref.flash_attention_ref`.
* ``"chunked"`` — attention through the same Function with the plain chunked
                  forward (``flash_attention_fwd_lse_chunked``), on any device;
                  rmsnorm as ``"ref"``, as in the reference.
* ``"ref"``     — plain autograd through the plain versions, on any device (the
                  reference's naive ``ref`` mode).

Without a gradient to take (``no_grad``, inference mode, or no operand that
requires one) the ops run the forward alone: the attention kernel writes no
logsumexp and nothing is saved.  The reference's global kernel mode and the Myia
primitive registration wait for the Myia slice.
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_fwd
from .rmsnorm import rmsnorm_bwd, rmsnorm_fwd

__all__ = ["flash_attention", "rmsnorm", "IMPLS"]

IMPLS = (None, "ref", "chunked")


def _use_kernel(x: torch.Tensor, impl: str | None) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl is None and x.device.type != "cpu"


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ===========================================================================
# flash attention
# ===========================================================================


class _FlashAttention(torch.autograd.Function):
    """Forward: K4 with its logsumexp (``kernel``) or the plain chunked twin.
    Backward: the plain chunked backward from the saved ``(q, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kernel):
        if kernel:
            o, lse = flash_attention_fwd(
                q, k, v, causal=causal, window=window, sm_scale=scale, return_lse=True
            )
        else:
            o, lse = ref.flash_attention_fwd_lse_chunked(
                q, k, v, causal=causal, window=window, sm_scale=scale
            )
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd_chunked(
            q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window, sm_scale=ctx.scale
        )
        return dq, dk, dv, None, None, None, None


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
    causal = bool(causal)
    kernel = _use_kernel(q, impl)
    if impl == "ref" or (impl is None and not kernel):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, sm_scale=scale)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, scale, kernel)
    if kernel:
        return flash_attention_fwd(q, k, v, causal=causal, window=window, sm_scale=scale)
    return ref.flash_attention_ref_chunked(q, k, v, causal=causal, window=window, sm_scale=scale)


# ===========================================================================
# rmsnorm
# ===========================================================================


class _RMSNorm(torch.autograd.Function):
    """Forward: K2 (``kernel``) or its plain version.  Saves ``(x, w)``, as the
    reference does.  Backward: K3 (``kernel``) or its plain version."""

    @staticmethod
    def forward(ctx, x, w, eps, kernel):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.kernel = eps, kernel
        return rmsnorm_fwd(x, w, eps=eps) if kernel else ref.rmsnorm_ref(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.kernel:
            dx, dw = rmsnorm_bwd(x, w, dy, eps=ctx.eps)
        else:
            dx, dw = ref.rmsnorm_bwd_ref(x, w, dy, ctx.eps)
        return dx, dw, None, None


def rmsnorm(
    x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, impl: str | None = None
) -> torch.Tensor:
    """RMSNorm over the last axis."""
    kernel = _use_kernel(x, impl)
    eps = float(eps)
    if impl is not None:  # "ref" and "chunked": plain autograd, as in the reference
        return ref.rmsnorm_ref(x, w, eps)
    if _needs_grad(x, w):
        return _RMSNorm.apply(x, w, eps, kernel)
    return rmsnorm_fwd(x, w, eps=eps) if kernel else ref.rmsnorm_ref(x, w, eps)

