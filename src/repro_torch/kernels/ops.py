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

* SSD scan: ``None`` is K5 forward on a CUDA tensor and its plain version
  (:func:`ref.ssd_scan_ref`) on the CPU, with the backward by autograd through the
  plain chunked version (chunk :data:`SSD_CHUNK`); ``"chunked"`` is plain autograd
  through the chunked version and ``"ref"`` through the stepwise one.

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
from .ssd_scan import ssd_scan_fwd

__all__ = ["flash_attention", "rmsnorm", "ssd_scan", "ssd_step", "IMPLS", "SSD_CHUNK"]

IMPLS = (None, "ref", "chunked")

#: Chunk length of the plain chunked SSD (``impl="chunked"`` and the backward), the
#: reference's default (``REPRO_SSD_CHUNK``, ops.py).
SSD_CHUNK = 128


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


# ===========================================================================
# SSD scan (Mamba-2)
# ===========================================================================


def _ssd_chunked(x, dt, A, B, C):
    return ref.ssd_scan_ref_chunked(x, dt, A, B, C, chunk=SSD_CHUNK)


class _SSDScan(torch.autograd.Function):
    """Forward: K5 (``kernel``) or its plain version, y only.  Backward: autograd
    through the plain chunked version from the saved inputs, whose residuals are
    per-chunk states rather than per-step ones (the reference's ``_ssd_bwd_vjp``)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, kernel):
        ctx.save_for_backward(x, dt, A, B, C)
        return (ssd_scan_fwd if kernel else ref.ssd_scan_ref)(x, dt, A, B, C)[0]

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = _ssd_chunked(*inputs)[0]
        grads = torch.autograd.grad(y, inputs, dy, allow_unused=True)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    *,
    return_final_state: bool = False,
    impl: str | None = None,
):
    """Mamba-2 SSD over a sequence.  x: (Bt,S,H,P); dt: (Bt,S,H); A: (H,);
    B, C: (Bt,S,G,N).  Returns y (Bt,S,H,P) in x.dtype, or with
    ``return_final_state`` the serving form ``(y, final state (Bt,H,N,P) f32)``,
    which is not differentiable through the kernel (as in the reference)."""
    kernel = _use_kernel(x, impl)
    fwd = ssd_scan_fwd if kernel else _ssd_chunked if impl == "chunked" else ref.ssd_scan_ref
    if return_final_state:
        if kernel and _needs_grad(x, dt, A, B, C):
            raise ValueError("ssd_scan with return_final_state is not differentiable")
        return fwd(x, dt, A, B, C)
    if impl is None and _needs_grad(x, dt, A, B, C):
        return _SSDScan.apply(x, dt, A, B, C, kernel)
    return fwd(x, dt, A, B, C)[0]  # "ref" and "chunked": plain autograd


def ssd_step(h, x_t, dt_t, A, B_t, C_t):
    """One decode step, the state carried explicitly: plain PyTorch on any device,
    as in the reference (the update is a small elementwise, bandwidth-bound pass)."""
    return ref.ssd_step_ref(h, x_t, dt_t, A, B_t, C_t)
