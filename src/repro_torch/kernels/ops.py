"""Public kernel ops: dispatch by device, and gradients.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the CPU
goes to the plain PyTorch version in :mod:`.ref`.  Nothing here falls back from
a kernel to the plain version: a kernel wrapper raises on what it cannot take.

Gradients: one ``torch.autograd.Function`` per op, the port of the reference's
``custom_vjp``s (``repro/kernels/ops.py``).  ``impl`` picks the implementation:

* ``None``      — the kernels on a CUDA tensor (the reference's ``pallas`` mode):
                  rmsnorm is K2 forward and K3 backward; attention is K4 forward,
                  which also writes the row logsumexp, and a backward on
                  ``(q, k, v, o, lse)`` chosen by :func:`attn_bwd_route`: K4's
                  tensor-core backward in bf16 at head_dim 64 and 128, the plain
                  chunked backward otherwise.  On a CPU tensor rmsnorm runs
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
logsumexp and nothing is saved.

The global kernel mode (:func:`set_kernel_mode`, the reference's
``MYIA_KERNEL_MODE``) takes the values of :data:`IMPLS`: ``None`` (the default:
the kernels on CUDA tensors), ``"ref"`` or ``"chunked"``.  The Myia primitives
registered at the end of this module (``flash_attention``, ``rmsnorm``,
``ssd_scan`` and their ``*_vjp``) run the ops in that mode, so ``grad`` through
the Myia compiler reaches K2–K5, and the fused clusters of
:mod:`.codegen` run their torch oracles in modes ``"ref"`` and ``"chunked"``.
The reference's ``"pallas_interpret"`` has no counterpart: it raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.primitives import register_primitive, zeros_like
from repro_torch.obs import trace as obs_trace
from . import build, ref
from .flash_attention import BWD_HEAD_DIMS, flash_attention_bwd, flash_attention_fwd
from .rmsnorm import rmsnorm_bwd, rmsnorm_fwd
from .ssd_scan import ssd_scan_fwd

__all__ = [
    "flash_attention", "rmsnorm", "ssd_scan", "ssd_step", "IMPLS", "SSD_CHUNK",
    "attn_bwd_route", "get_kernel_mode", "set_kernel_mode",
]

IMPLS = (None, "ref", "chunked")

_MODE: str | None = None


def set_kernel_mode(mode: str | None) -> None:
    """The implementation the Myia primitives and fused clusters run: one of
    :data:`IMPLS` (``None``: the kernels on CUDA tensors)."""
    global _MODE
    if mode not in IMPLS:
        raise ValueError(
            f"kernel mode must be one of {IMPLS}, got {mode!r} (the reference's Pallas "
            "modes have no counterpart in the port)"
        )
    _MODE = mode


def get_kernel_mode() -> str | None:
    return _MODE

#: Chunk length of the plain chunked SSD (``impl="chunked"`` and the backward), the
#: reference's default (``REPRO_SSD_CHUNK``, ops.py).
SSD_CHUNK = 128


def _use_kernel(x: torch.Tensor, impl: str | None) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl is None and x.device.type == "cuda"  # meta tensors (inference): plain


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ===========================================================================
# flash attention
# ===========================================================================


def attn_bwd_route(q: torch.Tensor, kernel: bool) -> str:
    """The attention backward's route, from what the Function sees: ``"kernel"`` (K4's
    tensor-core backward) for a forward that ran K4 (``kernel``) on bf16 at a head_dim
    of :data:`flash_attention.BWD_HEAD_DIMS`; ``"chunked"`` (the plain chunked backward)
    for every other dtype and head_dim and for the plain chunked forward
    (``impl="chunked"``).  The kernel has no f32 or other head_dim instantiation: those
    take this route by choice, never by a fallback on error."""
    if kernel and q.dtype == torch.bfloat16 and q.shape[-1] in BWD_HEAD_DIMS:
        return "kernel"
    return "chunked"


class _FlashAttention(torch.autograd.Function):
    """Forward: K4 with its logsumexp (``kernel``) or the plain chunked twin.
    Backward: from the saved ``(q, k, v, o, lse)``, on :func:`attn_bwd_route`'s route,
    counted in ``build.ATTN_BWD_ROUTES``."""

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
        ctx.causal, ctx.window, ctx.scale, ctx.kernel = causal, window, scale, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        route = attn_bwd_route(q, ctx.kernel)
        build.ATTN_BWD_ROUTES[route] += 1
        with obs_trace.span("attn.bwd"):
            if route == "kernel":
                dq, dk, dv = flash_attention_bwd(
                    q, k, v, o, lse, do.contiguous(), causal=ctx.causal, window=ctx.window,
                    sm_scale=ctx.scale,
                )
            else:
                dq, dk, dv = ref.flash_attention_bwd_chunked(
                    q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window,
                    sm_scale=ctx.scale,
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


# ===========================================================================
# Myia primitive registration (paper §3: kernels as primitives with known
# backpropagators; bprops are Myia-subset functions, so reverse-over-reverse
# stays possible through *other* ops while kernel vjps terminate the chain).
# The primitives run the ops in the global kernel mode; a vjp primitive takes
# the op's own gradient (its autograd Function: K3, the attention backward on its
# route, the chunked SSD backward) from the saved inputs.
# ===========================================================================


def _vjp(fn, inputs: tuple, dout) -> tuple:
    ins = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        out = fn(*ins)
    grads = torch.autograd.grad(out, ins, dout, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(grads, inputs))


def _prim_flash_impl(q, k, v, causal, window, sm_scale):
    return flash_attention(
        q, k, v, causal=causal, window=window, sm_scale=sm_scale, impl=get_kernel_mode()
    )


def _prim_flash_vjp_impl(q, k, v, causal, window, sm_scale, dout):
    return _vjp(lambda *a: _prim_flash_impl(*a, causal, window, sm_scale), (q, k, v), dout)


flash_attention_vjp = register_primitive(
    "flash_attention_vjp", _prim_flash_vjp_impl, bprop="zeros"
)


def _bprop_flash_attention(q, k, v, causal, window, sm_scale, out, dout):
    g = flash_attention_vjp(q, k, v, causal, window, sm_scale, dout)
    return (
        g[0],
        g[1],
        g[2],
        zeros_like(causal),
        zeros_like(window),
        zeros_like(sm_scale),
    )


flash_attention_prim = register_primitive(
    "flash_attention", _prim_flash_impl, bprop=_bprop_flash_attention
)


def _prim_rmsnorm_impl(x, w, eps):
    return rmsnorm(x, w, eps=eps, impl=get_kernel_mode())


def _prim_rmsnorm_vjp_impl(x, w, eps, dy):
    return _vjp(lambda a, b: _prim_rmsnorm_impl(a, b, eps), (x, w), dy)


rmsnorm_vjp = register_primitive("rmsnorm_vjp", _prim_rmsnorm_vjp_impl, bprop="zeros")


def _bprop_rmsnorm(x, w, eps, out, dout):
    g = rmsnorm_vjp(x, w, eps, dout)
    return (g[0], g[1], zeros_like(eps))


rmsnorm_prim = register_primitive("rmsnorm", _prim_rmsnorm_impl, bprop=_bprop_rmsnorm)


def _prim_ssd_impl(x, dt, A, B, C):
    return ssd_scan(x, dt, A, B, C, impl=get_kernel_mode())


def _prim_ssd_vjp_impl(x, dt, A, B, C, dy):
    return _vjp(_prim_ssd_impl, (x, dt, A, B, C), dy)


ssd_scan_vjp = register_primitive("ssd_scan_vjp", _prim_ssd_vjp_impl, bprop="zeros")


def _bprop_ssd_scan(x, dt, A, B, C, out, dout):
    g = ssd_scan_vjp(x, dt, A, B, C, dout)
    return (g[0], g[1], g[2], g[3], g[4])


ssd_scan_prim = register_primitive("ssd_scan", _prim_ssd_impl, bprop=_bprop_ssd_scan)
