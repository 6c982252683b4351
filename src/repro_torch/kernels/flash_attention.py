"""FlashAttention: the wrappers of the CUDA kernels in ``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention.flash_attention_fwd``.  The plain PyTorch
version is :func:`repro_torch.kernels.ref.flash_attention_ref`;
:func:`repro_torch.kernels.ops.flash_attention` chooses between them by device.
Unlike the TPU kernel, any ``Sq`` and ``Skv`` work: the kernel masks the ragged
edge itself.  With ``return_lse`` the kernel also writes each row's logsumexp, the
residual of the backward.

:func:`flash_attention_bwd` is the backward in bf16 at head_dim 64 and 128, on the
tensor cores, from the forward's saved ``(q, k, v, o, lse)``; the JAX package has no
kernel for it (its backward is the plain chunked math that
:func:`repro_torch.kernels.ref.flash_attention_bwd_chunked` ports, which the other
dtypes and head_dims take).
"""

from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_CODES = {t: build.DTYPE_CODES[name] for t, name in _DTYPES.items()}

#: head_dim values the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)

#: head_dim values the backward kernel is instantiated for (bf16 only)
BWD_HEAD_DIMS = (64, 128)
#: query rows of the backward's tiles (``kBwdQ`` in ``csrc/flash_attention.cu``): the
#: wrapper pads the kernels' scratch rows to a multiple of it
BWD_QUERY_TILE = 64

#: dynamic shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232_448


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    """What the kernel takes: q (B,H,Sq,D), k/v (B,KVH,Skv,D), one dtype, contiguous."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B,H,Sq,D) and k, v (B,KVH,Skv,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {k.shape[1]}")
    if k.shape[2] == 0:
        raise ValueError("flash_attention_fwd needs at least one key")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must all be float32 or all bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} has no kernel instantiation; supported: {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd needs contiguous q, k and v")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive number of positions, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")


#: the (device, head_dim, dtype code) keys whose shared memory a block takes
#: (``flash_attention_fwd_smem``) has been checked against the card's limit
_SMEM_CHECKED: set[tuple[int, int, int]] = set()


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    sm_scale: float | None = None,
    return_lse: bool = False,
):
    """Launch the CUDA kernel.  q: (B, H, Sq, D); k, v: (B, KVH, Skv, D) → (B, H, Sq, D).

    With ``return_lse`` returns ``(o, lse)``, lse (B, H, Sq, 1) f32 as the reference's
    ``flash_attention_fwd_lse_chunked`` gives it: ``m + log(l)`` in scaled-score units
    (``-1e30`` on a row with no visible column, where the twin has ``log`` of the
    number of columns; no causal or windowed row is fully masked).

    The launch is kept lean, as K2's and K3's are: the library is ``build.load``'s
    handle, the shared-memory check runs once per (device, head_dim, dtype), and the
    stream is read as a raw handle without entering a device context (unless q lies on
    another device than the current one)."""
    check_args(q, k, v, window)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_fwd launches a CUDA kernel; q lies on {q.device}")
    device = q.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return flash_attention_fwd(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                                       return_lse=return_lse)
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq, 1), dtype=torch.float32, device=q.device) if return_lse else None
    if B == 0 or H == 0 or Sq == 0:
        return (o, lse) if return_lse else o
    lib = build.load()
    code = _CODES[q.dtype]
    if (device, D, code) not in _SMEM_CHECKED:
        smem = lib.flash_attention_fwd_smem(D, code)
        if not 0 < smem <= SMEM_LIMIT:
            raise ValueError(
                f"flash_attention_fwd tiles need {smem} bytes of shared memory at head_dim {D} "
                f"and {q.dtype}; a block may use {SMEM_LIMIT}"
            )
        _SMEM_CHECKED.add((device, D, code))
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (D**0.5)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None, B, H, KVH, Sq, Skv, D, code, int(bool(causal)),
        -1 if window is None else int(window), scale, torch._C._cuda_getCurrentRawStream(device),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA error {err}")
    build.LAUNCHES["flash_attention_fwd"] += 1
    return (o, lse) if return_lse else o


def check_bwd_args(q, k, v, o, lse, do, window: int | None) -> None:
    """What the backward kernel takes: the forward's arguments (``check_args``) in bf16
    at head_dim 64 or 128, o and do shaped as q, lse (B, H, Sq, 1) f32, all contiguous
    and on one device."""
    check_args(q, k, v, window)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd takes bfloat16 q, k, v; got {q.dtype}")
    if q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(
            f"head_dim {q.shape[3]} has no backward instantiation; supported: {BWD_HEAD_DIMS}"
        )
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(
                f"{name} must be {q.dtype} of q's shape {tuple(q.shape)}; got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    if lse.shape != (*q.shape[:3], 1) or lse.dtype != torch.float32:
        raise ValueError(
            f"lse must be float32 of shape {(*q.shape[:3], 1)}; got {lse.dtype} "
            f"{tuple(lse.shape)}"
        )
    if not (o.is_contiguous() and do.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd needs contiguous o, do and lse")
    if not (q.device == o.device == do.device == lse.device):
        raise ValueError(f"q, o, do, lse lie on {q.device}, {o.device}, {do.device}, {lse.device}")


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the forward's saved ``(q, k, v, o, lse)`` (lse as
    ``flash_attention_fwd(..., return_lse=True)`` writes it) and the output's gradient
    ``do``.  Returns ``(dq, dk, dv)`` in bf16, shaped as q, k, v.

    The wrapper allocates the kernels' scratch: delta and lse rows padded to
    :data:`BWD_QUERY_TILE` and the f32 dQ workspace, zeroed.  dK and dV are summed in a
    fixed order.  dQ's f32 sums over the key tiles arrive in an order that changes from
    call to call (two calls agree to rounding), unless
    ``torch.are_deterministic_algorithms_enabled()``: then the adds into each (q head,
    query tile) of the workspace take turns in key-tile order, counted in a zeroed int32
    a tile, and two calls are bitwise equal (``PERF.md`` §6 gives what that costs)."""
    check_bwd_args(q, k, v, o, lse, do, window)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd launches a CUDA kernel; q lies on {q.device}")
    device = q.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                       sm_scale=sm_scale)
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or H == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = build.load()
    sq_pad = -(-Sq // BWD_QUERY_TILE) * BWD_QUERY_TILE
    rows = torch.empty((2, B, H, sq_pad), dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros((B, H, sq_pad, D), dtype=torch.float32, device=q.device)
    ordered = torch.are_deterministic_algorithms_enabled()
    turns = torch.zeros((B, H, sq_pad // BWD_QUERY_TILE), dtype=torch.int32,
                        device=q.device) if ordered else None
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (D**0.5)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(),
        dq_acc.data_ptr(), turns.data_ptr() if ordered else None, B, H, KVH, Sq, Skv, D,
        int(bool(causal)), -1 if window is None else int(window), int(ordered), scale,
        torch._C._cuda_getCurrentRawStream(device),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed with CUDA error {err}")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
