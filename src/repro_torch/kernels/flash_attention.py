"""FlashAttention forward: the wrapper of the CUDA kernel in ``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention.flash_attention_fwd``.  The plain PyTorch
version is :func:`repro_torch.kernels.ref.flash_attention_ref`;
:func:`repro_torch.kernels.ops.flash_attention` chooses between them by device.
Unlike the TPU kernel, any ``Sq`` and ``Skv`` work: the kernel masks the ragged
edge itself.  With ``return_lse`` the kernel also writes each row's logsumexp, the
residual of the chunked backward (``ref.flash_attention_bwd_chunked``).
"""

from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_CODES = {t: build.DTYPE_CODES[name] for t, name in _DTYPES.items()}

#: head_dim values the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)

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
