"""Mamba-2 SSD scan, forward: the wrapper of the CUDA kernel in ``csrc/ssd_scan.cu``.

Port of ``repro.kernels.ssd_scan.ssd_scan_fwd`` (K5).  The plain PyTorch version is
:func:`repro_torch.kernels.ref.ssd_scan_ref`, the stepwise recurrence the kernel is
held against; :func:`repro_torch.kernels.ops.ssd_scan` chooses between them by
device.  Unlike the TPU kernel, any sequence length works: the kernel zero-pads
the ragged last chunk itself.
"""

from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

#: dynamic shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232_448


def check_args(x, dt, A, B, C) -> None:
    """What the kernel takes: x (Bt,S,H,P) and B, C (Bt,S,G,N) of one dtype (f32 or
    bf16), dt (Bt,S,H) f32, A (H,) f32; H a multiple of G; N and P multiples of 4;
    all contiguous, on one device."""
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(
            f"need x (Bt,S,H,P), dt (Bt,S,H), A (H,), B and C (Bt,S,G,N); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, {tuple(B.shape)}, "
            f"{tuple(C.shape)}"
        )
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (Bt, S, H) or tuple(A.shape) != (H,) or B.shape[:2] != (Bt, S):
        raise ValueError(
            f"dt {tuple(dt.shape)}, A {tuple(A.shape)} or B/C {tuple(B.shape)} do not match "
            f"x {tuple(x.shape)}"
        )
    if G == 0 or H % G:
        raise ValueError(f"heads {H} are not a multiple of groups {G}")
    if N % 4 or P % 4 or N == 0 or P == 0:
        raise ValueError(f"ssd_scan_fwd takes N and P that are multiples of 4; got N={N}, P={P}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(
            f"x, B, C must all be float32 or all bfloat16; got {x.dtype}, {B.dtype}, {C.dtype}"
        )
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan_fwd takes float32 dt and A; got {dt.dtype}, {A.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan_fwd needs contiguous x, dt, A, B and C")
    if not (x.device == dt.device == A.device == B.device == C.device):
        raise ValueError(
            f"x, dt, A, B, C lie on {x.device}, {dt.device}, {A.device}, {B.device}, {C.device}"
        )


def ssd_scan_fwd(x, dt, A, B, C) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  Returns (y (Bt,S,H,P) in x.dtype, final state
    (Bt,H,N,P) f32), as the reference's ``ssd_scan_fwd`` does."""
    check_args(x, dt, A, B, C)
    if not x.is_cuda:
        raise ValueError(f"ssd_scan_fwd launches a CUDA kernel; x lies on {x.device}")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    hT = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    if min(Bt, S, H) == 0:
        return y, hT.zero_()
    lib = build.load()
    smem = lib.ssd_scan_fwd_smem(N, P)
    if not 0 < smem <= SMEM_LIMIT:
        raise ValueError(
            f"ssd_scan_fwd needs {smem} bytes of shared memory at N={N}, P={P}; a block may "
            f"use {SMEM_LIMIT}"
        )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            hT.data_ptr(), Bt, S, H, G, N, P, build.DTYPE_CODES[_DTYPES[x.dtype]], stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed with CUDA error {err}")
    build.LAUNCHES["ssd_scan_fwd"] += 1
    return y, hT
