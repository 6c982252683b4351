"""RMSNorm forward: the wrapper of the CUDA kernel in ``csrc/rmsnorm.cu``.

Port of ``repro.kernels.rmsnorm.rmsnorm_fwd``.  The plain PyTorch version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`; :func:`repro_torch.kernels.ops.rmsnorm`
chooses between them by device.
"""

from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def check_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """What the kernel takes: x (..., D) f32/bf16 contiguous, w (D,) f32 on x's device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_fwd takes float32 or bfloat16 x, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"rmsnorm_fwd takes a float32 weight, got {w.dtype}")
    if x.ndim < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"weight shape {tuple(w.shape)} does not match x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_fwd needs contiguous x and w")
    if w.device != x.device:
        raise ValueError(f"x is on {x.device} but w on {w.device}")


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel.  x: (..., D); w: (D,).  Returns x's shape and dtype."""
    check_args(x, w)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_fwd launches a CUDA kernel; x lies on {x.device}")
    y = torch.empty_like(x)
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows == 0:
        return y
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmsnorm_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, x.shape[-1],
            build.DTYPE_CODES[_DTYPES[x.dtype]], float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm_fwd launch failed with CUDA error {err}")
    build.LAUNCHES["rmsnorm_fwd"] += 1
    return y
