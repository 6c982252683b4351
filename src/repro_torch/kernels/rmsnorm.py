"""RMSNorm forward and backward: the wrappers of the CUDA kernels in ``csrc/rmsnorm.cu``.

Ports of ``repro.kernels.rmsnorm.rmsnorm_fwd`` (K2) and ``rmsnorm_bwd`` (K3).  The
plain PyTorch versions are :func:`repro_torch.kernels.ref.rmsnorm_ref` and
:func:`repro_torch.kernels.ref.rmsnorm_bwd_ref`; :func:`repro_torch.kernels.ops.rmsnorm`
chooses between them by device.  Unlike the TPU kernels, any number of rows works.
"""

from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_CODES = {t: build.DTYPE_CODES[name] for t, name in _DTYPES.items()}


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
    if w.get_device() != x.get_device():
        raise ValueError(f"x is on {x.device} but w on {w.device}")


#: the kernels' library, held here once loaded (``build.load`` builds it at first use)
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = build.load()
    return _LIB


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel.  x: (..., D); w: (D,).  Returns x's shape and dtype.

    Decoding calls this once per norm per token while the card waits on the host, so
    the launch is kept lean: the library is held in a module global, and the stream
    is read as a raw handle without entering a device context (unless x lies on
    another device than the current one)."""
    check_args(x, w)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_fwd launches a CUDA kernel; x lies on {x.device}")
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return rmsnorm_fwd(x, w, eps=eps)
    y = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    err = _lib().rmsnorm_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D, _CODES[x.dtype], eps,
        torch._C._cuda_getCurrentRawStream(device),
    )
    if err != 0:
        raise RuntimeError(f"rmsnorm_fwd launch failed with CUDA error {err}")
    build.LAUNCHES["rmsnorm_fwd"] += 1
    return y


def check_bwd_args(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> None:
    """What the backward kernel takes: x as the forward does, dy of x's shape and dtype."""
    check_args(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(
            f"dy {tuple(dy.shape)} {dy.dtype} does not match x {tuple(x.shape)} {x.dtype}"
        )
    if not dy.is_contiguous():
        raise ValueError("rmsnorm_bwd needs a contiguous dy")
    if dy.device != x.device:
        raise ValueError(f"x is on {x.device} but dy on {dy.device}")


def rmsnorm_bwd(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  Returns (dx in x's dtype, dw in w's dtype).

    The kernel writes one f32 row of dw partials per block; their sum over blocks
    is taken here, as the reference sums its per-grid-step partials."""
    check_bwd_args(x, w, dy)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_bwd launches a CUDA kernel; x lies on {x.device}")
    D = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, torch.zeros_like(w)
    lib = build.load()
    if D > lib.rmsnorm_bwd_max_width():
        raise ValueError(f"rmsnorm_bwd takes rows of at most {lib.rmsnorm_bwd_max_width()}")
    code = build.DTYPE_CODES[_DTYPES[x.dtype]]
    with torch.cuda.device(x.device):
        blocks = lib.rmsnorm_bwd_blocks(rows, D, code)
        if blocks <= 0:
            raise RuntimeError(f"rmsnorm_bwd found no launch configuration for D={D}")
        dw_part = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmsnorm_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw_part.data_ptr(),
            rows, D, blocks, code, float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd launch failed with CUDA error {err}")
    build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw_part.sum(dim=0).to(w.dtype)
