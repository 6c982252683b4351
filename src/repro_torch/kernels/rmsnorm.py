"""RMSNorm forward and backward: the wrappers of the CUDA kernels in ``csrc/rmsnorm.cu``.

Ports of ``repro.kernels.rmsnorm.rmsnorm_fwd`` (K2) and ``rmsnorm_bwd`` (K3).  The
plain PyTorch versions are :func:`repro_torch.kernels.ref.rmsnorm_ref` and
:func:`repro_torch.kernels.ref.rmsnorm_bwd_ref`; :func:`repro_torch.kernels.ops.rmsnorm`
chooses between them by device.  Unlike the TPU kernels, any number of rows works.

K2 takes one of three routes (:data:`ROUTES`), chosen in C by the row width alone: a
warp per row for rows of up to 4096 values, a block per row with the row held in
registers for rows of up to 8192, and a block per row streaming its row twice for wider
rows.  ``build.K2_ROUTES`` counts the launches by route.
"""

from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_CODES = {t: build.DTYPE_CODES[name] for t, name in _DTYPES.items()}

#: K2's routes, by the code the C side returns (``csrc/rmsnorm.cu``)
ROUTES = ("warp-per-row", "row-per-block", "row-per-block-streamed")


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
    return _launch(x, w, eps, None)


def rmsnorm_fwd_on(x: torch.Tensor, w: torch.Tensor, route: str, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm_fwd` on the route named (one of :data:`ROUTES`), whatever the
    dispatch would choose, to time and test each route; raises for a width the route
    does not take."""
    return _launch(x, w, eps, ROUTES.index(route))


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float, route: int | None) -> torch.Tensor:
    check_args(x, w)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_fwd launches a CUDA kernel; x lies on {x.device}")
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(x, w, eps, route)
    y = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D, _CODES[x.dtype], eps)
    stream = torch._C._cuda_getCurrentRawStream(device)
    took = (_lib().rmsnorm_fwd(*args, stream) if route is None
            else _lib().rmsnorm_fwd_on_route(*args, route, stream))
    if took < 0:
        raise RuntimeError(f"rmsnorm_fwd launch failed with CUDA error {-took}")
    build.LAUNCHES["rmsnorm_fwd"] += 1
    name = ROUTES[took]
    build.K2_ROUTES[name] = build.K2_ROUTES.get(name, 0) + 1
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
    if dy.get_device() != x.get_device():
        raise ValueError(f"x is on {x.device} but dy on {dy.device}")


#: the backward's persistent grid by (device, D, dtype code): its blocks for as many
#: rows as there may be, found once (``rmsnorm_bwd_blocks``, which also sets the
#: kernel's shared-memory limit on that device)
_BWD_GRID: dict[tuple[int, int, int], int] = {}


def rmsnorm_bwd(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernels.  Returns (dx in x's dtype, dw in w's dtype).

    One call is two grid launches: the main kernel writes dx and one f32 row of dw
    partials per block, and the dw pass, its programmatic dependent, sums them in a
    fixed order.  The launch path is K2's: the library from the module global, the
    grid cached per (device, D, dtype) and cut to the rows, the stream as a raw
    handle, no device context unless x lies off the current device.  The partials'
    workspace comes from the caching allocator on each call."""
    check_bwd_args(x, w, dy)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_bwd launches a CUDA kernel; x lies on {x.device}")
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return rmsnorm_bwd(x, w, dy, eps=eps)
    D = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, torch.zeros_like(w)
    code = _CODES[x.dtype]
    grid = _BWD_GRID.get((device, D, code))
    if grid is None:
        widest = _lib().rmsnorm_bwd_max_width()
        if D > widest:
            raise ValueError(f"rmsnorm_bwd takes rows of at most {widest}")
        grid = _lib().rmsnorm_bwd_blocks(D, code)
        if grid <= 0:
            raise RuntimeError(f"rmsnorm_bwd found no launch configuration for D={D}")
        _BWD_GRID[(device, D, code)] = grid
    blocks = min(rows, grid)
    dw_part = w.new_empty((blocks, D))
    dw = torch.empty_like(w)
    err = _lib().rmsnorm_bwd(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw_part.data_ptr(),
        dw.data_ptr(), rows, D, blocks, code, float(eps),
        torch._C._cuda_getCurrentRawStream(device),
    )
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd launch failed with CUDA error {err}")
    build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw
