"""Mamba-2 SSD scan, forward: the wrapper of the CUDA kernels in ``csrc/ssd_scan.cu``.

Port of ``repro.kernels.ssd_scan.ssd_scan_fwd`` (K5).  The sequence's chunks run in
parallel in three passes (chunk state, state passing, chunk output); :func:`plan`
gives each pass's grid and shared memory and the scratch they share, and the wrapper
checks, allocates and launches from it.  The plain PyTorch version is
:func:`repro_torch.kernels.ref.ssd_scan_ref`, the stepwise recurrence the kernel is
held against; :func:`repro_torch.kernels.ops.ssd_scan` chooses between them by
device.  Unlike the TPU kernel, any sequence length works: the kernels zero-pad the
ragged last chunk themselves.
"""

from __future__ import annotations

import dataclasses

import torch

from . import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

#: dynamic shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232_448

#: grid launches per call: chunk state, state passing, chunk output
LAUNCHES_PER_CALL = 3

_THREADS = 256
_WARPS = _THREADS // 32
#: rows per chunk: the bf16 kernels' 8 warps take 16 rows each in the chunk output
#: pass; the f32 kernels keep their (L, L) scores in shared memory at 64
CHUNK = {"bfloat16": 128, "float32": 64}
#: the most heads of one group that one block of the chunk output pass takes, and of
#: the bf16 chunk state pass (whose blocks share the group's B)
MAX_HEADS_PER_BLOCK = 8
MAX_STATE_HEADS_PER_BLOCK = 4


def _round16(v: int) -> int:
    return -(-v // 16) * 16


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str  # the kernel's name in csrc/ssd_scan.cu
    grid: tuple[int, int, int]  # (x, y, z)
    threads: int
    smem: int  # bytes of dynamic shared memory


@dataclasses.dataclass(frozen=True)
class Plan:
    chunk: int
    n_chunks: int
    heads_per_block: int  # the chunk output pass's
    state_heads_per_block: int  # the chunk state pass's
    passes: tuple[Pass, Pass, Pass]
    #: scratch name -> (shape, dtype): "dH", each chunk's state contribution, in f32;
    #: "h_in", the state entering each chunk, as a bf16 hi and lo pair (None in f32,
    #: where h_in goes over "dH"); "cum", each chunk's cumsum of A·dt
    scratch: dict


def plan(Bt: int, S: int, H: int, G: int, N: int, P: int, dtype) -> Plan:
    """The three passes at these shapes, as ``csrc/ssd_scan.cu`` launches them: chunk
    length and count, each pass's grid and dynamic shared memory (the same formulas as
    the C side's ``state_smem`` / ``output_smem``), and the scratch shapes."""
    name = _DTYPES[dtype] if isinstance(dtype, torch.dtype) else str(dtype)
    tc = name == "bfloat16"
    L = CHUNK[name]
    nc = -(-S // L)
    rep = H // G
    HT = max(d for d in range(1, MAX_HEADS_PER_BLOCK + 1) if rep % d == 0)
    HA = max(d for d in range(1, MAX_STATE_HEADS_PER_BLOCK + 1) if rep % d == 0) if tc else 1
    if tc:
        NS, PS = _round16(N) + 8, _round16(P) + 8
        # B; two heads' x (then hi of w·x) and dt; lo of w·x; cum, w, the scan's warp sums
        smem_state = L * NS * 2 + 2 * (L * PS * 2 + L * 4) + L * PS * 2 + (2 * L + _WARPS) * 4
        # C, B (then y's staging), and two heads' x, h_in hi and lo, (cum, dt) pairs
        smem_output = (L * NS * 2 + L * max(NS, PS) * 2
                       + 2 * (L * PS * 2 + 2 * _round16(N) * PS * 2 + 2 * L * 4))
    else:
        LT = L + 4
        smem_state = L * N * 4 + L * P * 4 + (3 * L + _WARPS) * 4
        smem_output = 2 * N * LT * 4 + L * LT * 4 + L * P * 4 + N * P * 4 + 3 * L * 4
    kind = "tc" if tc else "f32"
    passes = (
        Pass("ssd_chunk_state_" + kind, (nc, H // HA, Bt), _THREADS, smem_state),
        Pass("ssd_state_pass", (-(-(N * P // 4) // _THREADS), H, Bt), _THREADS, 0),
        Pass("ssd_chunk_output_" + kind, (nc, H // HT, Bt), _THREADS, smem_output),
    )
    scratch = {
        "dH": ((Bt, nc, H, N, P), torch.float32),
        "h_in": ((Bt, nc, H, 2, N, P), torch.bfloat16) if tc else None,
        "cum": ((Bt, nc, H, L), torch.float32),
    }
    return Plan(L, nc, HT, HA, passes, scratch)


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
    """Launch the three passes.  Returns (y (Bt,S,H,P) in x.dtype, final state
    (Bt,H,N,P) f32), as the reference's ``ssd_scan_fwd`` does."""
    check_args(x, dt, A, B, C)
    if not x.is_cuda:
        raise ValueError(f"ssd_scan_fwd launches a CUDA kernel; x lies on {x.device}")
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan_fwd copies x, B and C in 16-byte units: they must be "
                         "16-byte aligned")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    hT = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    if min(Bt, S, H) == 0:
        return y, hT.zero_()
    p = plan(Bt, S, H, G, N, P, x.dtype)
    for ps in p.passes:
        if ps.smem > SMEM_LIMIT:
            raise ValueError(
                f"ssd_scan_fwd's {ps.name} needs {ps.smem} bytes of shared memory at N={N}, "
                f"P={P}; a block may use {SMEM_LIMIT}"
            )
    scratch = {k: None if v is None else torch.empty(v[0], dtype=v[1], device=x.device)
               for k, v in p.scratch.items()}
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            hT.data_ptr(), scratch["dH"].data_ptr(),
            None if scratch["h_in"] is None else scratch["h_in"].data_ptr(),
            scratch["cum"].data_ptr(), Bt, S, H, G, N, P, p.state_heads_per_block,
            p.heads_per_block,
            build.DTYPE_CODES[_DTYPES[x.dtype]], stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed with CUDA error {err}")
    build.LAUNCHES["ssd_scan_fwd"] += LAUNCHES_PER_CALL
    return y, hT
