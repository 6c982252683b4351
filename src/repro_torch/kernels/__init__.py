"""Hand-written Hopper kernels: CUDA C++ in ``csrc/`` (K2–K5), each with its plain
PyTorch version (``ref.py``), a ctypes wrapper with a launch counter, and a public op
that dispatches by device and carries the gradient (``ops.py``); and K1, the Triton
kernels generated per fusion cluster of the Myia compiler (``codegen.py``)."""

from . import ref
from .build import FUSED_LAUNCHES, LAUNCHES, reset_launches
from .codegen import FusedKernel, emit_cluster
from .ops import (
    flash_attention, get_kernel_mode, rmsnorm, set_kernel_mode, ssd_scan, ssd_step
)

__all__ = [
    "ref", "flash_attention", "rmsnorm", "ssd_scan", "ssd_step", "LAUNCHES", "FUSED_LAUNCHES",
    "reset_launches", "FusedKernel", "emit_cluster", "get_kernel_mode", "set_kernel_mode",
]
