"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), each with its plain PyTorch
version (``ref.py``), a ctypes wrapper with a launch counter, and a public op that
dispatches by device and carries the gradient (``ops.py``)."""

from . import ref
from .build import LAUNCHES, reset_launches
from .ops import flash_attention, rmsnorm, ssd_scan, ssd_step

__all__ = [
    "ref", "flash_attention", "rmsnorm", "ssd_scan", "ssd_step", "LAUNCHES", "reset_launches"
]
