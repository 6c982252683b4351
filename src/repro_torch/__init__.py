"""PyTorch/CUDA port of the ``repro`` model zoo's serving and training paths, for one
NVIDIA H100.

The layout mirrors ``src/repro``: ``configs``, ``models``, ``kernels`` (hand-written
Hopper kernels with their plain PyTorch versions and autograd Functions beside them,
sources under ``csrc/``), the training substrate (``optim``, ``data``,
``checkpoint``, ``runtime``, ``distributed``) and ``launch``.  The package imports
``torch`` and numpy only; it never imports ``jax`` or anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no CUDA
device and no explicit CPU request they raise.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
