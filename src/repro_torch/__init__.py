"""PyTorch/CUDA port of the ``repro`` model-zoo serving path, for one NVIDIA H100.

The layout mirrors ``src/repro``: ``configs``, ``models``, ``kernels`` (hand-written
Hopper kernels with their plain PyTorch versions beside them, sources under
``csrc/``) and ``launch``.  The package imports ``torch`` and numpy only; it never
imports ``jax`` or anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no CUDA
device and no explicit CPU request they raise.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
