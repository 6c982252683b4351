"""Dtypes between the IR and torch.

The IR keeps numpy dtypes, as the reference does (abstracts, ``dtype_of``
results and ``cast`` constants), so the port's graphs, abstracts and
encodings are equal to the reference's.  Tensors carry torch dtypes; this
module converts between the two and applies the reference's canonical
types: with 64-bit mode off, jax computes ``float64`` as ``float32`` and
``int64`` as ``int32``, so every array the port's primitives return is
canonicalized the same way (:func:`canon`).

``bfloat16`` has no numpy dtype of its own; the reference uses
``ml_dtypes.bfloat16``.  Where ``ml_dtypes`` is installed the port maps to
it, so bf16 abstracts compare equal; where it is not, a bf16 tensor has no
IR dtype and the Myia path refuses it (the port's other paths do not need
one).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Iterator

import numpy as np
import torch

__all__ = [
    "np_dtype", "torch_dtype", "canon", "to_tensor", "to_numpy", "BF16", "default_device",
    "device_of", "device_results",
]

try:  # optional: the reference's numpy bfloat16
    import ml_dtypes as _ml_dtypes

    BF16: np.dtype | None = np.dtype(_ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover - depends on the installation
    BF16 = None

_T2N: dict[torch.dtype, np.dtype] = {
    torch.float32: np.dtype("float32"),
    torch.float16: np.dtype("float16"),
    torch.float64: np.dtype("float64"),
    torch.int8: np.dtype("int8"),
    torch.int16: np.dtype("int16"),
    torch.int32: np.dtype("int32"),
    torch.int64: np.dtype("int64"),
    torch.uint8: np.dtype("uint8"),
    torch.bool: np.dtype("bool"),
}
if BF16 is not None:
    _T2N[torch.bfloat16] = BF16

#: the reference's canonical types (jax with 64-bit mode off)
_CANON = {
    np.dtype("float64"): np.dtype("float32"),
    np.dtype("int64"): np.dtype("int32"),
    np.dtype("uint64"): np.dtype("uint32"),
}
_N2T: dict[np.dtype, torch.dtype] = {n: t for t, n in _T2N.items()}
_N2T[np.dtype("uint32")] = torch.uint32 if hasattr(torch, "uint32") else torch.int64


def np_dtype(dt: Any) -> np.dtype:
    """The IR (numpy) dtype of a torch dtype, numpy dtype or scalar type."""
    if isinstance(dt, torch.dtype):
        got = _T2N.get(dt)
        if got is None:
            raise TypeError(f"torch dtype {dt} has no IR dtype (bfloat16 needs ml_dtypes)")
        return got
    return np.dtype(dt)


def torch_dtype(dt: Any) -> torch.dtype:
    """The torch dtype a value of IR dtype ``dt`` is computed in (canonical:
    ``float64`` computes as ``float32``, as jax does with 64-bit mode off)."""
    if isinstance(dt, torch.dtype):
        return dt
    n = np.dtype(dt)
    n = _CANON.get(n, n)
    try:
        return _N2T[n]
    except KeyError:
        raise TypeError(f"no torch dtype for {n}") from None


def canon(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the reference's canonical type (64-bit types narrowed)."""
    if t.dtype == torch.int64:
        return t.to(torch.int32)
    if t.dtype == torch.float64:
        return t.to(torch.float32)
    return t


#: the device a program's values live on while it runs (jax's default device):
#: tensors made from Python scalars and numpy values go there
_DEVICE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_device", default=None)


@contextlib.contextmanager
def default_device(device: Any) -> Iterator[None]:
    """Make ``device`` where :func:`to_tensor` puts new tensors, for the extent
    of a program's run (the lowered callable and the VM set it from their
    arguments)."""
    token = _DEVICE.set(device)
    try:
        yield
    finally:
        _DEVICE.reset(token)


def device_of(args: Any) -> torch.device:
    """The device a call's tensors live on: the first non-CPU tensor's (tuples
    searched), else the first CPU tensor's, else torch's default device
    (``torch.set_default_device`` / ``with torch.device(...)``): a call with
    only Python scalars runs where ``jnp.asarray`` would put them, on the
    default device."""
    stack, cpu = [args], None
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            if a.device.type != "cpu":
                return a.device
            cpu = a.device
        elif isinstance(a, (tuple, list)):
            stack.extend(reversed(a))
    return cpu if cpu is not None else torch.get_default_device()


def device_results(out: Any, args: tuple) -> Any:
    """A program's result as ``jax.jit`` returns one: a Python scalar (also inside
    tuples) becomes a 0-d tensor of the reference's type on the call's device
    (:func:`device_of`).  Tensors, closures and other values pass unchanged."""
    if isinstance(out, (bool, int, float)):
        return to_tensor(out, device_of(args))
    if isinstance(out, tuple):
        return tuple(device_results(o, args) for o in out)
    return out


def to_tensor(x: Any, device: Any = None) -> torch.Tensor:
    """An array-like or Python scalar as a tensor of the reference's type
    (``jnp.asarray``): Python floats are ``float32``, ints ``int32``.  Without
    a ``device`` it goes to the running program's (:func:`default_device`)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if device is None:
        device = _DEVICE.get()
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool, device=device)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int32, device=device)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float32, device=device)
    arr = np.asarray(x)
    dt = _CANON.get(arr.dtype, arr.dtype)
    if BF16 is not None and dt == BF16:
        bits = torch.from_numpy(np.array(arr, order="C").view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    # np.array, not np.ascontiguousarray: that one turns a 0-d array into shape (1,)
    return torch.from_numpy(np.array(arr, dtype=dt, order="C")).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of its IR dtype (bf16 via ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np_dtype(torch.bfloat16))
    return t.contiguous().numpy()
