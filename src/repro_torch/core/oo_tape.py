"""Operator-overloading (OO) tape-based reverse AD — the paper's baseline.

The port of ``repro/core/oo_tape.py``.  Paper §2.1.1: "All primitives are
overloaded so that they additionally perform a tracing operation: The
primitive is logged onto a 'tape', along with its inputs … Derivatives can
be calculated by walking this tape in reverse."  And the criticism: "since
the program is traced and reversed at runtime, OO incurs overhead on each
function call … OO also does not allow for ahead-of-time optimizations on
the adjoint program."

This module is that baseline, PyTorch/Autograd-style: a ``Box`` wrapper
with overloaded operators, a per-call tape, and an interpreted backward
walk.  It does not use ``torch.autograd``: the tape *is* the mechanism (the
tests hold it against ``torch.autograd`` as a second OO oracle).  Array
values are torch tensors on whatever device the inputs are on; Python
floats stay Python floats (float64 arithmetic), as they stay on the
reference's tape.  The lowered ST program runs the same eager torch ops on
array workloads, so the two agree bitwise there.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from .primitives import _impl_unbroadcast

__all__ = [
    "Box", "oo_grad", "oo_value_and_grad", "tanh", "exp", "log", "sigmoid",
    "relu", "reduce_sum", "matmul",
]


class _Tape:
    __slots__ = ("entries",)

    def __init__(self) -> None:
        # (out_box, input_boxes, vjp) — vjp(dout) -> tuple of input grads
        self.entries: list[tuple["Box", tuple, Callable]] = []


class Box:
    """A traced value.  Every overloaded operation appends to the tape."""

    __slots__ = ("value", "tape")

    def __init__(self, value: Any, tape: _Tape) -> None:
        self.value = value
        self.tape = tape

    # -- binary ops ----------------------------------------------------
    def __add__(self, o):  # noqa: D105
        return _record(self.tape, _val(self) + _val(o), (self, o),
                       lambda d, x=self, y=o: (_unb(d, x), _unb(d, y)))

    __radd__ = __add__

    def __sub__(self, o):
        return _record(self.tape, _val(self) - _val(o), (self, o),
                       lambda d, x=self, y=o: (_unb(d, x), _unb(-d, y)))

    def __rsub__(self, o):
        return _record(self.tape, _val(o) - _val(self), (self, o),
                       lambda d, x=self, y=o: (_unb(-d, x), _unb(d, y)))

    def __mul__(self, o):
        return _record(self.tape, _val(self) * _val(o), (self, o),
                       lambda d, x=self, y=o: (_unb(d * _val(y), x), _unb(d * _val(x), y)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _record(self.tape, _val(self) / _val(o), (self, o),
                       lambda d, x=self, y=o: (_unb(d / _val(y), x),
                                               _unb(-d * _val(x) / (_val(y) ** 2), y)))

    def __pow__(self, o):
        out = _val(self) ** _val(o)
        return _record(self.tape, out, (self, o),
                       lambda d, x=self, y=o, ov=out: (
                           _unb(d * _val(y) * _val(x) ** (_val(y) - 1), x),
                           _unb(d * ov * _log(_val(x)), y)))

    def __neg__(self):
        return _record(self.tape, -_val(self), (self,), lambda d: (-d,))

    def __matmul__(self, o):
        return _record(self.tape, _val(self) @ _val(o), (self, o),
                       lambda d, x=self, y=o: (d @ _val(y).transpose(-1, -2),
                                               _val(x).transpose(-1, -2) @ d))

    # comparisons produce plain values (no gradient)
    def __lt__(self, o):
        return _val(self) < _val(o)

    def __gt__(self, o):
        return _val(self) > _val(o)

    def __le__(self, o):
        return _val(self) <= _val(o)

    def __ge__(self, o):
        return _val(self) >= _val(o)


def _val(x: Any) -> Any:
    return x.value if isinstance(x, Box) else x


def _unb(d: Any, x: Any) -> Any:
    """Reverse broadcasting for a gradient flowing to ``x``."""
    v = _val(x)
    shp = () if isinstance(v, (int, float)) else tuple(np.shape(v))
    return _impl_unbroadcast(d, shp)


def _record(tape: _Tape, value: Any, inputs: tuple, vjp: Callable) -> Box:
    out = Box(value, tape)
    tape.entries.append((out, inputs, vjp))
    return out


# -- function-style ops ------------------------------------------------------


def _scalar_or_tensor(on_float: Callable, on_tensor: Callable) -> Callable:
    """One op on Python floats (kept as floats) and on tensors."""

    def fn(x):
        return on_float(x) if isinstance(x, (int, float)) else on_tensor(x)

    return fn


def _log_float(x: float) -> float:
    # jnp.log's values where math.log raises
    if x > 0:
        return math.log(x)
    return -math.inf if x == 0 else math.nan


_log = _scalar_or_tensor(_log_float, torch.log)


def _unary(fn, dfn):
    def op(x):
        if not isinstance(x, Box):
            return fn(x)
        out = fn(x.value)
        return _record(x.tape, out, (x,), lambda d, xv=x.value, ov=out: (dfn(d, xv, ov),))

    return op


tanh = _unary(_scalar_or_tensor(math.tanh, torch.tanh), lambda d, x, o: d * (1 - o * o))
exp = _unary(_scalar_or_tensor(math.exp, torch.exp), lambda d, x, o: d * o)
log = _unary(_log, lambda d, x, o: d / x)
sigmoid = _unary(
    _scalar_or_tensor(lambda x: 1 / (1 + math.exp(-x)), lambda x: 1 / (1 + torch.exp(-x))),
    lambda d, x, o: d * o * (1 - o),
)
relu = _unary(
    _scalar_or_tensor(lambda x: max(x, 0.0), lambda x: torch.clamp_min(x, 0)),
    lambda d, x, o: d * (x > 0),
)


def _sum(x, axes, keepdims):
    if isinstance(x, (int, float)):
        return x
    dims = None if axes is None else ((axes,) if isinstance(axes, int) else tuple(axes))
    if dims is None:
        out = torch.sum(x)
        return out.reshape((1,) * x.dim()) if keepdims else out
    return torch.sum(x, dim=dims, keepdim=keepdims)


def reduce_sum(x, axes=None, keepdims=False):
    if not isinstance(x, Box):
        return _sum(x, axes, keepdims)
    out = _sum(x.value, axes, keepdims)

    def vjp(d, xv=x.value):
        shp = np.shape(out) if keepdims else _kd_shape(xv, axes)
        return (torch.broadcast_to(torch.reshape(d, shp), tuple(np.shape(xv))),)

    return _record(x.tape, out, (x,), vjp)


def _kd_shape(x, axes):
    shp = list(np.shape(x))
    if axes is None:
        return tuple(1 for _ in shp)
    axes = (axes,) if isinstance(axes, int) else axes
    for a in axes:
        shp[a % len(shp)] = 1
    return tuple(shp)


def matmul(a, b):
    tape = a.tape if isinstance(a, Box) else b.tape
    return Box.__matmul__(a if isinstance(a, Box) else Box(a, tape), b)


# -- driver -------------------------------------------------------------------


def oo_value_and_grad(fn: Callable, wrt: int | tuple[int, ...] = 0) -> Callable:
    """OO/tape value-and-gradient: traces at every call (that is the point)."""

    wrt_t = (wrt,) if isinstance(wrt, int) else tuple(wrt)

    def run(*args):
        tape = _Tape()
        boxes = [Box(a, tape) for a in args]
        out = fn(*boxes)
        out_v = _val(out)
        grads: dict[int, Any] = {
            id(out): torch.ones_like(out_v) if isinstance(out_v, torch.Tensor) else 1.0
        }
        for out_box, inputs, vjp in reversed(tape.entries):
            d = grads.pop(id(out_box), None)
            if d is None:
                continue
            for inp, g in zip(inputs, vjp(d)):
                if not isinstance(inp, Box):
                    continue
                k = id(inp)
                grads[k] = g if k not in grads else grads[k] + g
        outs = tuple(grads.get(id(boxes[i]), _zeros_for(args[i])) for i in wrt_t)
        run.tape_entries = len(tape.entries)
        return out_v, (outs[0] if isinstance(wrt, int) else outs)

    #: the last call's tape length (the per-call tracing the paper measures)
    run.tape_entries = None
    return run


def _zeros_for(v):
    return torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0.0


def oo_grad(fn: Callable, wrt: int | tuple[int, ...] = 0) -> Callable:
    vag = oo_value_and_grad(fn, wrt)

    def run(*args):
        return vag(*args)[1]

    return run
