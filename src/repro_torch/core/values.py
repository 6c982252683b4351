"""Runtime values for the IR: closures, gradient environments, symbolic keys.

The AD transform (paper §3.2) makes backpropagators return the partial
derivatives w.r.t. a function's *free variables* in addition to its inputs.
Because a function value may be any of several closures (e.g. the two
branches of a ``switch``) with different free-variable sets, these
sensitivities are carried in an :class:`EnvInstance` — a persistent map from
:class:`SymbolicKey` (a stand-in for an IR node) to gradient values — rather
than the paper's "ordered set".  This matches Myia's actual implementation.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from .dtypes import canon, to_tensor

__all__ = [
    "SymbolicKey",
    "EnvInstance",
    "newenv",
    "Closure",
    "gadd_values",
    "zeros_like_value",
    "is_array_like",
]


class SymbolicKey:
    """Identifies a free variable inside gradient environments.

    Holds a reference to the IR node so that ``zeros_like`` semantics are
    recoverable; compares by identity of the node.
    """

    __slots__ = ("node",)

    def __init__(self, node: Any) -> None:
        self.node = node

    def __eq__(self, other: object) -> bool:
        return isinstance(other, SymbolicKey) and other.node is self.node

    def __hash__(self) -> int:
        return id(self.node)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Key {getattr(self.node, 'debug_name', '') or id(self.node)}>"


class EnvInstance:
    """Persistent (functional) map from SymbolicKey to gradient values."""

    __slots__ = ("_d",)

    def __init__(self, d: dict[SymbolicKey, Any] | None = None) -> None:
        self._d = d or {}

    def set(self, key: SymbolicKey, value: Any) -> "EnvInstance":
        d = dict(self._d)
        d[key] = value
        return EnvInstance(d)

    def get(self, key: SymbolicKey, default: Any) -> Any:
        return self._d.get(key, default)

    def add(self, other: "EnvInstance") -> "EnvInstance":
        d = dict(self._d)
        for k, v in other._d.items():
            d[k] = gadd_values(d[k], v) if k in d else v
        return EnvInstance(d)

    def keys(self) -> Iterable[SymbolicKey]:
        return self._d.keys()

    def __len__(self) -> int:
        return len(self._d)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Env {len(self._d)} keys>"


newenv = EnvInstance()


class Closure:
    """A graph paired with the frame chain that resolves its free variables
    (VM-level runtime representation of a first-class function)."""

    __slots__ = ("graph", "frame")

    def __init__(self, graph: Any, frame: Any) -> None:
        self.graph = graph
        self.frame = frame

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Closure {self.graph.name}>"


def is_array_like(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def gadd_values(x: Any, y: Any) -> Any:
    """Generic gradient addition: numbers/arrays add, tuples add
    elementwise, environments merge (the runtime of the ``gadd`` prim)."""
    if isinstance(x, EnvInstance):
        if isinstance(y, EnvInstance):
            return x.add(y)
        raise TypeError(f"gadd(Env, {type(y)})")
    if isinstance(y, EnvInstance):
        raise TypeError(f"gadd({type(x)}, Env)")
    if isinstance(x, tuple) and isinstance(y, tuple):
        if len(x) != len(y):
            raise TypeError("gadd of tuples with different lengths")
        return tuple(gadd_values(a, b) for a, b in zip(x, y))
    if x is None:
        return y
    if y is None:
        return x
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        return canon(x + y)
    return x + y


def zeros_like_value(x: Any) -> Any:
    """Generic zeros: the additive identity matching ``x``'s structure.
    Function-typed values get an *empty environment* (their sensitivity is
    the map of free-variable gradients)."""
    from .ir import Graph  # local import to avoid cycle
    from .primitives import Primitive

    if isinstance(x, tuple):
        return tuple(zeros_like_value(v) for v in x)
    if isinstance(x, (EnvInstance, Closure, Graph, Primitive)):
        return newenv
    if isinstance(x, bool):
        return False
    if isinstance(x, int):
        return 0
    if isinstance(x, float):
        return 0.0
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x, memory_format=torch.contiguous_format)
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.zeros_like(to_tensor(x))
    if x is None or isinstance(x, (np.dtype, str, type, SymbolicKey)):
        # opaque, non-differentiable tokens: None is the additive unit
        return None
    if callable(x):
        return newenv
    raise TypeError(f"zeros_like for {type(x)}")
