"""Reference interpreter (VM) for the IR.

Demand-driven, explicit-stack evaluation:

* evaluating a graph constant that has free variables yields a
  :class:`Closure <repro_torch.core.values.Closure>` capturing the current frame,
* ``switch`` is strict in its *function* arguments (closure creation is
  cheap) but the **call** of the selected branch is what recurses — so
  recursion guarded by conditionals terminates,
* the work stack lives on the heap: arbitrarily deep recursion (loops are
  tail calls in this IR) cannot blow the Python C stack.

The same evaluator doubles as the torch backend's *fallback* executor: it
runs the primitives' torch implementations eagerly, paying the
interpreter's overhead on every call (the reference traces it once under
``jax.jit``).  Optimized first-order graphs
skip the VM entirely: ``repro_torch.core.lowering`` emits them as straight-line
Python callables, and the VM only serves graphs with residual graph values
(recursion, higher-order calls) — see ``docs/pipeline.md``.
"""

from __future__ import annotations

from typing import Any

from .ir import Apply, Constant, Graph, Node
from .primitives import Primitive
from .values import Closure

__all__ = ["VM", "run_graph"]

_MISSING = object()


class Frame:
    __slots__ = ("graph", "parent", "values")

    def __init__(self, graph: Graph, parent: "Frame | None") -> None:
        self.graph = graph
        self.parent = parent
        self.values: dict[int, Any] = {}

    def lookup_frame(self, node: Node) -> "Frame":
        g = node.graph
        f: Frame | None = self
        while f is not None:
            if f.graph is g:
                return f
            f = f.parent
        raise RuntimeError(
            f"free variable {node!r} of graph {g and g.name} not found in frame chain"
        )


class VM:
    """Explicit-stack evaluator."""

    def __init__(self, max_steps: int | None = None) -> None:
        self.max_steps = max_steps

    def call(self, fn: Any, args: tuple) -> Any:
        dest: list[Any] = [_MISSING]
        # task kinds:
        #   ("call", fnval, argvals, dest)
        #   ("eval", node, frame, dest|None)   -> memoize into owning frame
        #   ("apply", node, frame, dest|None)  -> inputs already evaluated
        #   ("store", node, frame, cell)       -> copy cell into frame memo
        tasks: list[tuple] = [("call", fn, tuple(args), dest)]
        steps = 0
        while tasks:
            steps += 1
            if self.max_steps is not None and steps > self.max_steps:
                raise RuntimeError("VM step budget exceeded")
            task = tasks.pop()
            kind = task[0]

            if kind == "call":
                _, fnval, argvals, d = task
                self._do_call(tasks, fnval, argvals, d)

            elif kind == "eval":
                _, node, frame, d = task
                val = self._quick_value(node, frame)
                if val is not _MISSING:
                    if d is not None:
                        d[0] = val
                    continue
                if isinstance(node, Apply):
                    tasks.append(("apply", node, frame, d))
                    owner = frame if node.graph is frame.graph else frame.lookup_frame(node)
                    for inp in node.inputs:
                        # constants need no eval task: _quick_value resolves
                        # them at apply time (also avoids creating every
                        # graph-constant Closure twice)
                        if not isinstance(inp, Constant):
                            tasks.append(("eval", inp, owner, None))
                else:  # pragma: no cover - parameters are always bound
                    raise RuntimeError(f"unbound node {node!r}")

            elif kind == "apply":
                _, node, frame, d = task
                owner = frame if node.graph is frame.graph else frame.lookup_frame(node)
                if node._id in owner.values:
                    if d is not None:
                        d[0] = owner.values[node._id]
                    continue
                vals = []
                for inp in node.inputs:
                    v = self._quick_value(inp, owner)
                    assert v is not _MISSING, f"input {inp!r} not evaluated"
                    vals.append(v)
                fnval, argvals = vals[0], tuple(vals[1:])
                if isinstance(fnval, Primitive):
                    res = fnval.impl(*argvals)
                    owner.values[node._id] = res
                    if d is not None:
                        d[0] = res
                else:
                    cell: list[Any] = [_MISSING]
                    tasks.append(("store", node, owner, cell, d))
                    self._do_call(tasks, fnval, argvals, cell)

            elif kind == "store":
                _, node, frame, cell, d = task
                assert cell[0] is not _MISSING
                frame.values[node._id] = cell[0]
                if d is not None:
                    d[0] = cell[0]

        assert dest[0] is not _MISSING
        return dest[0]

    # -- helpers -------------------------------------------------------------
    def _quick_value(self, node: Node, frame: Frame) -> Any:
        """Value of a node if immediately available (constant / memoized).

        Graph constants *always* capture the current frame: capture is
        cheap, and deciding statically whether a graph needs its defining
        frame is subtle under recursion (a recursive reference to an
        enclosing graph must not sever the chain)."""
        if isinstance(node, Constant):
            v = node.value
            if isinstance(v, Graph):
                return Closure(v, frame)
            return v
        owner = frame if node.graph is frame.graph else frame.lookup_frame(node)
        return owner.values.get(node._id, _MISSING)

    def _do_call(self, tasks: list, fnval: Any, argvals: tuple, dest: list) -> None:
        if isinstance(fnval, Primitive):
            dest[0] = fnval.impl(*argvals)
            return
        if isinstance(fnval, Closure):
            graph, parent = fnval.graph, fnval.frame
        elif isinstance(fnval, Graph):
            graph, parent = fnval, None
        else:
            raise TypeError(f"cannot call value of type {type(fnval).__name__}: {fnval!r}")
        if len(argvals) != len(graph.parameters):
            raise TypeError(
                f"{graph.name} expects {len(graph.parameters)} args, got {len(argvals)}"
            )
        frame = Frame(graph, parent)
        for p, v in zip(graph.parameters, argvals):
            frame.values[p._id] = v
        tasks.append(("eval", graph.return_, frame, dest))


def run_graph(graph: Graph, *args: Any) -> Any:
    return VM().call(graph, tuple(args))
