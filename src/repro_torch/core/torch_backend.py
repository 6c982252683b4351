"""Execution backend: graphs to eager torch callables.

The port of ``repro/core/jax_backend.py``'s ``trace_graph`` and
``compile_graph``.  Straight-line first-order graphs are lowered directly
(``repro_torch.core.lowering``) and run eagerly: each call executes the
same generated code, one torch call (or one fused kernel launch) per
emitted line.  Anything with residual graph values runs on the reference
VM.  There is no jit tier: torch executes eagerly, and CUDA-graph capture
of the lowered callable is later speed work.

The reference's ``ProgramCache`` (the persistent graph and executable
tiers) waits for ROADMAP item A5, and ``compile_graph_spmd`` for A9.
"""

from __future__ import annotations

from typing import Any, Callable

from .ir import Graph
from .lowering import try_lower
from .vm import VM

__all__ = ["compile_graph", "trace_graph"]


def trace_graph(graph: Graph) -> Callable:
    """A plain callable evaluating the graph via the VM."""

    def run(*args: Any) -> Any:
        return VM().call(graph, tuple(args))

    run.__name__ = f"myia_{graph.name}"
    return run


def compile_graph(graph: Graph, *, lower: bool = True, fuse: bool = False) -> Callable:
    """Compile ``graph`` to a callable.

    Straight-line first-order graphs are lowered directly (no VM on the
    path); anything with residual graph values falls back to the VM.
    ``fuse=True`` selects the fusion tier: clustered regions execute as
    generated Triton kernels on CUDA tensors (``repro_torch.core.fusion`` +
    ``repro_torch.kernels.codegen``), and as their torch oracles on the CPU
    or in kernel mode ``"ref"``.  The returned callable carries ``.lowered``
    (bool) and ``.fn`` (the callable it runs) for introspection.
    """
    fn = try_lower(graph, fuse=fuse) if lower else None
    lowered = fn is not None
    if fn is None:
        fn = trace_graph(graph)

    def runner(*args: Any) -> Any:
        return fn(*args)

    runner.__name__ = f"myia_{graph.name}"
    runner.lowered = lowered
    runner.fn = fn
    return runner
