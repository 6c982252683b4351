"""Direct lowering: straight-line compilation of first-order graphs.

The paper's performance claim for ST AD (§4.3, Figure 1) is that once the
adjoint has been inlined and simplified, what remains is a *straight-line
program* that can be compiled ahead of time — "the graphs become amenable
to ahead-of-time optimization" — instead of being interpreted.  The VM
(``repro_torch.core.vm``) is the general evaluator: it handles closures, free
variables, recursion and data-dependent calls, at the price of heap task
stacks, per-node frame dictionaries and per-input dispatch.  After the
optimizer has done its job, the overwhelmingly common case is a graph with
*none* of those features left — every apply calls a primitive held in a
constant, every reachable node belongs to the root graph.

This module emits that common case as generated Python source: one
assignment per apply node in topological order, executed over the
primitives' torch implementations.  No Frame dicts, no task stack, no
users-edge bookkeeping — the function runs eagerly on its arguments'
device (every call executes the same code; the reference additionally
hands it to ``jax.jit``).

``lowering_blockers`` reports why a graph must stay on the VM:

* a constant holding a :class:`Graph` survived optimization (residual
  recursion, or a closure passed as a value — e.g. through ``switch`` on a
  traced condition),
* an apply whose callee is not a constant primitive (higher-order call),
* a node owned by another graph (free variable: the graph is nested).

``try_lower`` returns ``None`` in those cases and the caller falls back to
the VM path (see ``torch_backend.compile_graph`` / ``api.MyiaFunction``).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from .closure import analyze_blockers
from .dtypes import default_device, device_of
from .ir import (
    Apply,
    Constant,
    Graph,
    Node,
    toposort,
)
from .primitives import COLLECTIVE_NAMES, LOOP_GRAPH_ARGS, Primitive

__all__ = [
    "LoweringError",
    "analyze_blockers",
    "lowering_blockers",
    "lower_graph",
    "lowered_from_payload",
    "lowered_payload",
    "try_lower",
]


class LoweringError(Exception):
    """The graph is not a first-order straight-line program."""


def lowering_blockers(graph: Graph) -> list[str]:
    """Reasons ``graph`` cannot be lowered (empty list: lowerable).

    The string form of :func:`repro_torch.core.closure.analyze_blockers` — each
    message is prefixed with its structured kind (``[recursion-shape]``,
    ``[higher-order-residual]``, …).  De-duplicated (first occurrence
    wins): a residually recursive family repeats the same graph-valued
    constant at every call site, and callers log/assert on the list — N
    copies of one message carry no extra information."""
    return [str(r) for r in analyze_blockers(graph)]


def _literal(value: Any) -> str | None:
    """Source literal for ``value``, or None if it must be bound by name.

    Exact-type checks only: subclasses (np.float64, IntEnum, …) may repr
    to invalid or semantically different source (e.g. numpy>=2 reprs as
    ``np.float64(1.5)``, and demoting a strong-typed numpy scalar to a
    Python literal would change jax dtype promotion) — those are bound in
    the closure environment instead."""
    if value is None:
        return "None"
    t = type(value)
    if t is bool or t is str or t is int:
        return repr(value)
    if t is float:
        return repr(value) if math.isfinite(value) else None
    if t is tuple:
        elts = [_literal(v) for v in value]
        if any(e is None for e in elts):
            return None
        inner = ", ".join(elts)
        return f"({inner},)" if len(elts) == 1 else f"({inner})"
    return None


def _abstract_nbytes(ab: Any) -> int:
    """Bytes of an abstract value (arrays + tuples of arrays; 0 unknown)."""
    from .infer import AArray, ATuple

    if isinstance(ab, AArray):
        n = 1
        for d in ab.shape:
            n *= int(d)
        return n * np.dtype(ab.dtype).itemsize
    if isinstance(ab, ATuple):
        return sum(_abstract_nbytes(e) for e in ab.elements)
    return 0


def _launch_nbytes(node: Apply) -> int:
    """Bytes-moved estimate for one launch: every operand read + the
    result written, from the inferred abstracts (0 when uninferred)."""
    total = _abstract_nbytes(node.abstract)
    for a in node.args:
        total += _abstract_nbytes(getattr(a, "abstract", None))
    return total


def lower_graph(graph: Graph, *, fuse: bool = False, profile: bool = False) -> Callable:
    """Compile a first-order straight-line graph to a Python callable.

    The generated source (kept on the result as ``fn.__lowered_source__``)
    is one assignment per apply node in topological order; primitive
    implementations and non-literal constants are bound in the closure
    namespace.  Raises :class:`LoweringError` if the graph has residual
    graph values / higher-order calls / free variables.

    With ``fuse=True`` the graph is first partitioned into fusion regions
    (``repro_torch.core.fusion``); every cluster the code generator accepts is
    emitted as ONE call to its generated Triton kernel (dispatched by
    device and kernel mode: the Triton kernel on CUDA tensors, its torch
    oracle on the CPU or in mode ``"ref"`` — see
    ``repro_torch.kernels.codegen``), and its interior nodes disappear from the
    emitted source.  Clusters the generator declines fall back to the
    per-node torch path — fusion never changes *whether* a graph lowers.
    The fusion plan and kernels ride on the result as
    ``fn.__fusion_plan__`` / ``fn.__fused_kernels__``.

    With ``profile=True`` every *unfused* launch (opaque op, structured
    loop, collective) is additionally wrapped in
    ``repro_torch.obs.profile.call_profiled`` — fused kernels time themselves —
    so an armed :class:`~repro_torch.obs.profile.Profiler` receives one record
    per launch when the result is executed eagerly.  Disarmed, each hook
    is a single module-global None-check; the default ``profile=False``
    emits byte-identical source to before the profiler existed, so the
    production path is structurally untouched.
    """
    from repro_torch.obs import trace as obs_trace

    blockers = lowering_blockers(graph)
    if blockers:
        raise LoweringError("; ".join(blockers))
    with obs_trace.span("lower", graph=graph.name, fuse=fuse):
        return _lower_graph_body(graph, fuse, profile)


def _lower_graph_body(graph: Graph, fuse: bool, profile: bool = False) -> Callable:
    plan = None
    fused: dict[int, Any] = {}  # root node id -> FusedKernel
    skip: set[int] = set()  # interior member ids of emitted clusters
    cluster_of_root: dict[int, Any] = {}
    if fuse:
        from .fusion import partition_graph
        from repro_torch.kernels.codegen import emit_cluster

        plan = partition_graph(graph)
        for cluster in plan.clusters:
            kernel = emit_cluster(cluster)
            if kernel is None:
                continue  # declined: this cluster stays on the per-node path
            fused[cluster.root._id] = kernel
            cluster_of_root[cluster.root._id] = cluster
            skip |= cluster.members - {cluster.root._id}
        # the attached plan must account only for clusters that actually
        # emitted — declined ones save no launches
        plan.clusters = [c for c in plan.clusters if c.root._id in fused]

    env: dict[str, Any] = {}
    if profile:
        from repro_torch.obs import profile as obs_profile

        env["_prof"] = obs_profile.call_profiled
    prim_names: dict[int, str] = {}  # id(prim) -> bound name
    names: dict[int, str] = {}  # node id -> source name
    params = []
    for i, p in enumerate(graph.parameters):
        names[p._id] = f"p{i}"
        params.append(f"p{i}")

    def bind_prim(prim: Primitive) -> str:
        name = prim_names.get(id(prim))
        if name is None:
            name = f"_prim_{prim.name}_{len(prim_names)}"
            prim_names[id(prim)] = name
            env[name] = prim.impl
        return name

    def ref(node: Node) -> str:
        got = names.get(node._id)
        if got is not None:
            return got
        assert isinstance(node, Constant), f"unnamed non-constant {node!r}"
        lit = _literal(node.value)
        if lit is not None:
            return lit
        name = f"_const_{len(env)}"
        env[name] = node.value
        names[node._id] = name
        return name

    lines = [f"def _lowered({', '.join(params)}):"]
    seq = 0
    for n in toposort(graph):
        if not isinstance(n, Apply) or n._id in skip:
            continue
        name = f"v{seq}"
        seq += 1
        names[n._id] = name
        kernel = fused.get(n._id)
        if kernel is not None:
            cluster = cluster_of_root[n._id]
            kname = f"_fused_{len(env)}"
            env[kname] = kernel
            args = ", ".join(ref(a) for a in cluster.inputs)
            lines.append(
                f"    {name} = {kname}({args})  # fused[{kernel.n_nodes}] {kernel.name}"
            )
            continue
        prim = n.fn.value
        n_sub = LOOP_GRAPH_ARGS.get(prim.name)
        if n_sub is not None:
            # structured loop: the leading args are closed first-order
            # graphs — lower each recursively and bind the callables, so
            # the loop body pays zero interpreter overhead too.  The body
            # executes under lax control flow (traced once), so per-op
            # profiling inside it is meaningless — the whole loop is one
            # "loop"-kind launch and the sub-lowering stays uninstrumented.
            subs = []
            for sub in n.args[:n_sub]:
                assert isinstance(sub, Constant) and isinstance(sub.value, Graph)
                sname = f"_loop_{sub.value.name.split(':')[-1]}_{len(env)}"
                env[sname] = lower_graph(sub.value, fuse=fuse)
                subs.append(sname)
            rest = [ref(a) for a in n.args[n_sub:]]
            args = ", ".join(subs + rest)
            if profile:
                lines.append(
                    f"    {name} = _prof({bind_prim(prim)}, "
                    f"{prim.name + ':' + name!r}, 'loop', {_launch_nbytes(n)}, "
                    f"{args})  # {prim.name}"
                )
            else:
                lines.append(f"    {name} = {bind_prim(prim)}({args})  # {prim.name}")
            continue
        args = ", ".join(ref(a) for a in n.args)
        if profile:
            kind = "collective" if prim.name in COLLECTIVE_NAMES else "opaque"
            lines.append(
                f"    {name} = _prof({bind_prim(prim)}, "
                f"{prim.name + ':' + name!r}, {kind!r}, {_launch_nbytes(n)}, "
                f"{args})  # {prim.name}"
            )
        else:
            lines.append(f"    {name} = {bind_prim(prim)}({args})  # {prim.name}")
    lines.append(f"    return {ref(graph.return_)}")
    source = "\n".join(lines) + "\n"
    return _assemble(graph.name, source, env, plan, list(fused.values()))


def _assemble(name: str, source: str, env: dict, plan: Any, kernels: list) -> Callable:
    """Compile the emitted ``source`` over ``env`` into the runnable callable
    (shared by :func:`lower_graph` and :func:`lowered_from_payload`)."""
    namespace = dict(env)
    exec(compile(source, f"<myia-lowered:{name}>", "exec"), namespace)
    fn = _placed(namespace["_lowered"], namespace, env)
    fn.__name__ = f"lowered_{name}"
    fn.__lowered_name__ = name
    fn.__lowered_source__ = source
    fn.__lowered_env__ = env
    fn.__fusion_plan__ = plan
    fn.__fused_kernels__ = kernels
    return fn


# ---------------------------------------------------------------------------
# The durable form of a lowered program (the program cache's executable tier)
# ---------------------------------------------------------------------------


def _prim_names() -> dict[int, str]:
    """Primitive implementation -> registry name (kernel primitives included)."""
    import repro_torch.kernels.ops  # noqa: F401  (registers the kernel primitives)
    from .primitives import PRIMITIVES

    return {id(p.impl): name for name, p in PRIMITIVES.items()}


def encode_env(env: dict, prims: dict[int, str] | None = None) -> list:
    """A generated program's environment as JSON-able entries, in order:
    primitive implementations by registry name, fused kernels and loop
    sub-programs by their own payloads, constants by ``serialize``'s value
    encoding.  Raises :class:`~repro_torch.core.serialize.SerializeError`
    for anything else (a profiling hook, a runtime-only value)."""
    from repro_torch.kernels.codegen import FusedKernel

    from .serialize import SerializeError, _enc_value

    prims = _prim_names() if prims is None else prims
    out = []
    for name, v in env.items():
        if name.startswith("_prim_"):
            pname = prims.get(id(v))
            if pname is None:
                raise SerializeError(f"{name} is not a registered primitive's impl")
            out.append([name, "prim", pname])
        elif isinstance(v, FusedKernel):
            out.append([name, "fused", v.payload(prims)])
        elif hasattr(v, "__lowered_source__"):
            out.append([name, "program", lowered_payload(v, prims)])
        elif name.startswith("_const_"):
            out.append([name, "const", _enc_value(v, {})])
        else:
            raise SerializeError(f"environment entry {name} is not durable")
    return out


def decode_env(entries: list) -> dict:
    """The inverse of :func:`encode_env` (no lowering, no kernel build)."""
    from repro_torch.kernels.codegen import FusedKernel

    from .serialize import SerializeError, _dec_prim, _dec_value

    env: dict[str, Any] = {}
    for name, kind, val in entries:
        if kind == "prim":
            env[name] = _dec_prim(val).impl
        elif kind == "fused":
            env[name] = FusedKernel.from_payload(val)
        elif kind == "program":
            env[name] = lowered_from_payload(val)
        elif kind == "const":
            env[name] = _dec_value(val, [])
        else:
            raise SerializeError(f"unknown environment entry kind {kind!r}")
    return env


def lowered_payload(fn: Callable, prims: dict[int, str] | None = None) -> dict:
    """What the program cache stores for a lowered callable: the emitted
    straight-line source and its environment (:func:`encode_env`), the
    generated Triton sources of its fused clusters among it."""
    return {
        "name": fn.__lowered_name__,
        "source": fn.__lowered_source__,
        "env": encode_env(fn.__lowered_env__, prims),
    }


def lowered_from_payload(payload: dict) -> Callable:
    """Rebuild a lowered callable from :func:`lowered_payload`'s output: the
    stored source runs over the decoded environment.  No optimizer, no
    ``lower_graph`` and no kernel build: fused kernels come back as their
    stored sources, and Triton builds (or finds in its cache) each binary at
    the first launch on the card.  ``__fusion_plan__`` is None on the result
    (the plan's clusters are graph nodes); ``__fused_kernels__`` holds the
    program's top-level kernels."""
    env = decode_env(payload["env"])
    kernels = [v for k, v in env.items() if k.startswith("_fused_")]
    return _assemble(payload["name"], payload["source"], env, None, kernels)


def _placed(fn: Callable, namespace: dict, env: dict) -> Callable:
    """Run ``fn`` on its arguments' device: tensors made from Python scalars
    go there (``dtypes.default_device``), and tensor constants (folded at
    compile time, on the CPU) are moved there once per device."""
    consts = {k: v for k, v in env.items() if isinstance(v, torch.Tensor)}
    placed_on: list = [torch.device("cpu")]

    def run(*args: Any) -> Any:
        dev = device_of(args)
        if consts and dev != placed_on[0]:
            for k, v in consts.items():
                namespace[k] = v.to(dev)
            placed_on[0] = dev
        with default_device(dev):
            return fn(*args)

    return run


def try_lower(graph: Graph, *, fuse: bool = False) -> Callable | None:
    """``lower_graph`` if possible, else None (caller falls back to the VM).

    The result is cached on the graph (``graph.flags``), keyed by the fuse
    tier: ``MyiaFunction.specialize`` and ``compile_graph`` both probe the
    same optimized clone, and each probe used to re-walk the whole graph
    (blockers scan + emission).  The entry records which graph it belongs
    to — ``clone_graph`` shallow-copies ``flags``, and a clone (which the
    pipeline then optimizes further) must NOT inherit the original's
    verdict.  The cache is only correct for graphs that are no longer
    being rewritten — which is the only time callers lower.
    """
    entry = graph.flags.get("_lower_cache")
    if entry is None or entry[0] is not graph:
        entry = (graph, {})
        graph.flags["_lower_cache"] = entry
    cache = entry[1]
    if fuse in cache:
        return cache[fuse]
    try:
        fn = lower_graph(graph, fuse=fuse)
    except LoweringError:
        fn = None
    cache[fuse] = fn
    return fn
