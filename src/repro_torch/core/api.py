"""Public API of the Myia-style toolchain (paper §4).

* ``@myia`` — compile a pure-Python-subset function through the pipeline:
  parse → (AD transform) → inline → infer (call-site specialization on the
  actual argument types/shapes, §4.2) → worklist-optimize (§4.3) → execute.
  First-order graphs are *lowered directly* to a straight-line callable
  (``repro_torch.core.lowering``) that runs eagerly: every call executes
  the same generated code (the reference's tier-0 compile and ``jax.jit``
  have no counterpart).  Graphs with residual recursion / higher-order
  calls run on the reference VM.  See ``docs/pipeline.md``.
* ``grad`` / ``value_and_grad`` / ``vjp`` — the ST AD transforms of §3.2.
  ``grad`` is also a *macro*: used inside ``@myia`` code it expands at parse
  time (paper Figure 1: "After the grad macro is expanded …").

Compile configuration — migration note
--------------------------------------

All four entry points (and ``compile_pipeline``) take a single frozen
:class:`CompileOptions` carrying the full tier set::

    opts = CompileOptions(fuse=True, checkpoint_policy="auto")
    f  = myia(fn, options=opts)
    df = grad(fn, options=opts)          # same tiers — full parity

The historical per-kwarg spelling (``myia(fn, fuse=True, ...)``) still
works through a shim that assembles the same ``CompileOptions`` and emits
a ``DeprecationWarning``; both spellings produce identical compiled
artifacts (same structural hash — pinned by tests).  ``in_specs`` arms the
SPMD tier under a concrete mesh context (``repro_torch.parallel``).
``checkpoint_policy``
(loop-adjoint recording: ``"auto"`` / ``"save_all"`` / ``"recompute"`` /
int slot count, see ``repro_torch.core.ad``) is only reachable through
``CompileOptions``.  ``MyiaFunction.options`` holds the resolved object;
the legacy attributes (``.fuse``, ``.program_cache``, ...) remain as
delegating properties.

``grad``/``value_and_grad``/``vjp`` of a program containing loops or
recursion defer the AD transform to specialization time: the primal runs
the full pipeline (so parsed loops become ``while_loop``/``scan_loop``
primitives) *before* the adjoint is built, which is what lets grad-of-loop
programs compile VM-free instead of leaving residual ▶-closures.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.parallel import current_mesh_context, is_concrete

from .ad import (
    _needs_loop_pipeline,
    build_grad_graph,
    build_value_and_grad_graph,
    build_vjp_graph,
)
from .infer import InferenceError, abstract_of_value, infer
from .ir import Constant, Graph, clone_graph
from .lowering import lowering_blockers, try_lower
from .opt import OptStats, count_nodes, optimize
from .parser import MyiaSyntaxError, parse_function
from .spmd import SpmdError
from .torch_backend import compile_graph_spmd, mesh_descriptor
from .dtypes import default_device, device_of, device_results, np_dtype, to_numpy
from .values import is_array_like
from .vm import VM

__all__ = [
    "myia",
    "grad",
    "value_and_grad",
    "vjp",
    "MyiaFunction",
    "CompileOptions",
    "compile_pipeline",
]


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """One immutable object carrying every compile tier configuration.

    Replaces the seven loose kwargs that accreted onto the entry points;
    every entry point accepts ``options=CompileOptions(...)`` and threads
    it whole, so each tier (fusion, patterns, SPMD, AOT cache, tracing,
    loop-adjoint checkpointing) is reachable from *all* of
    ``myia``/``grad``/``value_and_grad``/``vjp``.

    ===================  ==========  =============================================
    field                default     tier it arms
    ===================  ==========  =============================================
    ``backend``          ``"torch"`` lowered eager execution (``"vm"``: reference)
    ``opt``              ``True``    the worklist optimizer (§4.3)
    ``fuse``             ``False``   fusion clusters → generated Triton kernels
    ``patterns``         ``False``   kernel-pattern rewrites (rmsnorm/attention)
    ``in_specs``         ``None``    SPMD partitioning (under a mesh context)
    ``program_cache``    ``None``    executable tier (``ProgramCache``)
    ``graph_cache``      ``None``    optimized-graph tier (skips optimize warm)
    ``trace``            ``None``    observability (``Tracer`` spans)
    ``checkpoint_policy``  ``"auto"``  loop-adjoint memory/recompute point
    ``profile``          ``False``   runtime profiler (instrumented launch)
    ===================  ==========  =============================================

    ``graph_cache`` and ``program_cache`` usually point at the *same*
    :class:`~repro_torch.core.torch_backend.ProgramCache` object — the two
    tiers key and store independently (``<key>.graph.json`` vs ``<key>.pkl``).
    """

    #: execution backend: "torch" (lowered eager) or "vm" (reference)
    backend: str = "torch"
    #: run the optimizer (False: parse-and-execute, debugging only)
    opt: bool = True
    #: fusion tier — clustered regions run as generated Triton kernels
    fuse: bool = False
    #: kernel-pattern rewrites (rmsnorm / attention → kernel prims)
    patterns: bool = False
    #: SPMD tier — per-argument sharding specs (active under a mesh)
    in_specs: tuple | None = None
    #: executable tier — a ProgramCache making built specializations durable
    program_cache: Any = None
    #: optimized-graph tier — a ProgramCache (usually the same object as
    #: ``program_cache``) consulted *before* the optimizer runs: a hit
    #: deserializes the stored post-optimize graph and skips the
    #: optimize + closure-elim pipeline phases entirely
    graph_cache: Any = None
    #: observability tier — a Tracer armed for every specialization
    trace: Any = None
    #: loop-adjoint carry recording: "auto" / "save_all" / "recompute"
    #: or an int slot count (see ``repro_torch.core.ad._CHECKPOINT_SLOTS``)
    checkpoint_policy: str | int = "auto"
    #: runtime-profiler tier — while a ``repro_torch.obs.profile.Profiler``
    #: is armed, calls run an instrumented lowering that times every launch
    profile: bool = False

    def __post_init__(self) -> None:
        if self.backend not in ("torch", "vm"):
            raise ValueError(f"backend must be 'torch' or 'vm', got {self.backend!r}")


_UNSET: Any = object()

#: the legacy kwargs the shim still accepts (checkpoint_policy and
#: graph_cache are newer than the shim and reachable only through
#: CompileOptions — no legacy spelling to support)
_LEGACY_FIELDS = (
    "backend", "opt", "fuse", "patterns", "in_specs", "program_cache", "trace",
)


def _resolve_options(
    options: CompileOptions | None, caller: str, legacy: dict[str, Any]
) -> CompileOptions:
    """The legacy-kwarg shim: fold explicitly-passed per-tier kwargs into
    a ``CompileOptions`` (with a ``DeprecationWarning``), or pass the
    given options object through.  Mixing both spellings is an error —
    silently preferring one would mask a config bug."""
    passed = {k: v for k, v in legacy.items() if v is not _UNSET}
    if options is not None:
        if passed:
            raise TypeError(
                f"{caller}() got both options= and legacy compile kwargs "
                f"{sorted(passed)}; pass everything in CompileOptions"
            )
        return options
    if passed:
        warnings.warn(
            f"{caller}({', '.join(sorted(passed))}=...) is deprecated; pass "
            f"options=CompileOptions(...) instead",
            DeprecationWarning,
            stacklevel=3,
        )
        return CompileOptions(**passed)
    return CompileOptions()

def _ir_dtype(a: Any) -> Any:
    """The IR dtype of an array-like argument (numpy dtypes, as the reference
    keys its specializations)."""
    dt = getattr(a, "dtype", None)
    if dt is None:
        return None
    return np_dtype(dt) if isinstance(dt, torch.dtype) else np.dtype(dt)


def _content_key(a: Any) -> tuple:
    """Hashable content-capturing key for an unhashable static argument.

    The whole value is baked into the specialized runner, so two statics
    may share a cache slot only if their *contents* agree — ``repr`` is not
    enough (numpy elides arrays > 1000 elements with ``...``)."""
    if isinstance(a, (list, tuple)):
        return (type(a).__name__, tuple(_content_key(e) for e in a))
    if isinstance(a, dict):
        return (
            "dict",
            tuple(
                (_content_key(k), _content_key(v))
                for k, v in sorted(a.items(), key=lambda kv: repr(kv[0]))
            ),
        )
    if is_array_like(a) or isinstance(a, np.generic):
        arr = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
        return ("arrval", arr.shape, str(arr.dtype), hashlib.sha1(arr.tobytes()).hexdigest())
    try:
        hash(a)
        return ("val", type(a).__name__, a)
    except TypeError:
        return ("repr", type(a).__name__, repr(a))


def compile_pipeline(
    graph: Graph,
    example_args: tuple | None = None,
    *,
    opt: bool = True,
    infer_types: bool = True,
    engine: str = "worklist",
    stats: OptStats | None = None,
    patterns: bool = False,
    loops: bool = True,
    options: CompileOptions | None = None,
    snapshot: Callable[[str, Graph], None] | None = None,
) -> Graph:
    """inline → infer → optimize → loop-lower, on a private clone of
    ``graph``.

    ``options`` (a :class:`CompileOptions`) supplies ``opt``/``patterns``
    when given — the same object the entry points thread — while the
    pipeline-internal knobs (``engine``, ``stats``, ``infer_types``,
    ``loops``) stay explicit kwargs.
    ``engine`` / ``stats`` are forwarded to :func:`repro_torch.core.opt.optimize`
    (all optimize calls share the one stats object).  ``patterns=True``
    additionally enables the kernel-pattern rules of the fusion tier
    (rmsnorm / softmax-attention subgraphs rewritten to the hand-written
    kernel primitives registered in ``repro_torch.kernels.ops``) in the
    shape-directed pass.  ``loops=True`` (the closure-elimination tier)
    rewrites residual tail-recursive families into ``while_loop`` /
    ``scan_loop`` primitive applies (``repro_torch.core.closure``) so parsed
    loops lower instead of falling back to the VM; when ``stats`` is
    given, any remaining fallback reasons land in
    ``stats.fallback_reasons`` (structured, see ``FallbackReason``).

    ``snapshot`` (the explain layer's IR-dump hook) is called as
    ``snapshot(stage, graph)`` after each pipeline stage — ``cloned`` /
    ``optimized`` / ``shape_opt`` / ``loop_lowered`` / ``final``, or
    ``graph_cache_hit`` when the optimized-graph tier answers.  None (the
    default) costs nothing.
    """
    if options is not None:
        opt = options.opt
        patterns = options.patterns
    gcache = options.graph_cache if options is not None else None
    # every phase below opens a span (see docs/observability.md for the
    # taxonomy); disarmed, span() is a single global None-check
    with obs_trace.span("compile_pipeline", graph=graph.name):
        gkey = None
        if gcache is not None and opt and infer_types and example_args is not None:
            # optimized-graph tier: key the PRE-optimization graph × abstract
            # signature × optimizer config; a hit deserializes the stored
            # post-optimize post-closure-elim graph and skips both expensive
            # phases, falling through to infer → lower below
            from .serialize import SerializeError

            hit = None
            with obs_trace.span("cache.graph_lookup", graph=graph.name) as sp:
                try:
                    gkey = gcache.graph_key(
                        graph, example_args,
                        opt=opt, patterns=patterns, loops=loops, engine=engine,
                    )
                except SerializeError:
                    sp.set(verdict="unkeyable")  # exotic constants: full pipeline
                else:
                    hit = gcache.load_graph(gkey)
                    sp.set(verdict="hit" if hit is not None else "miss")
            if hit is not None:
                try:
                    infer(hit, *example_args)  # re-derive abstracts (cheap)
                except InferenceError:
                    pass
                if stats is not None:
                    from .closure import analyze_blockers

                    with obs_trace.span("closure.analyze_blockers"):
                        stats.fallback_reasons = [
                            r.as_dict() for r in analyze_blockers(hit)
                        ]
                if snapshot is not None:
                    snapshot("graph_cache_hit", hit)
                    snapshot("final", hit)
                return hit
        with obs_trace.span("clone"):
            g = clone_graph(graph)
        if snapshot is not None:
            snapshot("cloned", g)
        if not opt:
            if snapshot is not None:
                snapshot("final", g)
            return g
        optimize(g, engine=engine, stats=stats)  # structural pass (no abstracts)
        if snapshot is not None:
            snapshot("optimized", g)
        if infer_types and example_args is not None:
            try:
                infer(g, *example_args)
            except InferenceError:
                pass  # dynamic program: shape-directed rules simply won't fire
            # shape-directed pass (kernel patterns need inferred shapes)
            optimize(g, engine=engine, stats=stats, patterns=patterns)
            if snapshot is not None:
                snapshot("shape_opt", g)
            if loops:
                from .closure import lower_loops

                report = lower_loops(g, stats=stats)
                if report.lowered:
                    # the rewrite leaves dead families and foldable glue; the
                    # cleanup pass also optimizes *inside* the loop subgraphs
                    optimize(g, engine=engine, stats=stats, patterns=patterns)
                if snapshot is not None:
                    snapshot("loop_lowered", g)
        if gkey is not None:
            with obs_trace.span("cache.graph_write", graph=graph.name):
                gcache.store_graph(gkey, g)
        if stats is not None:
            from .closure import analyze_blockers

            with obs_trace.span("closure.analyze_blockers"):
                stats.fallback_reasons = [r.as_dict() for r in analyze_blockers(g)]
        if snapshot is not None:
            snapshot("final", g)
        return g


def _wrap_profiled(inner: Callable, g: Graph, fuse: bool) -> Callable:
    """The ``CompileOptions.profile`` tier: while a
    :class:`repro_torch.obs.profile.Profiler` is armed, route calls to a
    lazily-built *instrumented* lowering (``lower_graph(profile=True)``) so
    every launch records its time and bytes moved.  Disarmed — or when the
    graph doesn't lower — the wrapped runner is a single module-global
    None-check away from the ordinary tiers."""
    from repro_torch.obs import profile as obs_profile

    from .lowering import LoweringError, lower_graph

    state: dict[str, Any] = {}

    def runner(*args):
        if obs_profile._ACTIVE is None:
            return inner(*args)
        pfn = state.get("fn", _UNSET)
        if pfn is _UNSET:
            try:
                pfn = lower_graph(g, fuse=fuse, profile=True)
            except LoweringError:
                pfn = None  # VM-fallback graph: nothing to instrument
            state["fn"] = pfn
        if pfn is None:
            return inner(*args)
        return pfn(*args)

    runner.profiled = True
    for attr in ("lowered", "fn", "aot", "cache_key", "degraded"):
        if hasattr(inner, attr):
            setattr(runner, attr, getattr(inner, attr))
    return runner


def _apply_transform(
    g: Graph, t: tuple, example: tuple | None, policy: str | int
) -> Graph:
    """Apply one pending AD stage.  ``example`` lets the builders run the
    primal through the full pipeline first (loops lower before J), which
    is what makes grad-of-loop adjoints closed first-order graphs."""
    kind = t[0]
    if kind == "grad":
        return build_grad_graph(
            g, t[1], example_args=example, checkpoint_policy=policy
        )
    if kind == "vag":
        return build_value_and_grad_graph(
            g, t[1], example_args=example, checkpoint_policy=policy
        )
    if kind == "vjp":
        return build_vjp_graph(g, example_args=example, checkpoint_policy=policy)
    raise ValueError(f"unknown transform {t!r}")


class MyiaFunction:
    """A function compiled through the Myia pipeline, specialized and cached
    per call signature (the paper's call-site specialization)."""

    def __init__(
        self,
        fn: Callable | None = None,
        graph: Graph | None = None,
        *,
        options: CompileOptions | None = None,
        name: str | None = None,
        transforms: tuple = (),
        backend: Any = _UNSET,
        opt: Any = _UNSET,
        fuse: Any = _UNSET,
        patterns: Any = _UNSET,
        in_specs: Any = _UNSET,
        program_cache: Any = _UNSET,
        trace: Any = _UNSET,
    ) -> None:
        if fn is None and graph is None:
            raise ValueError("need fn or graph")
        self._fn = fn
        self._graph = graph
        #: the resolved :class:`CompileOptions` — the single source of
        #: truth for every tier (the legacy per-tier attributes below are
        #: delegating properties over this object):
        #:
        #: * ``fuse`` / ``patterns`` — fusion tier: clustered regions run
        #:   as generated Triton kernels (docs/fusion.md).
        #: * ``trace`` — observability tier: a Tracer armed for the
        #:   dynamic extent of every specialization.
        #: * ``checkpoint_policy`` — loop-adjoint carry recording (used
        #:   when pending AD ``transforms`` resolve at specialization).
        self.options = _resolve_options(
            options, "MyiaFunction", {
                "backend": backend, "opt": opt, "fuse": fuse,
                "patterns": patterns, "in_specs": in_specs,
                "program_cache": program_cache, "trace": trace,
            },
        )
        #: pending AD transforms, applied at specialization time *after*
        #: the primal has run the loop-lowering pipeline: a tuple of
        #: ``("grad", wrt)`` / ``("vag", wrt)`` / ``("vjp",)`` stages.
        #: Empty for plain ``@myia`` functions and for AD of straight-line
        #: programs (those build their adjoint graph eagerly).
        self.transforms = tuple(transforms)
        self._resolved: dict[tuple, Graph] = {}
        self._specializations: dict[tuple, Callable] = {}
        self.__name__ = name or (fn.__name__ if fn is not None else graph.name)
        if fn is not None:
            functools.update_wrapper(self, fn, updated=())

    # -- legacy attribute surface (delegates to .options) -----------------
    def _opt_property(field):  # noqa: N805 — descriptor factory, not a method
        def get(self):
            return getattr(self.options, field)

        def set_(self, value):
            self.options = dataclasses.replace(self.options, **{field: value})

        return property(get, set_, doc=f"delegates to CompileOptions.{field}")

    backend = _opt_property("backend")
    opt = _opt_property("opt")
    fuse = _opt_property("fuse")
    patterns = _opt_property("patterns")
    in_specs = _opt_property("in_specs")
    program_cache = _opt_property("program_cache")
    trace = _opt_property("trace")
    del _opt_property

    # -- graph access ---------------------------------------------------
    @property
    def graph(self) -> Graph:
        if self._graph is None:
            self._graph = parse_function(self._fn)
        return self._graph

    def __myia_graph_factory__(self) -> Graph:
        return self.graph

    # -- pending AD transforms -------------------------------------------
    def _resolved_graph(self, example: tuple | None) -> Graph:
        """The graph to compile: the primal with any pending AD transforms
        applied.  ``example`` is the full abstract signature of *this*
        function; each trailing ``vjp`` stage consumes one argument (the
        output cotangent), so the primal's own signature is the prefix."""
        if not self.transforms:
            return self.graph
        n_vjp = sum(1 for t in self.transforms if t[0] == "vjp")
        base_ex = example[: len(example) - n_vjp] if example is not None else None
        key = ("resolved", base_ex)
        hit = self._resolved.get(key)
        if hit is not None:
            return hit
        g = self.graph
        ex = base_ex
        for t in self.transforms:
            g = _apply_transform(g, t, ex, self.options.checkpoint_policy)
            # downstream stages differentiate the adjoint graph itself;
            # its signature matches the primal's (grad) so ex carries over
        self._resolved[key] = g
        return g

    # -- compilation ------------------------------------------------------
    def _sigkey(self, args: tuple) -> tuple:
        out = []
        for a in args:
            if is_array_like(a) or isinstance(a, np.generic):
                out.append(("arr", tuple(np.shape(a)), _ir_dtype(a)))
            elif isinstance(a, tuple):
                out.append(("tup", self._sigkey(a)))
            else:
                try:
                    hash(a)
                except TypeError:
                    # unhashable static (list, dict, …): its *content* is
                    # baked into the specialization, so the key must capture
                    # content — repr() truncates large arrays and collides
                    out.append(("val", type(a).__name__, _content_key(a)))
                else:
                    out.append(("val", type(a).__name__, a))
        return tuple(out)

    def _active_mesh(self):
        """The concrete mesh the SPMD tier should target, or None.

        None when no ``in_specs`` were configured, no mesh context is
        active, or the context's mesh is abstract (spec-resolution tests).
        A trivial 1×1 mesh still takes the spmd path — that identity with
        the single-device tier is pinned by tests."""
        if self.in_specs is None or self.backend != "torch":
            return None
        ctx = current_mesh_context()
        if ctx is None or not is_concrete(ctx.mesh):
            return None
        return ctx.mesh

    def specialize(self, args: tuple) -> Callable:
        mesh = self._active_mesh()
        # key by shape AND rank/device identity: a same-shape mesh over other
        # ranks must not reuse a runner closed over the old mesh (the same
        # identity rule the program cache's key uses)
        key = (self.backend, self.fuse, self.patterns, mesh_descriptor(mesh),
               self._sigkey(args))
        hit = self._specializations.get(key)
        if hit is not None:
            return hit
        with obs_trace.tracing(self.trace), obs_trace.span(
            "specialize", graph=self.__name__, fuse=self.fuse
        ):
            try:
                example = tuple(abstract_of_value(a) for a in args)
            except InferenceError:
                example = None  # e.g. a list static: skip inference, VM handles it
            base = self._resolved_graph(example) if self.transforms else self.graph
            g = compile_pipeline(base, example, options=self.options)
            runner = None
            if mesh is not None:
                runner = self._make_spmd_runner(g, args, mesh)
                # (spmd runners are never profile-wrapped: collectives
                # only execute inside the per-shard program)
            if runner is None:
                runner = self._make_runner(g, args)
                if self.options.profile and self.backend == "torch":
                    runner = _wrap_profiled(runner, g, self.fuse)
            self._specializations[key] = runner
            return runner

    def _make_spmd_runner(self, g: Graph, example_args: tuple, mesh) -> Callable | None:
        """Sharded runner, or None → the single-device tier, as the
        reference's (graph not first-order / non-array arguments /
        propagation failure: ``SpmdError``, and nothing else)."""
        if not all(is_array_like(a) for a in example_args):
            return None
        try:
            return compile_graph_spmd(g, mesh, self.in_specs, fuse=self.fuse)
        except SpmdError:
            return None

    def _make_runner(self, g: Graph, example_args: tuple) -> Callable:
        """The lowered straight-line callable, run eagerly (every call runs
        the same code; fused clusters dispatch by device and kernel mode at
        each call), or the VM for graphs that do not lower.

        With a ``program_cache``, an all-array specialization of a lowerable
        graph is answered by the cache: a hit rebuilds the stored program
        without lowering it; a miss builds it (``lower_graph``) and persists
        it.  A build that fails past its retries takes the bottom rung of the
        degraded-mode ladder: the reference VM on the same optimized graph,
        counted in ``vm_fallbacks``."""
        if (
            self.program_cache is not None
            and self.backend == "torch"
            and all(is_array_like(a) for a in example_args)
            and not lowering_blockers(g)
        ):
            from .serialize import SerializeError
            from .torch_backend import CompileFailed

            try:
                return self.program_cache.load_or_compile(g, example_args, fuse=self.fuse)
            except SerializeError:
                pass  # not durable (exotic constants): ordinary tiers
            except CompileFailed:
                # bottom rung: the build failed even after bounded retries.  The
                # reference VM evaluates the same optimized graph, slow but
                # correct, and the downgrade is counted so a fleet can alarm on it
                self.program_cache.stats.vm_fallbacks += 1

                def runner(*args):
                    with default_device(device_of(args)):
                        return VM().call(g, args)

                runner.lowered = False
                runner.fn = None
                runner.degraded = "vm_oracle"
                return runner
        lowered = try_lower(g, fuse=self.fuse) if self.backend == "torch" else None
        # the torch backend returns what the reference's jit does: Python scalars
        # as 0-d tensors on the call's device; the "vm" backend returns the VM's
        if lowered is not None:
            def runner(*args):
                return device_results(lowered(*args), args)
        else:
            def runner(*args):
                with default_device(device_of(args)):
                    out = VM().call(g, args)
                return out if self.backend == "vm" else device_results(out, args)

        runner.lowered = lowered is not None
        runner.fn = lowered
        return runner

    def __call__(self, *args: Any) -> Any:
        return self.specialize(args)(*args)

    # -- introspection (benchmarks / tests) --------------------------------
    def explain(self, *example_args: Any, dump_ir: str | None = None):
        """A structured compile report for this function at
        ``example_args``'s signature: per-cluster fusion verdicts, per-node
        decisions with reasons, cache-tier verdicts, checkpoint policies and
        residual VM-fallback reasons — see
        :class:`repro_torch.obs.explain.ExplainReport`.  ``dump_ir="dir/"``
        additionally writes diffable per-stage IR text dumps."""
        from repro_torch.obs.explain import explain_function

        return explain_function(self, example_args, dump_ir=dump_ir)

    def optimized_graph(self, *args: Any) -> Graph:
        example = tuple(abstract_of_value(a) for a in args)
        base = self._resolved_graph(example) if self.transforms else self.graph
        return compile_pipeline(base, example, options=self.options)

    def node_count(self, *args: Any, optimized: bool = True) -> int:
        g = self.optimized_graph(*args) if optimized else self.graph
        return count_nodes(g)


def myia(
    fn: Callable | None = None,
    *,
    options: CompileOptions | None = None,
    backend: Any = _UNSET,
    opt: Any = _UNSET,
    fuse: Any = _UNSET,
    patterns: Any = _UNSET,
    in_specs: Any = _UNSET,
    program_cache: Any = _UNSET,
    trace: Any = _UNSET,
):
    """Decorator: compile ``fn`` (pure Python subset) through the pipeline.

    Tier configuration arrives as one ``options=CompileOptions(...)``
    (the per-kwarg spelling still works but is deprecated — see the
    module docstring's migration note):

    * ``fuse=True`` turns on the fusion tier (clustered regions run as
      generated Triton kernels); ``patterns=True`` additionally rewrites
      kernel-shaped subgraphs (rmsnorm, softmax-attention core) to the
      hand-written kernel primitives.  Both default off: the unfused
      straight-line lowering remains the bit-exact reference.
    * ``trace`` (a :class:`repro_torch.obs.trace.Tracer`) arms the
      observability tier: every specialization compiles with the tracer
      armed, so pipeline phases and inline waves land in its buffer.
    * ``program_cache`` (a :class:`repro_torch.core.torch_backend.ProgramCache`)
      arms the executable tier: all-array specializations of lowerable
      graphs are built once and persisted, so a warm process rebuilds the
      stored program instead of lowering it again.
    * ``in_specs`` (one sharding spec per argument) arms the SPMD tier:
      under an active concrete mesh context the optimized (and fused) graph
      is partitioned per shard and run on every rank of the mesh, with
      collectives over ``torch.distributed``; with no mesh active the
      single-device tiers run unchanged.
    """
    opts = _resolve_options(options, "myia", {
        "backend": backend, "opt": opt, "fuse": fuse, "patterns": patterns,
        "in_specs": in_specs, "program_cache": program_cache, "trace": trace,
    })

    def wrap(f: Callable) -> MyiaFunction:
        return MyiaFunction(f, options=opts)

    return wrap(fn) if fn is not None else wrap


# ---------------------------------------------------------------------------
# AD entry points (callable API + in-language macros)
# ---------------------------------------------------------------------------


def _as_graph(fn: Any) -> Graph:
    if isinstance(fn, Graph):
        return fn
    if isinstance(fn, MyiaFunction):
        return fn.graph
    return parse_function(fn)


def _macro_expand_grad(parser, block, ast_args):
    if len(ast_args) < 1:
        raise MyiaSyntaxError("grad() takes a function argument")
    fn_node = parser.expr(block, ast_args[0])
    if not (isinstance(fn_node, Constant) and isinstance(fn_node.value, Graph)):
        raise MyiaSyntaxError("grad() macro requires a statically-known function")
    wrt: int | tuple = 0
    if len(ast_args) > 1:
        import ast as _ast

        a1 = ast_args[1]
        if isinstance(a1, _ast.Constant):
            wrt = a1.value
        elif isinstance(a1, _ast.Tuple):
            wrt = tuple(e.value for e in a1.elts)
        else:
            raise MyiaSyntaxError("grad() wrt must be a literal")
    return Constant(build_grad_graph(fn_node.value, wrt))


def _macro_expand_vag(parser, block, ast_args):
    fn_node = parser.expr(block, ast_args[0])
    if not (isinstance(fn_node, Constant) and isinstance(fn_node.value, Graph)):
        raise MyiaSyntaxError("value_and_grad() macro requires a statically-known function")
    return Constant(build_value_and_grad_graph(fn_node.value))


def _transform_entry(
    fn: Any, transform: tuple, opts: CompileOptions, caller: str
) -> MyiaFunction:
    """Shared construction path of the AD entry points.

    Straight-line primals build their adjoint graph eagerly (back-compat:
    ``grad(f).graph`` is the adjoint, and the grad *macro* path stays
    parse-time).  Primals containing loops or recursion defer the
    transform to specialization (``MyiaFunction.transforms``), so the
    primal runs the loop-lowering pipeline — with the concrete signature
    — before J sees it; that ordering is what keeps grad-of-loop programs
    off the VM.  Chaining (``grad(grad(f))``) extends the pending tuple."""
    if isinstance(fn, MyiaFunction) and fn.transforms:
        return MyiaFunction(
            fn=fn._fn, graph=fn._graph, options=opts,
            transforms=fn.transforms + (transform,),
            name=f"{transform[0]}_{fn.__name__}",
        )
    primal = _as_graph(fn)
    if _needs_loop_pipeline(primal):
        return MyiaFunction(
            graph=primal, options=opts, transforms=(transform,),
            name=f"{transform[0]}_{primal.name}",
        )
    g = _apply_transform(primal, transform, None, opts.checkpoint_policy)
    return MyiaFunction(graph=g, options=opts, name=g.name)


def grad(
    fn: Any,
    wrt: int | tuple[int, ...] = 0,
    *,
    options: CompileOptions | None = None,
    backend: Any = _UNSET,
    opt: Any = _UNSET,
    fuse: Any = _UNSET,
    patterns: Any = _UNSET,
    in_specs: Any = _UNSET,
    program_cache: Any = _UNSET,
    trace: Any = _UNSET,
):
    """Reverse-mode gradient of a scalar-output function (paper §3.2).

    The adjoint takes the same arguments as ``fn``, so every tier in
    ``options`` (SPMD ``in_specs``, the AOT ``program_cache``, ``trace``)
    carries over unchanged — full parity with ``myia``."""
    opts = _resolve_options(options, "grad", {
        "backend": backend, "opt": opt, "fuse": fuse, "patterns": patterns,
        "in_specs": in_specs, "program_cache": program_cache, "trace": trace,
    })
    return _transform_entry(fn, ("grad", wrt), opts, "grad")


def value_and_grad(
    fn: Any,
    wrt: int | tuple[int, ...] = 0,
    *,
    options: CompileOptions | None = None,
    backend: Any = _UNSET,
    opt: Any = _UNSET,
    fuse: Any = _UNSET,
    patterns: Any = _UNSET,
    in_specs: Any = _UNSET,
    program_cache: Any = _UNSET,
    trace: Any = _UNSET,
):
    opts = _resolve_options(options, "value_and_grad", {
        "backend": backend, "opt": opt, "fuse": fuse, "patterns": patterns,
        "in_specs": in_specs, "program_cache": program_cache, "trace": trace,
    })
    return _transform_entry(fn, ("vag", wrt), opts, "value_and_grad")


def vjp(
    fn: Any,
    *,
    options: CompileOptions | None = None,
    backend: Any = _UNSET,
    opt: Any = _UNSET,
    fuse: Any = _UNSET,
    patterns: Any = _UNSET,
    in_specs: Any = _UNSET,
    program_cache: Any = _UNSET,
    trace: Any = _UNSET,
):
    opts = _resolve_options(options, "vjp", {
        "backend": backend, "opt": opt, "fuse": fuse, "patterns": patterns,
        "in_specs": in_specs, "program_cache": program_cache, "trace": trace,
    })
    return _transform_entry(fn, ("vjp",), opts, "vjp")


grad.__is_myia_macro__ = True
grad.__myia_macro_expand__ = _macro_expand_grad
value_and_grad.__is_myia_macro__ = True
value_and_grad.__myia_macro_expand__ = _macro_expand_vag
