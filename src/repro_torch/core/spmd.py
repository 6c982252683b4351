"""SPMD tier: thread sharding through the optimize→fuse→lower pipeline.

The port of ``repro/core/spmd.py``.  The paper's closing argument (§4) is
that once the ST adjoint has been inlined and simplified, the remaining
straight-line graph is "amenable to ahead-of-time optimization".  Sharding
is such an optimization: the partitioning of every tensor is a *property of
the IR*, propagated ahead of time — not a bolt-on at the execution layer.
This module takes an optimized, shape-inferred, first-order graph plus
per-parameter sharding specs and produces the **per-shard program** that
every rank of a mesh executes (``torch_backend.compile_graph_spmd``):

1. **Propagation** (:func:`propagate`): a forward pass over the inferred
   abstracts assigns each node a spec — which mesh axes shard which dims.
   Elementwise ops merge operand specs; matmul contracts; reductions drop
   reduced dims; broadcasts get a *backward refinement* pass (an expanded
   dim can adopt its consumers' sharding for free — each shard simply
   materializes a smaller broadcast).
2. **Resharding points**: where the propagated specs disagree with what an
   op needs, the transform inserts explicit collectives —
   ``psum_axes``/``pmax_axes`` after cross-shard reductions and
   contractions, ``all_gather_axes`` to replicate a sharded value,
   ``shard_slice`` (index math only, no communication) to re-partition a
   replicated one.  Collectives classify as *opaque* in the fusion
   partitioner, so no cluster ever spans a resharding point, and the
   optimizer refuses to fold them (``opt.try_rules``).
3. **Localization** (:func:`shard_graph`): shape-carrying constants
   (``broadcast_to``/``unreduce``/``unbroadcast`` targets) are rewritten
   to per-shard shapes and the transformed graph is re-inferred at the
   *local* parameter shapes, so the fusion code generator builds its
   Triton kernels (K1) for the shard a rank actually owns.

Everything here is backend-free graph logic, carried across from the
reference as it is: plans, per-shard graphs and their hashes equal the
reference's.  The one difference is the partition value: the reference
returns ``jax.sharding.PartitionSpec``; the port returns a plain tuple of
per-dim entries (``None``, an axis name, or a tuple of names), and tuples of
those for tuple values.

Specs are internally tuples of per-dim axis-name tuples (``()`` =
replicated); :func:`normalize_spec` accepts partition tuples, plain tuples
of entries, axis-name strings and ``None``, with the divisibility fallback
(a dim that does not divide by its mesh axes replicates).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from . import primitives as P
from .fusion import BROADCAST, ELEMENTWISE
from .infer import AArray, ATuple, AbstractValue, infer
from .ir import Apply, Constant, Graph, Node, toposort
from .lowering import lowering_blockers

__all__ = [
    "SpmdError",
    "SpmdPlan",
    "ShardedGraph",
    "normalize_spec",
    "propagate",
    "shard_graph",
    "spec_to_partition",
    "local_shape",
]


class SpmdError(Exception):
    """The graph cannot be sharded; callers fall back to single-device."""


#: per-dim spec entry: a tuple of mesh axis names, () = replicated
Entry = tuple
#: array spec: one Entry per dim
Spec = tuple

_SCALAR = ("<scalar>",)  # sentinel spec for non-array values


class _TSpec:
    """Spec of a tuple value (mirrors ATuple)."""

    __slots__ = ("elements",)

    def __init__(self, elements: tuple) -> None:
        self.elements = tuple(elements)

    def __eq__(self, o: object) -> bool:
        return isinstance(o, _TSpec) and o.elements == self.elements

    def __hash__(self) -> int:
        return hash(self.elements)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"T{self.elements!r}"


def _is_replicated(spec: Any) -> bool:
    if spec is _SCALAR:
        return True
    if isinstance(spec, _TSpec):
        return all(_is_replicated(e) for e in spec.elements)
    return all(e == () for e in spec)


def normalize_spec(
    spec: Any, abstract: AbstractValue, mesh_axes: dict[str, int]
) -> Any:
    """Normalize a user-facing spec against an abstract value.

    Accepts a partition tuple or list of entries (``None`` | axis name |
    tuple of names), or ``None`` (fully replicated).  Unknown mesh axes are
    dropped; a dim that does not divide by the product of its axis sizes
    replicates (the ``distributed.sharding`` divisibility rule); no mesh
    axis may shard two dims.
    """
    if isinstance(abstract, ATuple):
        parts = list(spec) if isinstance(spec, (tuple, list)) else [spec] * len(
            abstract.elements
        )
        if len(parts) != len(abstract.elements):
            raise SpmdError(f"tuple spec arity mismatch: {spec!r} vs {abstract!r}")
        return _TSpec(
            tuple(normalize_spec(s, a, mesh_axes) for s, a in zip(parts, abstract.elements))
        )
    if not isinstance(abstract, AArray):
        if spec not in (None, ()) and not _is_partition_like_empty(spec):
            raise SpmdError(f"cannot shard non-array {abstract!r} with {spec!r}")
        return _SCALAR
    entries = list(spec) if spec is not None else []
    entries = entries[: len(abstract.shape)]
    entries += [None] * (len(abstract.shape) - len(entries))
    used: set[str] = set()
    out: list[Entry] = []
    for dim, e in zip(abstract.shape, entries):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        axes = tuple(a for a in axes if a in mesh_axes and a not in used)
        total = int(np.prod([mesh_axes[a] for a in axes])) if axes else 1
        if axes and dim % total == 0:
            out.append(axes)
            used.update(axes)
        else:
            out.append(())
    return tuple(out)


def _is_partition_like_empty(spec: Any) -> bool:
    try:
        return len(tuple(spec)) == 0
    except TypeError:
        return False


def spec_to_partition(spec: Any) -> tuple:
    """Internal spec → the port's partition value: one entry per dim (``None``,
    an axis name, or a tuple of names), tuples of partitions for tuples."""
    if spec is _SCALAR:
        return ()
    if isinstance(spec, _TSpec):
        return tuple(spec_to_partition(e) for e in spec.elements)
    return tuple(None if e == () else (e[0] if len(e) == 1 else e) for e in spec)


def _shape_of(ab: AbstractValue) -> tuple[int, ...] | None:
    return ab.shape if isinstance(ab, AArray) else None


def local_shape(shape: Sequence[int], spec: Spec, mesh_axes: dict[str, int]) -> tuple:
    out = []
    for dim, axes in zip(shape, spec):
        total = int(np.prod([mesh_axes[a] for a in axes])) if axes else 1
        out.append(dim // total)
    return tuple(out)


# ---------------------------------------------------------------------------
# Per-primitive propagation rules
# ---------------------------------------------------------------------------


class _Res:
    """One rule decision: the node's output spec, the spec each argument
    must be *provided at* (None: leave untouched — statics, scalars), the
    collectives to append after the local computation, and static-constant
    rewrites (arg index → new value) that localize baked-in shapes."""

    __slots__ = ("out", "reqs", "post", "rewrites")

    def __init__(self, out, reqs, post=(), rewrites=None) -> None:
        self.out = out
        self.reqs = reqs
        self.post = tuple(post)  # sequence of ("psum" | "pmax", axes-tuple)
        self.rewrites = rewrites or {}


def _merge_elementwise(arg_specs, arg_shapes, out_shape):
    """NumPy-broadcast-aware merge: per output dim pick the first usable
    sharding among the size-matching operands; each mesh axis at most
    once.  Returns (out_spec, per-arg required spec)."""
    rank = len(out_shape)
    used: set[str] = set()
    out: list[Entry] = []
    for d in range(rank):
        chosen: Entry = ()
        for spec, shp in zip(arg_specs, arg_shapes):
            if spec is _SCALAR or shp is None:
                continue
            ad = len(shp) - (rank - d)
            if ad < 0 or shp[ad] != out_shape[d] or out_shape[d] == 1:
                continue
            e = spec[ad]
            if e and not (set(e) & used):
                chosen = e
                break
        out.append(chosen)
        used.update(chosen)
    reqs = []
    for spec, shp in zip(arg_specs, arg_shapes):
        if spec is _SCALAR or shp is None:
            reqs.append(None)
            continue
        req = []
        for ad in range(len(shp)):
            d = rank - len(shp) + ad
            req.append(out[d] if shp[ad] == out_shape[d] and shp[ad] != 1 else ())
        reqs.append(tuple(req))
    return tuple(out), reqs


def _const_value(node: Node) -> Any:
    if isinstance(node, Constant):
        return node.value
    raise SpmdError(f"expected a static constant, got {node!r}")


def _norm_axes(axes: Any, rank: int) -> tuple[int, ...]:
    if axes is None:
        return tuple(range(rank))
    if isinstance(axes, int):
        axes = (axes,)
    return tuple(a % rank for a in axes)


class _Rules:
    """Forward propagation rules.  ``self.spec_of`` resolves a node's
    current spec; each rule returns a :class:`_Res`."""

    def __init__(self, mesh_axes: dict[str, int], bspec: dict[int, Spec]) -> None:
        self.mesh_axes = mesh_axes
        self.bspec = bspec  # broadcast-node spec overrides (refinement)

    def apply(self, node: Apply, prim: P.Primitive, arg_specs, arg_abs, out_ab) -> _Res:
        name = prim.name
        if name in ELEMENTWISE or name in ("zeros_like", "stop_gradient", "sign"):
            return self._elementwise(node, arg_specs, arg_abs, out_ab)
        handler = getattr(self, f"_r_{name}", None)
        if handler is not None:
            return handler(node, arg_specs, arg_abs, out_ab)
        return self._default(node, arg_specs, arg_abs, out_ab)

    # -- generic ----------------------------------------------------------
    def _elementwise(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        out_shape = _shape_of(out_ab)
        if out_shape is None:  # scalar compute: replicated by construction
            return _Res(_SCALAR, [None] * len(arg_specs))
        shapes = [_shape_of(a) for a in arg_abs]
        out, reqs = _merge_elementwise(arg_specs, shapes, out_shape)
        return _Res(out, reqs)

    def _default(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        """Unknown primitive: compute fully replicated (gather every
        sharded operand) — always sound, never fast."""
        reqs = []
        for spec, ab in zip(arg_specs, arg_abs):
            if isinstance(spec, _TSpec) and not _is_replicated(spec):
                raise SpmdError(
                    f"cannot replicate sharded tuple operand of {node!r}"
                )
            reqs.append(
                tuple(() for _ in spec) if isinstance(spec, tuple) and spec is not _SCALAR
                else None
            )
        shape = _shape_of(out_ab)
        if shape is None and isinstance(out_ab, ATuple):
            out = _TSpec(tuple(
                _SCALAR if not isinstance(e, AArray) else tuple(() for _ in e.shape)
                for e in out_ab.elements
            ))
        elif shape is None:
            out = _SCALAR
        else:
            out = tuple(() for _ in shape)
        return _Res(out, reqs)

    # -- structure --------------------------------------------------------
    def _r_make_tuple(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        return _Res(_TSpec(tuple(arg_specs)), [None] * len(arg_specs))

    def _r_tuple_getitem(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        t = arg_specs[0]
        i = _const_value(node.args[1])
        if not isinstance(t, _TSpec):
            raise SpmdError(f"tuple_getitem on non-tuple spec {t!r}")
        return _Res(t.elements[i], [None, None])

    def _r_gadd(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        # gradient addition is elementwise on tuples (values.gadd_values);
        # identically-sharded operands add shard-locally
        a, b = arg_specs
        if isinstance(a, _TSpec) or isinstance(b, _TSpec):
            if a == b:
                return _Res(a, [None, None])
            raise SpmdError(f"gadd of differently-sharded tuples: {a!r} vs {b!r}")
        return self._elementwise(node, arg_specs, arg_abs, out_ab)

    def _r_tuple_setitem(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        # second-order adjoints update gradient tuples in place: the
        # result keeps every element's spec, with slot i taking the new
        # value's spec (no resharding required on any operand)
        t, _i, v = arg_specs
        i = _const_value(node.args[1])
        if not isinstance(t, _TSpec):
            raise SpmdError(f"tuple_setitem on non-tuple spec {t!r}")
        elts = list(t.elements)
        elts[i] = v
        return _Res(_TSpec(tuple(elts)), [None, None, None])

    # -- structured loops --------------------------------------------------
    def _loop(self, n_graphs: int, node, arg_specs, arg_abs, out_ab) -> _Res:
        """``while_loop`` / ``scan_loop``: the body is an opaque sub-graph
        to this per-node propagation, so the sound contraction is to run
        the whole loop replicated — sharded carries and extras are gathered
        at entry and the exit tuple (including any saved-carry stacks the
        adjoint threads) comes out replicated.  Per-shard loop bodies would
        need a carry-spec fixpoint through the step graph; until then this
        keeps loop-adjoint programs *eligible* for the SPMD tier (the rest
        of the graph still shards) instead of failing propagation."""
        reqs: list[Any] = []
        for i, spec in enumerate(arg_specs):
            if i < n_graphs or spec is _SCALAR:
                reqs.append(None)  # sub-graphs / static ints / scalar operands
            elif isinstance(spec, _TSpec):
                if not _is_replicated(spec):
                    raise SpmdError(
                        f"cannot gather sharded tuple carry of {node!r}"
                    )
                reqs.append(None)
            else:
                reqs.append(tuple(() for _ in spec))
        if isinstance(out_ab, ATuple):
            out: Any = _TSpec(tuple(
                _SCALAR if not isinstance(e, AArray) else tuple(() for _ in e.shape)
                for e in out_ab.elements
            ))
        else:
            shape = _shape_of(out_ab)
            out = _SCALAR if shape is None else tuple(() for _ in shape)
        return _Res(out, reqs)

    def _r_while_loop(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        return self._loop(3, node, arg_specs, arg_abs, out_ab)

    def _r_scan_loop(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        return self._loop(2, node, arg_specs, arg_abs, out_ab)

    # -- linear algebra ---------------------------------------------------
    def _r_matmul(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        la, ra = arg_abs
        ls, rs = _shape_of(la), _shape_of(ra)
        out_shape = _shape_of(out_ab)
        if ls is None or rs is None or len(ls) < 2 or len(rs) < 2 or out_shape is None:
            return self._default(node, arg_specs, arg_abs, out_ab)
        lspec = list(arg_specs[0]) if arg_specs[0] is not _SCALAR else [()] * len(ls)
        rspec = list(arg_specs[1]) if arg_specs[1] is not _SCALAR else [()] * len(rs)
        lreq, rreq = list(lspec), list(rspec)
        cl, cr = lspec[-1], rspec[-2]
        post = []
        if cl and cl == cr:
            post.append(("psum", cl))  # tensor-parallel contraction
        else:
            if cl:
                lreq[-1] = ()  # gather lhs on k
            if cr:
                rreq[-2] = ()  # gather rhs on k
        # batch dims: both operands execute the SAME local batch block, so
        # a broadcastable batch dim merges like elementwise (size-1 dims
        # broadcast locally; matching dims must be co-sharded)
        rank = len(out_shape)
        used: set[str] = set(post[0][1]) if post else set()
        out: list[Entry] = []
        for d in range(rank - 2):
            chosen: Entry = ()
            for spec, shp in ((lspec, ls), (rspec, rs)):
                ad = len(shp) - 2 - (rank - 2 - d)
                if ad < 0 or shp[ad] != out_shape[d] or out_shape[d] == 1:
                    continue
                e = tuple(spec[ad])
                if e and not (set(e) & used):
                    chosen = e
                    break
            out.append(chosen)
            used.update(chosen)
            for spec, req, shp in ((lspec, lreq, ls), (rspec, rreq, rs)):
                ad = len(shp) - 2 - (rank - 2 - d)
                if ad >= 0:
                    req[ad] = (
                        chosen if (shp[ad] == out_shape[d] and shp[ad] != 1) else ()
                    )
        # m from lhs, n from rhs
        for spec, req, idx in (
            (lspec, lreq, len(ls) - 2),
            (rspec, rreq, len(rs) - 1),
        ):
            e = spec[idx]
            if e and not (set(e) & used):
                out.append(e)
                used.update(e)
            else:
                if e:
                    req[idx] = ()
                out.append(())
        return _Res(tuple(out), [tuple(lreq), tuple(rreq)], post)

    def _r_mT(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        s = arg_specs[0]
        if s is _SCALAR or len(s) < 2:
            return self._default(node, arg_specs, arg_abs, out_ab)
        out = tuple(s[:-2]) + (s[-1], s[-2])
        return _Res(out, [tuple(s)])

    def _r_transpose(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        s = arg_specs[0]
        perm = _const_value(node.args[1])
        if s is _SCALAR:
            return self._default(node, arg_specs, arg_abs, out_ab)
        return _Res(tuple(s[p] for p in perm), [tuple(s), None])

    def _r_reshape(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        # conservative: reshape runs on the replicated (global) value
        s = arg_specs[0]
        req = tuple(() for _ in s) if s is not _SCALAR else None
        shape = _shape_of(out_ab)
        out = tuple(() for _ in shape) if shape is not None else _SCALAR
        return _Res(out, [req, None])

    # -- reductions -------------------------------------------------------
    def _reduce(self, kind, node, arg_specs, arg_abs, out_ab) -> _Res:
        x_ab = arg_abs[0]
        xs = _shape_of(x_ab)
        spec = arg_specs[0]
        if xs is None or spec is _SCALAR:
            return self._default(node, arg_specs, arg_abs, out_ab)
        axes = _norm_axes(_const_value(node.args[1]), len(xs))
        keepdims = bool(_const_value(node.args[2]))
        comm: list[str] = []
        out: list[Entry] = []
        for d, e in enumerate(spec):
            if d in axes:
                comm.extend(e)
                if keepdims:
                    out.append(())
            else:
                out.append(e)
        out_spec: Any = tuple(out) if _shape_of(out_ab) is not None else _SCALAR
        post = [(kind, tuple(comm))] if comm else []
        return _Res(out_spec, [tuple(spec), None, None], post)

    def _r_reduce_sum(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        return self._reduce("psum", node, arg_specs, arg_abs, out_ab)

    def _r_reduce_max(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        return self._reduce("pmax", node, arg_specs, arg_abs, out_ab)

    def _r_unbroadcast(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        xs = _shape_of(arg_abs[0])
        spec = arg_specs[0]
        out_shape = _shape_of(out_ab)
        if xs is None or spec is _SCALAR or out_shape is None:
            return self._default(node, arg_specs, arg_abs, out_ab)
        ndiff = len(xs) - len(out_shape)
        comm: list[str] = []
        out: list[Entry] = []
        for d, e in enumerate(spec):
            if d < ndiff:
                comm.extend(e)  # summed-away leading dim
            elif out_shape[d - ndiff] == 1 and xs[d] != 1:
                comm.extend(e)  # keepdims-style sum
                out.append(())
            else:
                out.append(e)
        post = [("psum", tuple(comm))] if comm else []
        rewrites = {1: local_shape(out_shape, tuple(out), self.mesh_axes)}
        return _Res(tuple(out), [tuple(spec), None], post, rewrites)

    # -- broadcasts (refinable) -------------------------------------------
    def _r_broadcast_to(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        xs = _shape_of(arg_abs[0])
        out_shape = _shape_of(out_ab)
        if out_shape is None:
            return self._default(node, arg_specs, arg_abs, out_ab)
        spec = arg_specs[0]
        if spec is _SCALAR:
            xs, spec = (), ()
        # right-aligned dim map: out dim -> x dim (retained) or expanded
        mapping: dict[int, int] = {}
        expanded: set[int] = set()
        for d in range(len(out_shape)):
            ad = len(xs) - (len(out_shape) - d)
            if ad >= 0 and xs[ad] == out_shape[d] and out_shape[d] != 1:
                mapping[d] = ad
            else:
                expanded.add(d)
        out = self._broadcast_refined(node, spec, mapping, expanded, out_shape)
        x_req = None
        if xs:
            # x dims not in the mapping are size-1: those broadcast locally
            inv = {ad: d for d, ad in mapping.items()}
            x_req = tuple(out[inv[ad]] if ad in inv else () for ad in range(len(xs)))
        rewrites = {1: local_shape(out_shape, out, self.mesh_axes)}
        return _Res(out, [x_req, None], (), rewrites)

    def _r_unreduce(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        xs = _shape_of(arg_abs[0])
        out_shape = _shape_of(out_ab)
        if out_shape is None:
            return self._default(node, arg_specs, arg_abs, out_ab)
        spec = arg_specs[0]
        axes = _norm_axes(_const_value(node.args[2]), len(out_shape))
        keepdims = bool(_const_value(node.args[3]))
        mapping: dict[int, int] = {}
        expanded: set[int] = set(axes)
        if keepdims:
            for d in range(len(out_shape)):
                if d not in expanded:
                    mapping[d] = d
                elif xs is not None and xs[d] == out_shape[d]:
                    # size already matched: no expansion happened
                    mapping[d] = d
                    expanded.discard(d)
        else:
            ad = 0
            for d in range(len(out_shape)):
                if d not in expanded:
                    mapping[d] = ad
                    ad += 1
        if spec is _SCALAR:
            xs, spec = (), ()
            mapping = {}
            expanded = set(range(len(out_shape)))
        out = self._broadcast_refined(node, spec, mapping, expanded, out_shape)
        x_req = None
        if xs:
            inv = {ad: d for d, ad in mapping.items()}
            x_req = tuple(
                out[inv[ad]] if ad in inv else () for ad in range(len(xs))
            )
        rewrites = {1: local_shape(out_shape, out, self.mesh_axes)}
        return _Res(out, [x_req, None, None, None], (), rewrites)

    def _broadcast_refined(self, node, x_spec, mapping, expanded, out_shape) -> Spec:
        override = self.bspec.get(node._id)
        out: list[Entry] = []
        used: set[str] = set()
        for d in range(len(out_shape)):
            if d in mapping:
                e = x_spec[mapping[d]] if x_spec else ()
            else:
                e = override[d] if override is not None and d < len(override) else ()
            total = int(np.prod([self.mesh_axes[a] for a in e])) if e else 1
            if e and out_shape[d] != 1 and out_shape[d] % total == 0 and not (set(e) & used):
                out.append(tuple(e))
                used.update(e)
            else:
                out.append(())
        return tuple(out)

    # -- gather / scatter --------------------------------------------------
    def _r_take(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        xs, is_ = _shape_of(arg_abs[0]), _shape_of(arg_abs[1])
        out_shape = _shape_of(out_ab)
        if xs is None or out_shape is None:
            return self._default(node, arg_specs, arg_abs, out_ab)
        x_spec = list(arg_specs[0]) if arg_specs[0] is not _SCALAR else [()] * len(xs)
        i_spec = (
            list(arg_specs[1])
            if arg_specs[1] is not _SCALAR and is_ is not None
            else []
        )
        x_req = list(x_spec)
        x_req[0] = ()  # the table's indexed dim must be whole on each shard
        out: list[Entry] = []
        used: set[str] = set()
        for e in i_spec:
            out.append(e if not (set(e) & used) else ())
            used.update(e)
        for ad in range(1, len(xs)):
            e = x_spec[ad]
            if e and not (set(e) & used):
                out.append(e)
                used.update(e)
            else:
                if e:
                    x_req[ad] = ()
                out.append(())
        i_req = tuple(i_spec) if i_spec else None
        return _Res(tuple(out), [tuple(x_req), i_req])

    def _r_one_hot(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        is_ = _shape_of(arg_abs[0])
        out_shape = _shape_of(out_ab)
        if is_ is None or out_shape is None:
            return self._default(node, arg_specs, arg_abs, out_ab)
        i_spec = arg_specs[0] if arg_specs[0] is not _SCALAR else tuple(() for _ in is_)
        out = tuple(i_spec) + ((),)
        return _Res(out, [tuple(i_spec), None, None])

    def _r_index_add(self, node, arg_specs, arg_abs, out_ab) -> _Res:
        bs, is_, vs = (_shape_of(a) for a in arg_abs)
        if bs is None or vs is None:
            return self._default(node, arg_specs, arg_abs, out_ab)
        i_spec = (
            tuple(arg_specs[1])
            if arg_specs[1] is not _SCALAR and is_ is not None
            else ()
        )
        i_rank = len(is_) if is_ is not None else 0
        base_req = tuple(() for _ in bs)  # scatter target replicated
        # updates: indexed dims follow idx's sharding, payload dims replicated
        v_req = tuple(i_spec) + tuple(() for _ in range(len(vs) - i_rank))
        comm = tuple(a for e in i_spec for a in e)
        post = [("psum", comm)] if comm else []
        return _Res(base_req, [base_req, i_spec or None, v_req], post)


# ---------------------------------------------------------------------------
# The propagation pass
# ---------------------------------------------------------------------------


class SpmdPlan:
    """Result of :func:`propagate`: node spec table + accounting."""

    __slots__ = ("graph", "mesh_axes", "in_specs", "spec", "post", "out_spec", "stats")

    def __init__(self, graph, mesh_axes, in_specs, spec, post, out_spec, stats) -> None:
        self.graph = graph
        self.mesh_axes = dict(mesh_axes)
        self.in_specs = in_specs
        self.spec = spec  # node id -> Spec | _TSpec | _SCALAR
        self.post = post  # node id -> tuple of ("psum"|"pmax", axes)
        self.out_spec = out_spec
        self.stats = stats

    def spec_of(self, node: Node) -> Any:
        got = self.spec.get(node._id)
        if got is not None:
            return got
        return _spec_of_leaf(node)


def _spec_of_leaf(node: Node) -> Any:
    """Spec of a node outside the spec table: constants are replicated."""
    if isinstance(node, Constant):
        ab = node.abstract
        shp = _shape_of(ab) if ab is not None else None
        if shp is None:
            try:
                shp = tuple(int(d) for d in np.shape(node.value))
            except Exception:
                return _SCALAR
            if shp == () and not hasattr(node.value, "shape"):
                return _SCALAR
        return tuple(() for _ in shp)
    raise SpmdError(f"no spec for {node!r}")


def _check_shardable(graph: Graph) -> list[Apply]:
    blockers = lowering_blockers(graph)
    if blockers:
        raise SpmdError("graph is not first-order straight-line: " + "; ".join(blockers))
    topo = [n for n in toposort(graph) if isinstance(n, Apply)]
    for n in topo:
        if n.abstract is None:
            raise SpmdError(f"node {n!r} has no inferred abstract (run infer first)")
    return topo


def propagate(
    graph: Graph,
    in_specs: Sequence[Any],
    mesh_axes: dict[str, int],
    *,
    max_refine: int = 4,
) -> SpmdPlan:
    """Assign a sharding spec to every node of ``graph``.

    Forward abstract-interpretation over the inferred abstracts with a
    bounded backward-refinement loop for broadcast-family nodes: an
    expanded dim adopts the merged sharding of its consumers (each shard
    then materializes only its slice of the broadcast — no communication).
    """
    topo = _check_shardable(graph)
    if len(in_specs) != len(graph.parameters):
        raise SpmdError(
            f"{graph.name} has {len(graph.parameters)} parameters, "
            f"got {len(in_specs)} in_specs"
        )
    params_norm = [
        normalize_spec(s, p.abstract, mesh_axes)
        for s, p in zip(in_specs, graph.parameters)
    ]
    live = {n._id for n in topo}

    bspec: dict[int, Spec] = {}
    spec: dict[int, Any] = {}
    post: dict[int, tuple] = {}
    for _ in range(max_refine):
        rules = _Rules(mesh_axes, bspec)
        spec = {}
        post = {}
        for p, s in zip(graph.parameters, params_norm):
            spec[p._id] = s

        def spec_of(node: Node) -> Any:
            got = spec.get(node._id)
            return got if got is not None else _spec_of_leaf(node)

        results: dict[int, _Res] = {}
        for n in topo:
            prim = n.fn.value
            arg_specs = [spec_of(a) for a in n.args]
            arg_abs = [a.abstract for a in n.args]
            res = rules.apply(n, prim, arg_specs, arg_abs, n.abstract)
            results[n._id] = res
            spec[n._id] = res.out
            if res.post:
                post[n._id] = res.post
        # backward refinement: broadcast expanded dims adopt consumer specs
        new_bspec: dict[int, Spec] = {}
        for n in reversed(topo):
            prim = n.fn.value
            if prim.name not in BROADCAST:
                continue
            out_shape = _shape_of(n.abstract)
            if out_shape is None:
                continue
            users = [u for (u, _i) in n.users if u._id in live]
            desired: list[Entry] = [()] * len(out_shape)
            for u in users:
                req = _user_demand(results.get(u._id), u, n, len(out_shape))
                if req is None:
                    continue
                for d, e in enumerate(req):
                    if e and not desired[d]:
                        desired[d] = tuple(e)
            if any(desired):
                new_bspec[n._id] = tuple(desired)
        if new_bspec == bspec:
            break
        bspec = new_bspec

    out_spec = (
        spec.get(graph.return_._id)
        if graph.return_._id in spec
        else _spec_of_leaf(graph.return_)
    )
    stats = _plan_stats(graph, topo, spec, post, params_norm)
    return SpmdPlan(graph, mesh_axes, params_norm, spec, post, out_spec, stats)


def _user_demand(res: _Res | None, user: Apply, node: Node, rank: int):
    """What spec does ``user`` require ``node`` at (from the recorded rule
    decision)?  None if unknown / not an array requirement."""
    if res is None:
        return None
    for a, req in zip(user.args, res.reqs):
        if a is node and isinstance(req, tuple) and len(req) == rank:
            return req
    return None


def _plan_stats(graph, topo, spec, post, params_norm) -> dict:
    n_sharded = sum(
        1
        for n in topo
        if isinstance(spec.get(n._id), tuple)
        and spec[n._id] is not _SCALAR
        and not _is_replicated(spec[n._id])
    )
    n_psum = sum(1 for ps in post.values() for k, _ in ps if k == "psum")
    n_pmax = sum(1 for ps in post.values() for k, _ in ps if k == "pmax")
    return {
        "params_sharded": sum(1 for s in params_norm if not _is_replicated(s)),
        "nodes": len(topo),
        "nodes_sharded": n_sharded,
        "n_psum": n_psum,
        "n_pmax": n_pmax,
    }


# ---------------------------------------------------------------------------
# The transform: global graph -> per-shard program
# ---------------------------------------------------------------------------


class ShardedGraph:
    """Everything ``compile_graph_spmd`` needs: the per-shard graph (with
    collectives inserted and shape constants localized, re-inferred at
    local shapes), the partitions of the inputs and outputs, and the plan."""

    __slots__ = ("graph", "in_partition", "out_partition", "local_abstracts", "plan", "stats")

    def __init__(self, graph, in_partition, out_partition, local_abstracts, plan, stats):
        self.graph = graph
        self.in_partition = in_partition
        self.out_partition = out_partition
        self.local_abstracts = local_abstracts
        self.plan = plan
        self.stats = stats


def shard_graph(
    graph: Graph, in_specs: Sequence[Any], mesh_axes: dict[str, int]
) -> ShardedGraph:
    """Build the per-shard program for ``graph`` under ``in_specs``.

    The transform is a straight-line rebuild: every apply re-emitted with
    its operands *provided at* the spec the rule demands (``all_gather``
    to replicate, ``shard_slice`` to re-partition — memoized per
    (node, spec)), collectives appended at cross-shard reduction points,
    and shape-carrying constants rewritten to local shapes.  The clone is
    re-inferred at the local parameter shapes so fusion/codegen block for
    per-shard arrays.
    """
    plan = propagate(graph, in_specs, mesh_axes)
    topo = [n for n in toposort(graph) if isinstance(n, Apply)]
    rules = _Rules(mesh_axes, _bspec_from_plan(plan, topo))

    g2 = Graph(graph.name + "_spmd")
    mapped: dict[int, Node] = {}
    provided: dict[tuple, Node] = {}
    counts = {"all_gather": 0, "shard_slice": 0, "psum": 0, "pmax": 0}

    local_abstracts = []
    for p, s in zip(graph.parameters, plan.in_specs):
        np_ = g2.add_parameter(p.debug_name)
        mapped[p._id] = np_
        ab = p.abstract
        if not isinstance(ab, AArray):
            raise SpmdError(f"spmd tier requires array parameters, got {ab!r}")
        local_abstracts.append(AArray(ab.dtype, local_shape(ab.shape, s, mesh_axes)))

    def mapc(node: Node) -> Node:
        got = mapped.get(node._id)
        if got is not None:
            return got
        if isinstance(node, Constant):
            new = Constant(node.value, node.debug_name)
            mapped[node._id] = new
            return new
        raise SpmdError(f"unmapped node {node!r}")

    def provide(node: Node, req: Spec | None) -> Node:
        cur = plan.spec_of(node)
        new = mapc(node)
        if req is None or cur is _SCALAR or isinstance(cur, _TSpec) or tuple(cur) == tuple(req):
            return new
        key = (node._id, tuple(req))
        hit = provided.get(key)
        if hit is not None:
            return hit
        ab = node.abstract
        shape = _shape_of(ab)
        if shape is None:
            raise SpmdError(f"cannot reshard non-array {node!r}")
        out = new
        # ALL gathers before ANY slice: shard_slice reads axis_index, and
        # slicing dim i by an axis that still shards dim j of the SAME
        # value would pick this device's i-block of a j-shard — gather and
        # slice do not commute across dims sharing a mesh axis
        for d in range(len(shape)):
            have, want = tuple(cur[d]), tuple(req[d])
            if have and have != want:
                sizes = tuple(mesh_axes[a] for a in have)
                out = g2.apply(P.all_gather_axes, out, have, d, sizes)
                counts["all_gather"] += 1
        for d in range(len(shape)):
            have, want = tuple(cur[d]), tuple(req[d])
            if want and have != want:
                sizes = tuple(mesh_axes[a] for a in want)
                out = g2.apply(P.shard_slice, out, want, d, sizes)
                counts["shard_slice"] += 1
        provided[key] = out
        return out

    for n in topo:
        prim = n.fn.value
        arg_specs = [plan.spec_of(a) for a in n.args]
        arg_abs = [a.abstract for a in n.args]
        res = rules.apply(n, prim, arg_specs, arg_abs, n.abstract)
        new_args: list[Node] = []
        for i, a in enumerate(n.args):
            if i in res.rewrites:
                new_args.append(Constant(tuple(res.rewrites[i])))
                continue
            req = res.reqs[i] if i < len(res.reqs) else None
            new_args.append(provide(a, req if isinstance(req, tuple) else None))
        if prim.name == "index_add" and res.post:
            # base + psum(scatter-of-local-contributions): scatter into
            # zeros, sum partials across shards, then add the base once
            zeros = g2.apply(P.zeros_like, new_args[0])
            scat = g2.apply(P.index_add, zeros, new_args[1], new_args[2])
            for kind, axes in res.post:
                scat = g2.apply(P.psum_axes, scat, tuple(axes))
                counts["psum"] += 1
            out = g2.apply(P.add, new_args[0], scat)
        else:
            out = g2.apply(n.fn.value, *new_args, debug_name=n.debug_name)
            for kind, axes in res.post:
                prim_c = P.psum_axes if kind == "psum" else P.pmax_axes
                out = g2.apply(prim_c, out, tuple(axes))
                counts[kind] += 1
        mapped[n._id] = out

    ret = graph.return_
    g2.set_return(mapc(ret) if not isinstance(ret, Apply) else mapped[ret._id])

    try:
        infer(g2, *local_abstracts)
    except Exception as e:  # pragma: no cover - transform bug guard
        raise SpmdError(f"local re-inference failed: {e}") from e

    stats = dict(plan.stats)
    stats.update(counts)
    return ShardedGraph(
        g2,
        tuple(spec_to_partition(s) for s in plan.in_specs),
        _out_partition(plan.out_spec),
        tuple(local_abstracts),
        plan,
        stats,
    )


def _bspec_from_plan(plan: SpmdPlan, topo: list[Apply]) -> dict[int, Spec]:
    """Recover the broadcast overrides the plan settled on, so the build
    pass reproduces exactly the propagation's decisions."""
    out: dict[int, Spec] = {}
    for n in topo:
        if n.fn.value.name in BROADCAST and n._id in plan.spec:
            s = plan.spec[n._id]
            if isinstance(s, tuple) and s is not _SCALAR:
                out[n._id] = s
    return out


def _out_partition(out_spec: Any):
    if isinstance(out_spec, _TSpec):
        return tuple(_out_partition(e) for e in out_spec.elements)
    return spec_to_partition(out_spec)


