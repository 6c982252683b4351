"""Fusion: partition optimized graphs into kernel-sized regions (paper §4).

The direct lowering emits *one torch call per apply node*: one kernel
launch, and one trip through device memory, each.  The paper's closing
argument — ST adjoints become
"amenable to ahead-of-time optimization", and Myia's intended use is
exposing "efficient low-level kernels … as primitives" — asks the
*compiler* to own that decision.  This module is the analysis half of the
fusion subsystem: it walks an optimized, shape-inferred first-order graph
and groups apply nodes into **clusters**, each of which the code generator
(``repro_torch.kernels.codegen``) can emit as one generated Triton kernel.

Classification (shape information comes from ``infer``'s ``node.abstract``
annotations):

* **elementwise** — add/mul/tanh/… applied at the cluster's body shape;
  computed per block inside the kernel,
* **broadcast**  — ``unreduce`` / ``broadcast_to`` *into* the body shape;
  legal only at the cluster boundary (their input is by construction
  smaller than the body shape, so they prepare kernel operands),
* **reduction**  — ``reduce_sum`` / ``reduce_max`` / ``unbroadcast``;
  legal only as a cluster's *root* (the single output),
* **opaque**     — everything else (matmul, reshape, tuple machinery,
  registered kernel primitives, …): never fused, always a cluster
  boundary.

Cluster legality (checked during greedy growth, so every produced cluster
is legal by construction):

1. **single output** — only the root's value may be consumed outside the
   cluster: an interior node is absorbed only if *every* user edge points
   at a node already in the cluster (and it is not the graph's return
   node).  Because all paths out of the region then go through the root,
   absorbing a producer can never create a cycle between clusters — a
   cluster input that depended on the root (or on any interior node)
   would imply a cycle in the original DAG.
2. **dominated inputs** — every cluster input is an ancestor of the root,
   so the fused call can be emitted exactly where the root stood in the
   topological order.
3. **shape/dtype compatibility** — every member's output shape equals the
   cluster body shape (elementwise per block); broadcast members' static
   arguments (target shape / axes / keepdims) must be constants; a
   reduction root's axes/keepdims (or target shape) must be constants.

Growth is greedy and maximal: roots are attempted in reverse topological
order (consumers first), so a cluster reaches as far up its operand tree
as legality allows.  Clusters smaller than ``min_cluster_size`` are
discarded — a generated kernel for one or two elementwise ops saves too
little to be worth its launch — and their nodes remain available as roots for
later (smaller) attempts.
"""

from __future__ import annotations

from typing import Any

from .infer import AArray
from .ir import Apply, Constant, Graph, Node, is_constant_graph, toposort
from .primitives import COLLECTIVE_NAMES as COLLECTIVES, Primitive

__all__ = [
    "ELEMENTWISE",
    "BROADCAST",
    "REDUCTION",
    "COLLECTIVES",
    "DeclineReason",
    "classify",
    "Cluster",
    "FusionPlan",
    "explain_partition",
    "partition_graph",
]

#: primitive names computed pointwise at the body shape
ELEMENTWISE = frozenset({
    "add", "sub", "mul", "div", "power", "integer_pow", "neg",
    "exp", "log", "tanh", "sigmoid", "relu", "sqrt", "rsqrt",
    "sin", "cos", "square", "absolute", "sign", "erf",
    "maximum", "minimum", "where", "cast",
    "lt", "gt", "le", "ge", "eq", "ne",
    "bool_and", "bool_or", "bool_not",
})

#: primitives that broadcast a smaller operand INTO the body shape
BROADCAST = frozenset({"broadcast_to", "unreduce"})

#: primitives that reduce the body shape DOWN to the output shape
REDUCTION = frozenset({"reduce_sum", "reduce_max", "unbroadcast"})


class DeclineReason:
    """Why a node stayed out of every fusion cluster (or a whole cluster
    was declined by codegen): a machine-readable kind + human detail.

    Mirrors :class:`repro_torch.core.closure.FallbackReason` — the explain layer
    (``repro_torch.obs.explain``) reports these as structured reason *objects*,
    never bare strings, so downstream tooling can pivot on ``kind``."""

    #: non-primitive call / no array abstract: nothing to fuse
    NOT_ARRAY = "no-array-abstract"
    #: an SPMD collective: a cluster must never span a resharding point
    COLLECTIVE = "collective-boundary"
    #: an opaque primitive (matmul, reshape, tuple machinery, …)
    OPAQUE = "opaque-primitive"
    #: broadcast/reduction static config (shape/axes) is not constant
    NON_CONST_STATIC = "non-constant-static-args"
    #: the legal region around this node is under min_cluster_size
    TOO_SMALL = "region-too-small"
    #: an interior value is consumed outside the region (2nd output needed)
    ESCAPES = "value-escapes-region"
    #: rank-0 / empty body: no kernel to win
    EMPTY_BODY = "empty-or-scalar-body"
    #: a neighboring cluster (grown from a later consumer) claimed the region
    CLAIMED = "claimed-by-neighbor"
    #: the partitioner clustered it but codegen could not express it
    CODEGEN = "codegen-declined"

    __slots__ = ("kind", "detail")

    def __init__(self, kind: str, detail: str) -> None:
        self.kind = kind
        self.detail = detail

    def __str__(self) -> str:
        return f"[{self.kind}] {self.detail}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DeclineReason({self.kind!r}, {self.detail!r})"

    def as_dict(self) -> dict:
        return {"kind": self.kind, "detail": self.detail}


def _prim_of(node: Node) -> Primitive | None:
    if not isinstance(node, Apply):
        return None
    fn = node.fn
    if isinstance(fn, Constant) and isinstance(fn.value, Primitive):
        return fn.value
    return None


def _shape_of(node: Node) -> tuple[int, ...] | None:
    """Array shape from the inferred abstract; None if not an array (or
    the inferencer never annotated the node)."""
    ab = node.abstract
    if isinstance(ab, AArray):
        return ab.shape
    return None


def _dtype_of(node: Node) -> Any:
    ab = node.abstract
    return ab.dtype if isinstance(ab, AArray) else None


def classify(node: Node) -> str:
    """One of ``"elementwise" | "broadcast" | "reduction" | "opaque"``.

    Classification is *shape-aware*: an elementwise primitive only counts
    as such when the node actually produced an array (scalar arithmetic on
    loop counters stays opaque), and broadcast/reduction require their
    static arguments (shape / axes / keepdims) to be constants.

    SPMD collectives (``psum_axes`` & co., inserted by ``repro_torch.core.spmd``
    at resharding points) are opaque *by fiat*, not by omission: a fusion
    cluster must never span a resharding point — the values on either
    side live at different shardings, so a single kernel body cannot
    compute across one.
    """
    p = _prim_of(node)
    if p is not None and p.name in COLLECTIVES:
        return "opaque"
    if p is None or _shape_of(node) is None and p.name not in REDUCTION:
        return "opaque"
    if p.name in ELEMENTWISE:
        return "elementwise"
    if p.name in BROADCAST:
        return "broadcast" if _static_args_const(node) else "opaque"
    if p.name in REDUCTION:
        return "reduction" if _static_args_const(node) else "opaque"
    return "opaque"


def _static_args_const(node: Apply) -> bool:
    """broadcast/reduction prims carry static config after the data arg:
    ``broadcast_to(x, shp)``, ``unreduce(x, shp, axes, keepdims)``,
    ``reduce_sum(x, axes, keepdims)``, ``unbroadcast(x, shp)`` — all of it
    must be constant for codegen to bake it into the kernel."""
    return all(isinstance(a, Constant) for a in node.args[1:])


class Cluster:
    """A legal fusion region: ``order`` (members, producers first) feeding
    the single-output ``root``; ``inputs`` are the external value edges in
    first-use order (constants excluded — codegen embeds those)."""

    __slots__ = ("root", "members", "order", "inputs", "kind", "body_shape")

    def __init__(
        self,
        root: Apply,
        order: list[Apply],
        inputs: list[Node],
        kind: str,
        body_shape: tuple[int, ...],
    ) -> None:
        self.root = root
        self.members = {n._id for n in order}
        self.order = order
        self.inputs = inputs
        self.kind = kind  # "map" (elementwise root) | "reduce" (reduction root)
        self.body_shape = body_shape

    @property
    def out_shape(self) -> tuple[int, ...]:
        return _shape_of(self.root) or ()

    @property
    def out_dtype(self):
        return _dtype_of(self.root)

    def __len__(self) -> int:
        return len(self.order)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        prims = "+".join(n.fn.value.name for n in self.order)
        return f"<Cluster {self.kind} {list(self.body_shape)} {prims}>"


class FusionPlan:
    """All clusters of one graph + the launch accounting the benchmarks
    report (``launches_before``: apply nodes in the unfused lowering;
    ``launches_after``: unfused applies + one call per cluster)."""

    __slots__ = ("graph", "clusters", "n_applies")

    def __init__(self, graph: Graph, clusters: list[Cluster], n_applies: int) -> None:
        self.graph = graph
        self.clusters = clusters
        self.n_applies = n_applies

    def cluster_of(self, node: Node) -> Cluster | None:
        for c in self.clusters:
            if node._id in c.members:
                return c
        return None

    @property
    def fused_nodes(self) -> int:
        return sum(len(c) for c in self.clusters)

    @property
    def launches_before(self) -> int:
        return self.n_applies

    @property
    def launches_after(self) -> int:
        return self.n_applies - self.fused_nodes + len(self.clusters)

    @property
    def nodes_per_cluster(self) -> float:
        return self.fused_nodes / len(self.clusters) if self.clusters else 0.0

    def stats(self) -> dict:
        return {
            "n_clusters": len(self.clusters),
            "fused_nodes": self.fused_nodes,
            "launches_before": self.launches_before,
            "launches_after": self.launches_after,
            "nodes_per_cluster": round(self.nodes_per_cluster, 2),
            "cluster_sizes": sorted((len(c) for c in self.clusters), reverse=True),
        }


def _grow(
    graph: Graph, root: Apply, assigned: set[int], live: set[int]
) -> list[Apply] | None:
    """Greedy maximal growth from ``root``; returns members in discovery
    order (consumers first) or None if the root itself is ineligible."""
    kind = classify(root)
    if kind == "reduction":
        body = root.args[0]
        body_shape = _shape_of(body)
        if body_shape is None:
            return None
    elif kind in ("elementwise", "broadcast"):
        body_shape = _shape_of(root)
    else:
        return None
    if not body_shape or any(d <= 0 for d in body_shape):
        return None  # rank-0 / empty bodies: no kernel to win (codegen declines)

    members: set[int] = {root._id}
    order = [root]
    # broadcast members are boundaries: their (smaller) data input is a
    # kernel operand prepared by the wrapper, so growth stops behind them
    work = list(root.args[:1]) if kind == "reduction" else (
        [] if kind == "broadcast" else list(root.args)
    )
    while work:
        p = work.pop()
        if not isinstance(p, Apply) or p._id in members or p._id in assigned:
            continue
        if p is graph.return_:
            continue  # the return value must stay materialized
        cls = classify(p)
        if cls not in ("elementwise", "broadcast"):
            continue  # reductions are root-only; opaque never fuses
        if _shape_of(p) != body_shape:
            continue  # operand at another shape: stays a cluster input
        # single-output check over LIVE users only: the optimizer's rewrites
        # can leave stale user edges from orphaned (unreachable) nodes, and
        # those must not pin a value as "escaping"
        if not all(u._id in members for (u, _i) in p.users if u._id in live):
            continue  # value escapes the region: fusing would need a 2nd output
        members.add(p._id)
        order.append(p)
        if cls == "elementwise":
            work.extend(p.args)
    return order


def _collect_inputs(order: list[Apply], members: set[int]) -> list[Node]:
    seen: set[int] = set()
    inputs: list[Node] = []
    for n in order:  # producers first: stable, dominance-ordered
        for a in n.args:
            if a._id in members or a._id in seen:
                continue
            if isinstance(a, Constant) and not is_constant_graph(a):
                continue  # embedded by codegen (literal or closure-bound)
            seen.add(a._id)
            inputs.append(a)
    return inputs


def partition_graph(graph: Graph, *, min_cluster_size: int = 3) -> FusionPlan:
    """Partition ``graph`` (optimized + inferred, first-order) into fusion
    clusters.  Nodes without array abstracts, opaque primitives and
    too-small regions are simply left out — the lowering keeps emitting
    them as individual torch calls, so partitioning never fails.
    """
    from repro_torch.obs import trace as obs_trace

    sp = obs_trace.span("fuse.partition", graph=graph.name)
    with sp:
        plan = _partition_graph_body(graph, min_cluster_size)
        sp.set(n_applies=plan.n_applies, clusters=len(plan.clusters))
    return plan


def classify_reason(node: Node) -> DeclineReason | None:
    """The structured reason :func:`classify` returned ``"opaque"`` for
    ``node``, or None when the node is fusible (elementwise / broadcast /
    reduction)."""
    p = _prim_of(node)
    if p is None:
        return DeclineReason(
            DeclineReason.NOT_ARRAY, "callee is not a constant primitive"
        )
    if p.name in COLLECTIVES:
        return DeclineReason(
            DeclineReason.COLLECTIVE,
            f"{p.name} marks a resharding point; clusters never span one",
        )
    if _shape_of(node) is None and p.name not in REDUCTION:
        return DeclineReason(
            DeclineReason.NOT_ARRAY,
            f"{p.name} produced no array abstract (scalar or uninferred)",
        )
    if p.name in (BROADCAST | REDUCTION) and not _static_args_const(node):
        return DeclineReason(
            DeclineReason.NON_CONST_STATIC,
            f"{p.name} static config (shape/axes/keepdims) is not constant",
        )
    if classify(node) == "opaque":
        return DeclineReason(
            DeclineReason.OPAQUE, f"{p.name} has no elementwise kernel body"
        )
    return None


def explain_partition(
    graph: Graph, *, min_cluster_size: int = 3
) -> tuple[FusionPlan, dict[int, DeclineReason]]:
    """Partition ``graph`` AND explain every un-clustered apply node.

    Returns ``(plan, declines)`` where ``declines`` maps node ``_id`` →
    :class:`DeclineReason` for every apply the partitioner left out.  The
    reasons re-run the same legality checks the partitioner used, against
    the final assignment, so "too small" / "escapes" verdicts reflect the
    regions that actually formed."""
    plan = partition_graph(graph, min_cluster_size=min_cluster_size)
    assigned: set[int] = set()
    for c in plan.clusters:
        assigned |= c.members
    topo = [n for n in toposort(graph) if isinstance(n, Apply)]
    live = {n._id for n in topo}
    declines: dict[int, DeclineReason] = {}
    for node in topo:
        if node._id in assigned:
            continue
        reason = classify_reason(node)
        if reason is not None:
            declines[node._id] = reason
            continue
        # fusible class, yet unfused: replay growth against the final
        # assignment to see what held the region back
        grown = _grow(graph, node, assigned, live)
        if grown is None:
            declines[node._id] = DeclineReason(
                DeclineReason.EMPTY_BODY,
                "body shape is rank-0/empty; no kernel to win",
            )
        elif len(grown) < min_cluster_size:
            neighbors = any(
                u._id in assigned for (u, _i) in node.users if u._id in live
            ) or any(
                isinstance(a, Apply) and a._id in assigned for a in node.args
            )
            n_users = len({u._id for (u, _i) in node.users if u._id in live})
            if neighbors:
                declines[node._id] = DeclineReason(
                    DeclineReason.CLAIMED,
                    f"legal region is {len(grown)} node(s) < min "
                    f"{min_cluster_size}; adjacent values already belong to "
                    "an emitted cluster",
                )
            elif n_users > 1:
                declines[node._id] = DeclineReason(
                    DeclineReason.ESCAPES,
                    f"value feeds {n_users} consumers; absorbing it would "
                    "need a second cluster output",
                )
            else:
                declines[node._id] = DeclineReason(
                    DeclineReason.TOO_SMALL,
                    f"legal region is {len(grown)} node(s), below "
                    f"min_cluster_size={min_cluster_size}",
                )
        else:
            declines[node._id] = DeclineReason(
                DeclineReason.CLAIMED,
                f"a {len(grown)}-node region is legal here but its nodes "
                "were claimed by a cluster grown from a later consumer",
            )
    return plan, declines


def _partition_graph_body(graph: Graph, min_cluster_size: int) -> FusionPlan:
    topo = [n for n in toposort(graph) if isinstance(n, Apply)]
    topo_index = {n._id: i for i, n in enumerate(topo)}
    live = set(topo_index)
    assigned: set[int] = set()
    clusters: list[Cluster] = []
    for root in reversed(topo):  # consumers first → maximal regions
        if root._id in assigned:
            continue
        grown = _grow(graph, root, assigned, live)
        if grown is None or len(grown) < min_cluster_size:
            continue
        order = sorted(grown, key=lambda n: topo_index[n._id])  # producers first
        kind = "reduce" if classify(root) == "reduction" else "map"
        members = {n._id for n in order}
        body_shape = (
            _shape_of(root.args[0]) if kind == "reduce" else _shape_of(root)
        )
        clusters.append(
            Cluster(root, order, _collect_inputs(order, members), kind, body_shape)
        )
        assigned |= members
    clusters.sort(key=lambda c: topo_index[c.root._id])
    return FusionPlan(graph, clusters, len(topo))
