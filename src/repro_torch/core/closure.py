"""Closure elimination: call-graph analysis, defunctionalization, and
structured-recursion lowering (the "compile the closures" tier).

The paper's argument for a closure-supporting graph IR is that ST-based AD
needs no tape *and* its output is an ordinary program, amenable to
ahead-of-time optimization — including adjoints of adjoints and programs
with control flow.  Before this module, any graph that kept a residual
graph value after optimization (recursion from parsed loops, higher-order
calls the inliner could not resolve) silently fell back to the reference
VM.  This module closes most of that gap:

* :func:`analyze_blockers` — the structured version of
  ``lowering.lowering_blockers``: every reason a graph cannot lower is a
  :class:`FallbackReason` with a machine-readable ``kind``
  (``recursion-shape`` / ``higher-order-residual`` / ``free-variable`` /
  ``non-array-param`` / ``no-return``), surfaced through ``OptStats`` and
  the benchmark JSON so the CI fallback counter is debuggable.

* :func:`specialize_recursive_calls` — defunctionalization (Shaikhha et
  al.): a call of a *recursive* graph that passes a graph- or
  primitive-valued constant gets a per-constant specialized clone with
  that parameter bound.  The interior call sites become first-order, the
  inliner resolves them on the next wave, and the loop lowering below can
  then compile the recursion (``iterate(f, x, n)``-style programs).

* :func:`lower_loops` — structured-recursion lowering (Innes, *Don't
  Unroll Adjoint*): tail-recursive families in the canonical shape the
  parser emits (``header: switch(cond, body, exit)()``; ``body`` tail-calls
  the header, possibly through argument-carrying shims and nested
  switch diamonds) are rewritten into ``while_loop`` / ``scan_loop``
  primitive applies whose cond/step/exit are *closed first-order graphs*.
  The loop-invariant free variables — the closure environment of the loop
  family — are threaded as trailing arguments, and the carry is exactly
  the header's parameter list.  ``scan_loop`` (a counted host loop) is
  selected when the trip count is statically known (the fold-shaped
  ``for i in range(...)`` case); everything else becomes ``while_loop``
  (the reference lowers the two to ``jax.lax.scan`` / ``while_loop``).

Nested loops (the inner family tail-calls the outer header, so both
live in one SCC) lower by emitting the inner ``while_loop``/``scan_loop``
*inside* the outer step graph, and non-tail self-recursion in the
single-call affine shape (``x * f(x, n-1)``) lowers as a forward
trip-count loop plus a reversed accumulator loop.  What still genuinely
needs the VM: break-style conditional exits from a loop body, non-affine
or multi-call non-tail recursion, and closures selected by ``switch`` on
traced conditions.  ``docs/pipeline.md`` keeps the matrix.
"""

from __future__ import annotations

import math
from typing import Any

from . import primitives as P
from .infer import AArray, AScalar, ATuple, _widen
from .ir import (
    Apply,
    Constant,
    Graph,
    GraphCloner,
    Node,
    Parameter,
    dfs_nodes,
    free_variables,
    graph_and_descendants,
    is_apply,
    is_constant_graph,
)
from .primitives import LOOP_GRAPH_ARGS, Primitive

__all__ = [
    "FallbackReason",
    "analyze_blockers",
    "specialize_recursive_calls",
    "lower_loops",
    "LoopReport",
]


# ---------------------------------------------------------------------------
# Structured fallback reasons
# ---------------------------------------------------------------------------


class FallbackReason:
    """Why a graph stays on the VM: a machine-readable kind + detail."""

    #: the recursion is not in a shape the loop lowering recognizes
    RECURSION = "recursion-shape"
    #: a function value survived optimization (closure/higher-order call)
    HIGHER_ORDER = "higher-order-residual"
    #: a node owned by another graph (the graph is still nested)
    FREE_VARIABLE = "free-variable"
    #: a loop carry that is not an array/scalar value
    NON_ARRAY = "non-array-param"
    NO_RETURN = "no-return"

    __slots__ = ("kind", "detail")

    def __init__(self, kind: str, detail: str) -> None:
        self.kind = kind
        self.detail = detail

    def __str__(self) -> str:
        return f"[{self.kind}] {self.detail}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FallbackReason({self.kind!r}, {self.detail!r})"

    def as_dict(self) -> dict:
        return {"kind": self.kind, "detail": self.detail}


def _reaches_itself(g: Graph) -> bool:
    return any(is_constant_graph(n) and n.value is g for n in dfs_nodes(g.return_))


def _is_loop_graph_slot(user: Node, idx: int) -> bool:
    """True iff ``(user, idx)`` is a legal graph-valued slot: one of the
    leading sub-function arguments of a loop primitive apply."""
    if not isinstance(user, Apply):
        return False
    fn = user.fn
    if not (isinstance(fn, Constant) and isinstance(fn.value, Primitive)):
        return False
    n = LOOP_GRAPH_ARGS.get(fn.value.name)
    return n is not None and 1 <= idx <= n


def analyze_blockers(graph: Graph, _depth: int = 0) -> list[FallbackReason]:
    """Structured reasons ``graph`` cannot lower (empty list: lowerable).

    Mirrors what ``lowering.lower_graph`` can emit: straight-line applies
    of constant primitives over graph-owned nodes, plus loop primitive
    applies whose leading arguments are *closed, recursively lowerable*
    graphs.  De-duplicated (first occurrence wins)."""
    if graph.return_ is None:
        return [FallbackReason(FallbackReason.NO_RETURN, "graph has no return node")]
    if _depth > 8:
        return [
            FallbackReason(
                FallbackReason.RECURSION, f"loop nesting too deep below {graph.name!r}"
            )
        ]
    reasons: dict[str, FallbackReason] = {}

    def add(kind: str, detail: str) -> None:
        reasons.setdefault(f"{kind}:{detail}", FallbackReason(kind, detail))

    def classify_graph_value(g: Graph) -> None:
        if _reaches_itself(g):
            add(
                FallbackReason.RECURSION,
                f"graph-valued constant {g.name!r} survived optimization "
                "(residual recursion)",
            )
        else:
            add(
                FallbackReason.HIGHER_ORDER,
                f"graph-valued constant {g.name!r} survived optimization "
                "(closure value)",
            )

    seen: set[int] = set()
    stack: list[Node] = [graph.return_]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, Constant):
            if isinstance(node.value, Graph):
                if node.users and all(
                    _is_loop_graph_slot(u, i) for u, i in node.users
                ):
                    # loop sub-function: must itself be closed + lowerable
                    for sub in analyze_blockers(node.value, _depth + 1):
                        add(sub.kind, f"in loop graph {node.value.name!r}: {sub.detail}")
                else:
                    classify_graph_value(node.value)
            continue
        if isinstance(node, Parameter):
            if node.graph is not graph:
                add(
                    FallbackReason.FREE_VARIABLE,
                    f"free parameter {node!r} of graph {node.graph and node.graph.name!r}",
                )
            continue
        assert isinstance(node, Apply)
        if node.graph is not graph:
            add(
                FallbackReason.FREE_VARIABLE,
                f"free variable: apply node owned by nested graph "
                f"{node.graph and node.graph.name!r}",
            )
        fn = node.fn
        if not (isinstance(fn, Constant) and isinstance(fn.value, Primitive)):
            if is_constant_graph(fn):
                classify_graph_value(fn.value)
            else:
                add(
                    FallbackReason.HIGHER_ORDER,
                    f"non-primitive callee {fn!r} (higher-order or graph call)",
                )
        stack.extend(node.inputs)
    return list(reasons.values())


# ---------------------------------------------------------------------------
# Defunctionalization: specialize recursive calls on function constants
# ---------------------------------------------------------------------------


def _family_recursive(g: Graph, memo: dict[int, bool]) -> bool:
    hit = memo.get(g._id)
    if hit is None:
        hit = any(_reaches_itself(d) for d in graph_and_descendants(g))
        memo[g._id] = hit
    return hit


def _passes_through(h: Graph, i: int, value: Any) -> bool:
    """Every call of ``h`` inside its own family must keep argument ``i``
    stable: the parameter itself, or a constant equal to ``value``."""
    p = h.parameters[i]
    for n in dfs_nodes(h.return_):
        if isinstance(n, Apply) and is_constant_graph(n.fn) and n.fn.value is h:
            if i >= len(n.args):
                return False
            a = n.args[i]
            if a is p:
                continue
            if isinstance(a, Constant) and a.value is value:
                continue
            return False
    return True


def _drop_arg(call: Apply, i: int, root: Graph) -> None:
    new = Apply(
        [call.inputs[0]] + call.args[:i] + call.args[i + 1:],
        call.graph,
        call.debug_name,
    )
    new.abstract = call.abstract
    _replace(root, call, new)


def _replace(root: Graph, old: Node, new: Node) -> None:
    for user, idx in list(old.users):
        user.set_input(idx, new)
    for g in graph_and_descendants(root):
        if g.return_ is old:
            g.set_return(new)
    if isinstance(old, Apply):
        for i, inp in enumerate(old.inputs):
            inp.users.discard((old, i))


def specialize_recursive_calls(
    root: Graph, stats: Any = None, memo: dict | None = None
) -> bool:
    """Monomorphize recursive higher-order calls (defunctionalization).

    A call ``h(..., const_fn, ...)`` where ``h``'s family is recursive (so
    the inliner refuses it) and ``const_fn`` is a graph/primitive constant
    is rewritten to ``h′(...)`` — a clone of ``h``'s family with that
    parameter bound to the constant and dropped from every signature.  The
    now-constant interior call sites inline on the optimizer's next wave,
    which is what lets ``lower_loops`` compile higher-order recursion.

    ``memo`` caches specializations across calls (keyed by graph, position
    and constant identity); pass the same dict for one optimize run.
    """
    memo = memo if memo is not None else {}
    rec_memo: dict[int, bool] = {}
    changed = False
    for site in list(dfs_nodes(root.return_)):
        if not (isinstance(site, Apply) and is_constant_graph(site.fn)):
            continue
        h = site.fn.value
        if h.return_ is None or not _family_recursive(h, rec_memo):
            continue  # the plain inliner owns non-recursive calls
        if len(site.args) != len(h.parameters):
            continue
        for i, a in enumerate(site.args):
            if not (isinstance(a, Constant) and isinstance(a.value, (Graph, Primitive))):
                continue
            if isinstance(a.value, Graph) and a.value.return_ is None:
                continue
            if not _passes_through(h, i, a.value):
                continue
            key = (h._id, i, id(a.value))
            h2 = memo.get(key)
            if h2 is None:
                h2 = _specialize(h, i, a.value)
                memo[key] = h2
            new = Apply(
                [Constant(h2, h2.name)] + site.args[:i] + site.args[i + 1:],
                site.graph,
                site.debug_name,
            )
            new.abstract = site.abstract
            _replace(root, site, new)
            if stats is not None:
                stats.record_rule("defunctionalize_call")
            changed = True
            break  # site rewritten; further args handled on the next pass
    return changed


def _specialize(h: Graph, i: int, value: Any) -> Graph:
    label = getattr(value, "name", type(value).__name__)
    cloner = GraphCloner(h, relabel=f"[{label}]")
    h2 = cloner.clone()
    # the constant may be (a clone of) a family member — self-passing style
    if isinstance(value, Graph):
        value = cloner.graph_map.get(value, value)
    p = h2.parameters[i]
    const = Constant(value, p.debug_name)
    const.abstract = p.abstract
    for user, idx in list(p.users):
        user.set_input(idx, const)
    h2.parameters.pop(i)
    # drop the bound argument from every interior self-call
    for n in list(dfs_nodes(h2.return_)):
        if isinstance(n, Apply) and is_constant_graph(n.fn) and n.fn.value is h2:
            if i < len(n.args):
                _drop_arg(n, i, h2)
    return h2


# ---------------------------------------------------------------------------
# Structured-recursion lowering
# ---------------------------------------------------------------------------


class _LoopMismatch(Exception):
    """Internal signal: this recursive family is not loop-shaped."""

    def __init__(self, kind: str, detail: str) -> None:
        self.kind = kind
        self.detail = detail
        super().__init__(f"[{kind}] {detail}")


class LoopReport:
    __slots__ = ("lowered", "scans", "reasons")

    def __init__(self) -> None:
        self.lowered = 0
        self.scans = 0
        self.reasons: list[FallbackReason] = []


def _loop_family(h: Graph) -> set[Graph]:
    """Graphs mutually reachable with ``h`` through graph constants: the
    candidate loop family (header + body blocks that jump back to it)."""
    return {g for g in graph_and_descendants(h) if h in graph_and_descendants(g)}


def _widen_abstract(ab: Any) -> Any:
    if ab is None:
        return None
    try:
        return _widen(ab)
    except Exception:  # pragma: no cover - _widen is total on our domain
        return None


def _carryable(ab: Any) -> bool:
    """Can this value ride in a loop carry?  Arrays, numeric scalars,
    None units and tuples thereof; function values / environments / opaque
    statics cannot change identity per iteration."""
    if isinstance(ab, AArray):
        return True
    if isinstance(ab, AScalar):
        return ab.kind in ("int", "float", "bool", "none")
    if isinstance(ab, ATuple):
        return all(_carryable(e) for e in ab.elements)
    return False


class _CloneEnv:
    """Clone an expression DAG owned by loop-family graphs into ``target``,
    resolving header parameters and threaded free variables through
    ``env`` (node id → target-resident node; doubles as the memo).

    Graph constants from *outside* the family are kept, unless they
    capture family-owned (or remapped) nodes — nested closures like
    if-expression thunks — in which case the closure's family is
    deep-copied with its captures resolved into the target graph."""

    def __init__(
        self,
        target: Graph,
        fam: set[Graph],
        env: dict[int, Node],
        scope: set[Graph] | None = None,
    ) -> None:
        self.target = target
        self.fam = fam
        #: graphs whose owned nodes are cloned into ``target`` — the family
        #: plus the branch graph being traced (the exit block is *not* part
        #: of the mutually-recursive family but owns its own expression)
        self.scope = fam if scope is None else scope
        self.env = env
        self._captured_memo: dict[int, list[Node]] = {}

    def _captured(self, g: Graph) -> list[Node]:
        hit = self._captured_memo.get(g._id)
        if hit is None:
            hit = [
                n
                for n in free_variables(g)
                if (n.graph in self.scope) or (n._id in self.env)
            ]
            self._captured_memo[g._id] = hit
        return hit

    def clone(self, node: Node) -> Node:
        if node._id in self.env:
            return self.env[node._id]
        stack: list[tuple[Node, bool]] = [(node, False)]
        while stack:
            cur, ready = stack.pop()
            if cur._id in self.env:
                continue
            if isinstance(cur, Constant):
                v = cur.value
                if isinstance(v, Graph):
                    if v in self.fam:
                        raise _LoopMismatch(
                            FallbackReason.RECURSION,
                            f"loop graph {v.name!r} escapes as a first-class value",
                        )
                    captured = self._captured(v)
                    if captured and not ready:
                        stack.append((cur, True))
                        stack.extend(
                            (n, False) for n in captured if n._id not in self.env
                        )
                        continue
                    if captured:
                        new: Node = Constant(self._clone_closure(v), cur.debug_name)
                    else:
                        new = Constant(v, cur.debug_name)
                else:
                    new = Constant(v, cur.debug_name)
                new.abstract = cur.abstract
                self.env[cur._id] = new
                continue
            if isinstance(cur, Parameter):
                raise _LoopMismatch(
                    FallbackReason.RECURSION,
                    f"loop body references parameter {cur!r} of "
                    f"{cur.graph and cur.graph.name!r} outside its trace frame",
                )
            assert isinstance(cur, Apply)
            if cur.graph not in self.scope:
                raise _LoopMismatch(
                    FallbackReason.FREE_VARIABLE,
                    f"loop body references node {cur!r} outside the threaded "
                    "environment",
                )
            if ready:
                new_inputs = [self.env[i._id] for i in cur.inputs]
                new = Apply(new_inputs, self.target, cur.debug_name)
                new.abstract = _widen_abstract(cur.abstract)
                self.env[cur._id] = new
            else:
                stack.append((cur, True))
                for i in cur.inputs:
                    if i._id not in self.env:
                        stack.append((i, False))
        return self.env[node._id]

    def _clone_closure(self, g: Graph) -> Graph:
        cloner = GraphCloner(g, relabel="")
        for n in self._captured(g):
            cloner.node_map[n._id] = self.env[n._id]
        return cloner.clone()


def _graph_succs(g: Graph) -> set[Graph]:
    """Graphs referenced as constants by applies *owned* by ``g``."""
    out: set[Graph] = set()
    if g.return_ is None:
        return out
    for n in dfs_nodes(g.return_):
        if isinstance(n, Apply) and n.graph is g:
            for inp in n.inputs:
                if is_constant_graph(inp):
                    out.add(inp.value)
    return out


def _reach_excluding(starts: list[Graph], h: Graph) -> set[Graph]:
    """Graphs reachable from ``starts`` through graph constants, never
    entering ``h`` (the enclosing loop header)."""
    seen: set[Graph] = set()
    stack = list(starts)
    while stack:
        g = stack.pop()
        if g in seen or g is h:
            continue
        seen.add(g)
        stack.extend(_graph_succs(g))
    return seen


def _inner_family(c: Graph, h: Graph) -> set[Graph]:
    """The inner loop family headed by ``c``: graphs on a ``c``-cycle that
    avoids the enclosing header ``h``.  Empty when ``c`` only re-enters
    the outer loop (i.e. it is not itself a loop header)."""
    fwd = _reach_excluding(list(_graph_succs(c)), h)
    if c not in fwd:
        return set()
    return {g for g in fwd if c in _reach_excluding(list(_graph_succs(g)), h)}


def _family_free_vars(fam: set[Graph]) -> list[Node]:
    """Free variables of an *inner* loop family: nodes referenced from the
    family's bodies but owned outside it.  Unlike :func:`free_variables`
    this does not descend into graph constants outside ``fam`` (the
    continuation block that jumps back to the outer header is not part of
    the inner loop), so the outer back-edge never pollutes the capture
    set.  Deterministic order (DFS from each header, sorted by id)."""
    out: list[Node] = []
    seen: set[int] = set()
    stack: list[Node] = [
        g.return_ for g in sorted(fam, key=lambda g: g._id) if g.return_ is not None
    ]
    while stack:
        n = stack.pop()
        if n._id in seen:
            continue
        seen.add(n._id)
        if isinstance(n, Constant):
            if isinstance(n.value, Graph) and n.value in fam:
                if n.value.return_ is not None:
                    stack.append(n.value.return_)
            continue
        if n.graph not in fam:
            out.append(n)
            continue
        if isinstance(n, Apply):
            stack.extend(n.inputs)
    return out


def _match_header_switch(
    h: Graph, fam: set[Graph]
) -> tuple[Node, Graph, Graph, bool]:
    """Match the canonical loop-header shape ``return switch(c, tb, fb)()``
    and split the branches: returns ``(cond_node, loop_g, other_g,
    negate)`` where ``loop_g`` is the in-family branch and ``negate``
    records that the loop continues when the switch condition is false."""
    ret = h.return_
    if not (isinstance(ret, Apply) and len(ret.inputs) == 1):
        raise _LoopMismatch(
            FallbackReason.RECURSION, "header does not end in an applied switch"
        )
    sel = ret.inputs[0]
    if not (is_apply(sel, P.switch) and len(sel.args) == 3):
        raise _LoopMismatch(
            FallbackReason.RECURSION, "header does not end in an applied switch"
        )
    cond_node, tb, fb = sel.args
    if not (is_constant_graph(tb) and is_constant_graph(fb)):
        raise _LoopMismatch(
            FallbackReason.RECURSION, "switch branches are not graph constants"
        )
    t_loops = tb.value in fam
    f_loops = fb.value in fam
    if t_loops == f_loops:
        raise _LoopMismatch(
            FallbackReason.RECURSION,
            "both switch branches re-enter the loop"
            if t_loops
            else "no switch branch re-enters the loop",
        )
    loop_g, other_g = (tb.value, fb.value) if t_loops else (fb.value, tb.value)
    if loop_g.parameters or other_g.parameters:
        raise _LoopMismatch(FallbackReason.RECURSION, "switch branch takes parameters")
    return cond_node, loop_g, other_g, not t_loops


#: trace budget: loop-block entries per site (guards against irreducible
#: control flow — e.g. a nested loop whose family reaches this header)
_MAX_TRACE = 200


class _LoopBuilder:
    """Match one entry call of a tail-recursive family and build the
    closed cond/step/exit graphs for the loop primitives."""

    def __init__(
        self,
        site: Apply,
        h: Graph | None = None,
        fam: set[Graph] | None = None,
        fvs: list[Node] | None = None,
    ) -> None:
        self.site = site
        self.h: Graph = h if h is not None else site.fn.value
        self.fam = fam if fam is not None else _loop_family(self.h)
        #: dead-carry elimination: a header parameter with no users (the
        #: parser threads not-yet-bound variables as ``None`` placeholders
        #: that are written on the back-edge but never read) is dropped
        #: from the carry — it has no typeable value and no effect
        self.live = [i for i, p in enumerate(self.h.parameters) if p.users]
        self.k = len(self.live)
        self.fvs = fvs if fvs is not None else free_variables(self.h)
        self._steps = 0

    def entry_args(self, args: list[Node]) -> list[Node]:
        """Filter an entry argument list down to the live carry slots."""
        return [args[i] for i in self.live]

    def _check_carries(self) -> None:
        for i in self.live:
            p = self.h.parameters[i]
            if not _carryable(p.abstract):
                raise _LoopMismatch(
                    FallbackReason.NON_ARRAY,
                    f"loop carry {p.debug_name or p!r} is not an array value "
                    f"({p.abstract!r})",
                )

    def build(self) -> tuple[Graph, Graph, Graph]:
        if len(self.site.args) != len(self.h.parameters):
            raise _LoopMismatch(FallbackReason.RECURSION, "entry call arity mismatch")
        cond_node, loop_g, exit_g, negate = _match_header_switch(self.h, self.fam)
        self._check_carries()
        cg = self._build_cond(cond_node, negate)
        sg = self._build_step(loop_g)
        eg = self._fresh("loop_exit")
        eg.set_return(
            _CloneEnv(
                eg, self.fam, self._base_env(eg), scope=self.fam | {exit_g}
            ).clone(exit_g.return_)
        )
        return cg, sg, eg

    def build_inner(self) -> tuple[Graph, Graph, Graph, Graph]:
        """Build cond/step graphs for an *inner* loop header reached while
        tracing an enclosing loop body.  The non-looping switch branch is
        not a value exit here — it is the continuation block that jumps
        back to the outer header — so the exit graph is an identity
        returning the final carry tuple, and the continuation is handed
        back to the outer trace."""
        cond_node, loop_g, cont_g, negate = _match_header_switch(self.h, self.fam)
        self._check_carries()
        cg = self._build_cond(cond_node, negate)
        sg = self._build_step(loop_g)
        eg = self._fresh("loop_exit")
        mt = eg.apply(P.make_tuple, *eg.parameters[: self.k])
        mt.abstract = ATuple(tuple(p.abstract for p in eg.parameters[: self.k]))
        eg.set_return(mt)
        return cg, sg, eg, cont_g

    def _build_cond(self, cond_node: Node, negate: bool) -> Graph:
        cg = self._fresh("loop_cond")
        c = _CloneEnv(cg, self.fam, self._base_env(cg)).clone(cond_node)
        if negate:
            neg = cg.apply(P.bool_not, c)
            neg.abstract = AScalar("bool")
            c = neg
        cg.set_return(c)
        return cg

    def _build_step(self, loop_g: Graph) -> Graph:
        sg = self._fresh("loop_step")
        exprs = self._trace(sg, self._base_env(sg), loop_g)
        mt = sg.apply(P.make_tuple, *exprs)
        mt.abstract = ATuple(
            tuple(
                e.abstract
                if e.abstract is not None
                else _widen_abstract(self.h.parameters[i].abstract)
                for e, i in zip(exprs, self.live)
            )
        )
        sg.set_return(mt)
        return sg

    def _fresh(self, tag: str) -> Graph:
        g = Graph(f"{self.h.name}:{tag}")
        for i in self.live:
            p = self.h.parameters[i]
            np_ = g.add_parameter(p.debug_name)
            np_.abstract = _widen_abstract(p.abstract)
        for j, v in enumerate(self.fvs):
            np_ = g.add_parameter(v.debug_name or f"fv{j}")
            np_.abstract = _widen_abstract(v.abstract)
        return g

    def _base_env(self, g: Graph) -> dict[int, Node]:
        env: dict[int, Node] = {}
        for i, np_ in zip(self.live, g.parameters[: self.k]):
            env[self.h.parameters[i]._id] = np_
        for v, np_ in zip(self.fvs, g.parameters[self.k:]):
            env[v._id] = np_
        return env

    def _trace(self, target: Graph, env: dict[int, Node], g: Graph) -> list[Node]:
        """Symbolically execute loop block ``g`` down to the back-edge,
        returning the k cloned next-carry expressions.  Handles chains of
        argument-carrying tail calls (the for-loop ``incr`` shim, if/else
        rejoin blocks) and switch diamonds whose branches both loop."""
        self._steps += 1
        if self._steps > _MAX_TRACE:
            raise _LoopMismatch(
                FallbackReason.RECURSION,
                "loop control flow too complex (trace budget exceeded — "
                "nested or irreducible recursion)",
            )
        ret = g.return_
        if not isinstance(ret, Apply):
            raise _LoopMismatch(
                FallbackReason.RECURSION, f"loop block {g.name!r} returns a non-call"
            )
        ce = _CloneEnv(target, self.fam, env)
        fn = ret.inputs[0]
        if is_constant_graph(fn):
            callee = fn.value
            if callee is self.h:
                if len(ret.args) != len(self.h.parameters):
                    raise _LoopMismatch(
                        FallbackReason.RECURSION, "back-edge arity mismatch"
                    )
                return [ce.clone(ret.args[i]) for i in self.live]
            if callee in self.fam:
                if len(ret.args) != len(callee.parameters):
                    raise _LoopMismatch(
                        FallbackReason.RECURSION, "tail-call arity mismatch"
                    )
                inner_fam = _inner_family(callee, self.h)
                if inner_fam:
                    return self._trace_inner(target, env, ce, ret, callee, inner_fam)
                env2 = dict(env)
                for p, a in zip(callee.parameters, [ce.clone(a) for a in ret.args]):
                    env2[p._id] = a
                return self._trace(target, env2, callee)
            raise _LoopMismatch(
                FallbackReason.RECURSION,
                f"loop body exits through {callee.name!r} "
                "(break-style control flow)",
            )
        if (
            isinstance(fn, Apply)
            and is_apply(fn, P.switch)
            and len(fn.args) == 3
            and len(ret.args) == 0
        ):
            c, t, f = fn.args
            if not (is_constant_graph(t) and is_constant_graph(f)):
                raise _LoopMismatch(
                    FallbackReason.RECURSION, "switch branches are not graph constants"
                )
            tg, fg = t.value, f.value
            if tg not in self.fam or fg not in self.fam:
                raise _LoopMismatch(
                    FallbackReason.RECURSION,
                    "conditional exit from the loop body (break-style control flow)",
                )
            if tg.parameters or fg.parameters:
                raise _LoopMismatch(
                    FallbackReason.RECURSION, "switch branch takes parameters"
                )
            cnode = ce.clone(c)
            ta = self._trace(target, dict(env), tg)
            fa = self._trace(target, dict(env), fg)
            out: list[Node] = []
            for i, (x, y) in enumerate(zip(ta, fa)):
                s = target.apply(P.switch, cnode, x, y)
                s.abstract = _widen_abstract(self.h.parameters[self.live[i]].abstract)
                out.append(s)
            return out
        raise _LoopMismatch(
            FallbackReason.RECURSION,
            f"unrecognized loop-block return in {g.name!r}",
        )

    def _trace_inner(
        self,
        target: Graph,
        env: dict[int, Node],
        ce: _CloneEnv,
        ret: Apply,
        callee: Graph,
        inner_fam: set[Graph],
    ) -> list[Node]:
        """The loop body tail-calls an *inner* loop header: build the inner
        loop's closed graphs, emit its ``while_loop``/``scan_loop`` apply
        inside the outer step graph, bind the inner carries to getitems of
        its result tuple, and continue the outer trace through the inner
        loop's continuation block (which holds the outer back-edge)."""
        ib = _LoopBuilder(ret, h=callee, fam=inner_fam, fvs=_family_free_vars(inner_fam))
        icg, isg, ieg, cont_g = ib.build_inner()
        if cont_g not in self.fam:
            raise _LoopMismatch(
                FallbackReason.RECURSION,
                f"inner loop {callee.name!r} continues into {cont_g.name!r} "
                "outside the loop family (break-style control flow)",
            )
        args = [ce.clone(a) for a in ib.entry_args(list(ret.args))]
        fv_args = [ce.clone(v) for v in ib.fvs]
        n_iters = _static_trip_count(ib.entry_args(list(ret.args)), icg, isg, ib.k)
        if n_iters is not None:
            inner = target.apply(
                P.scan_loop,
                Constant(isg, isg.name),
                Constant(ieg, ieg.name),
                n_iters,
                ib.k,
                *args,
                *fv_args,
                debug_name=f"scan_{callee.name}",
            )
        else:
            inner = target.apply(
                P.while_loop,
                Constant(icg, icg.name),
                Constant(isg, isg.name),
                Constant(ieg, ieg.name),
                ib.k,
                *args,
                *fv_args,
                debug_name=f"while_{callee.name}",
            )
        inner.abstract = _widen_abstract(ieg.return_.abstract)
        env2 = dict(env)
        for j, i in enumerate(ib.live):
            p = callee.parameters[i]
            gi = target.apply(P.tuple_getitem, inner, j)
            gi.abstract = _widen_abstract(p.abstract)
            env2[p._id] = gi
        return self._trace(target, env2, cont_g)


def _static_int(node: Node, args: list[Node], cg: Graph, k: int) -> int | None:
    """Resolve a cond/step operand to a static int: a literal constant, or
    a loop parameter whose binding at the entry site is statically known."""
    if isinstance(node, Constant):
        v = node.value
        return v if isinstance(v, int) and not isinstance(v, bool) else None
    if isinstance(node, Parameter) and node.graph is cg:
        j = cg.parameters.index(node)
        init = args[j] if j < k else None
        if init is None:
            return None
        if isinstance(init, Constant):
            v = init.value
            return v if isinstance(v, int) and not isinstance(v, bool) else None
        ab = init.abstract
        if isinstance(ab, AScalar) and ab.kind == "int" and ab.known():
            return int(ab.value)
    return None


def _static_trip_count(args: list[Node], cg: Graph, sg: Graph, k: int) -> int | None:
    """Trip count when the loop is an affine counting loop with static
    bounds (``for i in range(...)``): cond ``lt/gt(i, stop)``, step
    ``i + const``, static init — the scan-shaped case.  ``args`` is the
    entry argument list, already filtered to the live carry slots."""
    ret = cg.return_
    if not isinstance(ret, Apply) or len(ret.args) != 2:
        return None
    if is_apply(ret, P.lt):
        ascending = True
    elif is_apply(ret, P.gt):
        ascending = False
    else:
        return None
    iv, stop_n = ret.args
    if not (isinstance(iv, Parameter) and iv.graph is cg):
        return None
    idx = cg.parameters.index(iv)
    if idx >= k:
        return None  # comparing a loop invariant: not a counting loop
    mt = sg.return_
    if not is_apply(mt, P.make_tuple) or idx >= len(mt.args):
        return None
    if isinstance(stop_n, Parameter) and stop_n.graph is cg:
        # a carried stop bound is only static if the step keeps it
        # LOOP-INVARIANT (identity update) — `while i < n: ...; n = n - 1`
        # has a static init but a moving bound and must stay a while_loop
        j = cg.parameters.index(stop_n)
        if j < k:
            upd_j = mt.args[j] if j < len(mt.args) else None
            if not (
                isinstance(upd_j, Parameter)
                and upd_j.graph is sg
                and sg.parameters.index(upd_j) == j
            ):
                return None
    stop = _static_int(stop_n, args, cg, k)
    start = _static_int(cg.parameters[idx], args, cg, k)
    if stop is None or start is None:
        return None
    upd = mt.args[idx]
    if not (is_apply(upd, P.add) and len(upd.args) == 2):
        return None
    step = None
    for a, b in ((upd.args[0], upd.args[1]), (upd.args[1], upd.args[0])):
        if (
            isinstance(a, Parameter)
            and a.graph is sg
            and sg.parameters.index(a) == idx
            and isinstance(b, Constant)
            and isinstance(b.value, int)
            and not isinstance(b.value, bool)
        ):
            step = b.value
            break
    if step is None or step == 0:
        return None
    if ascending:
        if step < 0:
            return None
        return max(0, math.ceil((stop - start) / step))
    if step > 0:
        return None
    return max(0, math.ceil((start - stop) / (-step)))


class _NonTailBuilder:
    """Non-tail self-recursion in the single-call affine shape::

        def f(p):  return base(p) if done(p) else E[p, f(step(p))]

    where ``step`` advances each parameter by a constant integer delta
    (``n - 1``, passthrough, ...).  The recursion unwinds into two loops,
    both closed first-order graphs:

    1. a forward *count* loop running ``p`` to the base case while
       counting the recursion depth ``T``;
    2. a reversed *accumulator* loop stepping ``p`` back toward the entry
       (the inverse affine update) and folding ``acc = E[p, acc]`` — the
       order the call stack would unwind in.

    ``x * f(x, n - 1)`` — the canonical fold — becomes a trip-count loop
    plus ``acc = x * acc`` repeated ``T`` times.  Anything non-affine,
    with several self-calls, or with the call result feeding control flow
    stays a :class:`_LoopMismatch` and falls back to the VM."""

    def __init__(self, site: Apply) -> None:
        self.site = site
        self.h: Graph = site.fn.value
        self.fam = _loop_family(self.h)
        self.k = len(self.h.parameters)
        self.fvs = free_variables(self.h)

    # -- matching ----------------------------------------------------------

    def _resolve_chain(self, g: Graph) -> tuple[Graph, set[Graph]]:
        """Follow parameterless thunk tail-calls (``return block()``) down
        to the graph that owns the branch's value expression."""
        scope = {g}
        for _ in range(32):
            ret = g.return_
            if (
                isinstance(ret, Apply)
                and is_constant_graph(ret.inputs[0])
                and not ret.args
                and ret.inputs[0].value is not self.h
                and not ret.inputs[0].value.parameters
                and ret.inputs[0].value.return_ is not None
            ):
                g = ret.inputs[0].value
                scope.add(g)
                continue
            return g, scope
        raise _LoopMismatch(
            FallbackReason.RECURSION, "branch thunk chain too long"
        )

    @staticmethod
    def _int_const(n: Node) -> int | None:
        if isinstance(n, Constant):
            v = n.value
            if isinstance(v, int) and not isinstance(v, bool):
                return v
        return None

    def _match_self_call(self, expr: Node) -> tuple[Apply, list[int]]:
        """Find the unique self-call inside the recursive expression and
        the per-parameter affine deltas of its argument list."""
        calls: list[Apply] = []
        seen: set[int] = set()
        stack: list[Node] = [expr]
        while stack:
            n = stack.pop()
            if n._id in seen:
                continue
            seen.add(n._id)
            if isinstance(n, Constant):
                # any graph referenced here that calls h is in the family
                # (it is reachable from h through this very expression), so
                # out-of-family constants are safe leaves
                if isinstance(n.value, Graph) and n.value in self.fam:
                    raise _LoopMismatch(
                        FallbackReason.RECURSION,
                        "loop graph escapes the recursive expression as a value",
                    )
                continue
            if isinstance(n, Apply):
                fn = n.fn
                if is_constant_graph(fn) and fn.value in self.fam:
                    if fn.value is not self.h:
                        raise _LoopMismatch(
                            FallbackReason.RECURSION,
                            "recursive expression calls another family block",
                        )
                    calls.append(n)
                    stack.extend(n.args)  # skip the callee constant itself
                    continue
                stack.extend(n.inputs)
        if len(calls) != 1:
            raise _LoopMismatch(
                FallbackReason.RECURSION,
                "non-tail recursion is not a single direct self-call",
            )
        sc = calls[0]
        if len(sc.args) != self.k:
            raise _LoopMismatch(FallbackReason.RECURSION, "self-call arity mismatch")
        deltas: list[int] = []
        for i, a in enumerate(sc.args):
            p = self.h.parameters[i]
            d: int | None = None
            if a is p:
                d = 0
            elif is_apply(a, P.add) and len(a.args) == 2:
                x, y = a.args
                if x is p:
                    d = self._int_const(y)
                elif y is p:
                    d = self._int_const(x)
            elif is_apply(a, P.sub) and len(a.args) == 2:
                x, y = a.args
                if x is p:
                    c = self._int_const(y)
                    d = None if c is None else -c
            if d is None:
                raise _LoopMismatch(
                    FallbackReason.RECURSION,
                    f"self-call argument {i} is not an affine update of "
                    f"parameter {p.debug_name or i}",
                )
            deltas.append(d)
        return sc, deltas

    # -- graph construction ------------------------------------------------

    def _fresh(self, tag: str, extra: list[tuple[str, Any]]) -> Graph:
        g = Graph(f"{self.h.name}:{tag}")
        for p in self.h.parameters:
            np_ = g.add_parameter(p.debug_name)
            np_.abstract = _widen_abstract(p.abstract)
        for name, ab in extra:
            np_ = g.add_parameter(name)
            np_.abstract = ab
        for j, v in enumerate(self.fvs):
            np_ = g.add_parameter(v.debug_name or f"fv{j}")
            np_.abstract = _widen_abstract(v.abstract)
        return g

    def _env(self, g: Graph, n_extra: int) -> dict[int, Node]:
        env: dict[int, Node] = {}
        for p, np_ in zip(self.h.parameters, g.parameters[: self.k]):
            env[p._id] = np_
        for v, np_ in zip(self.fvs, g.parameters[self.k + n_extra:]):
            env[v._id] = np_
        return env

    def _tuple(self, g: Graph, parts: list[Node]) -> Apply:
        mt = g.apply(P.make_tuple, *parts)
        mt.abstract = ATuple(tuple(p.abstract for p in parts))
        return mt

    def build(self, caller: Graph) -> Apply:
        h = self.h
        k = self.k
        if len(self.site.args) != k:
            raise _LoopMismatch(FallbackReason.RECURSION, "entry call arity mismatch")
        cond_node, rec_g, base_g, negate = _match_header_switch(h, self.fam)
        for p in h.parameters:
            if not _carryable(p.abstract):
                raise _LoopMismatch(
                    FallbackReason.NON_ARRAY,
                    f"recursion carry {p.debug_name or p!r} is not an array "
                    f"value ({p.abstract!r})",
                )
        rec_owner, rec_scope = self._resolve_chain(rec_g)
        expr = rec_owner.return_
        sc, deltas = self._match_self_call(expr)
        base_owner, base_scope = self._resolve_chain(base_g)

        INT = AScalar("int")
        p_abs = [_widen_abstract(p.abstract) for p in h.parameters]
        acc_ab = _widen_abstract(self.site.abstract)

        # 1. count loop: run p to the base case, counting the depth T
        ccg = self._fresh("rec_count_cond", [("t", INT)])
        c = _CloneEnv(ccg, self.fam, self._env(ccg, 1)).clone(cond_node)
        if negate:
            neg = ccg.apply(P.bool_not, c)
            neg.abstract = AScalar("bool")
            c = neg
        ccg.set_return(c)

        csg = self._fresh("rec_count_step", [("t", INT)])
        ce = _CloneEnv(csg, self.fam, self._env(csg, 1))
        nps = [ce.clone(a) for a in sc.args]
        nt = csg.apply(P.add, csg.parameters[k], 1)
        nt.abstract = INT
        csg.set_return(self._tuple(csg, [*nps, nt]))

        ceg = self._fresh("rec_count_exit", [("t", INT)])
        ceg.set_return(self._tuple(ceg, list(ceg.parameters[: k + 1])))

        fv_nodes = list(self.fvs)
        p1 = caller.apply(
            P.while_loop,
            Constant(ccg, ccg.name),
            Constant(csg, csg.name),
            Constant(ceg, ceg.name),
            k + 1,
            *self.site.args,
            0,
            *fv_nodes,
            debug_name=f"count_{h.name}",
        )
        p1.abstract = ATuple((*p_abs, INT))
        pb: list[Node] = []
        for i in range(k):
            gi = caller.apply(P.tuple_getitem, p1, i)
            gi.abstract = p_abs[i]
            pb.append(gi)
        tnode = caller.apply(P.tuple_getitem, p1, k)
        tnode.abstract = INT

        # 2. base value at the fixed point
        benv: dict[int, Node] = {h.parameters[i]._id: pb[i] for i in range(k)}
        for v in fv_nodes:
            benv[v._id] = v
        acc0 = _CloneEnv(
            caller, self.fam, benv, scope=self.fam | base_scope
        ).clone(base_owner.return_)

        # 3. reversed accumulator loop: invert the affine step, fold E
        extra = [("acc", acc_ab), ("j", INT), ("T", INT)]
        rcg = self._fresh("rec_acc_cond", extra)
        lt = rcg.apply(P.lt, rcg.parameters[k + 1], rcg.parameters[k + 2])
        lt.abstract = AScalar("bool")
        rcg.set_return(lt)

        rsg = self._fresh("rec_acc_step", extra)
        prev: list[Node] = []
        for i, d in enumerate(deltas):
            p = rsg.parameters[i]
            if d == 0:
                prev.append(p)
            else:
                inv = rsg.apply(P.sub, p, d)
                inv.abstract = p.abstract
                prev.append(inv)
        eenv: dict[int, Node] = {h.parameters[i]._id: prev[i] for i in range(k)}
        for v, np_ in zip(self.fvs, rsg.parameters[k + 3:]):
            eenv[v._id] = np_
        eenv[sc._id] = rsg.parameters[k]  # the unwound recursive result
        nacc = _CloneEnv(
            rsg, self.fam, eenv, scope=self.fam | rec_scope
        ).clone(expr)
        nj = rsg.apply(P.add, rsg.parameters[k + 1], 1)
        nj.abstract = INT
        rsg.set_return(self._tuple(rsg, [*prev, nacc, nj]))

        reg = self._fresh("rec_acc_exit", extra)
        reg.set_return(reg.parameters[k])

        new = caller.apply(
            P.while_loop,
            Constant(rcg, rcg.name),
            Constant(rsg, rsg.name),
            Constant(reg, reg.name),
            k + 2,
            *pb,
            acc0,
            0,
            tnode,
            *fv_nodes,
            debug_name=f"unwind_{h.name}",
        )
        new.abstract = acc_ab
        return new


def _find_site(root: Graph, failed: set[int]) -> Apply | None:
    """First live entry call of a recursive header (a call from *outside*
    the header's own family — back-edges don't count)."""
    for n in dfs_nodes(root.return_):
        if not (isinstance(n, Apply) and is_constant_graph(n.fn)):
            continue
        h = n.fn.value
        if h._id in failed or h.return_ is None or not _reaches_itself(h):
            continue
        if n.graph in _loop_family(h):
            continue  # interior back-edge, not an entry
        return n
    return None


def lower_loops(root: Graph, stats: Any = None) -> LoopReport:
    """Rewrite every recognizable tail-recursive family below ``root``
    into ``while_loop`` / ``scan_loop`` applies (in place).  One site is
    rewritten per scan so later sites see the updated graph; headers that
    fail to match are recorded once in the report and skipped."""
    from repro_torch.obs import trace as obs_trace

    report = LoopReport()
    failed: set[int] = set()
    sp = obs_trace.span("closure.lower_loops", graph=root.name)
    with sp:
        _lower_loops_body(root, report, failed, stats)
        sp.set(lowered=report.lowered, scans=report.scans, failed=len(failed))
    return report


def _lower_loops_body(
    root: Graph, report: LoopReport, failed: set[int], stats: Any = None
) -> None:
    for _ in range(64):
        site = _find_site(root, failed)
        synthetic = False
        if site is None:
            # A root-recursive function (``def f(x, n): ... f(x, n - 1)``)
            # IS its own header, so no external entry call exists below
            # root.  Synthesize one — args are the root's own parameters —
            # and splice the loop in as the root's new return value.
            if (
                root._id not in failed
                and root.return_ is not None
                and _reaches_itself(root)
            ):
                site = Apply([Constant(root, root.name), *root.parameters], root)
                site.abstract = root.return_.abstract
                synthetic = True
            else:
                break
        h = site.fn.value

        def splice(new: Apply) -> None:
            if synthetic:
                root.set_return(new)
            else:
                _replace(root, site, new)

        try:
            builder = _LoopBuilder(site)
            cg, sg, eg = builder.build()
        except _LoopMismatch as e:
            try:
                new = _NonTailBuilder(site).build(site.graph)
            except _LoopMismatch:
                failed.add(h._id)
                report.reasons.append(
                    FallbackReason(e.kind, f"{h.name}: {e.detail}")
                )
                continue
            splice(new)
            report.lowered += 1
            if stats is not None:
                stats.record_rule("lower_loop_nontail")
            continue
        caller = site.graph
        fv_nodes = list(builder.fvs)
        args = builder.entry_args(list(site.args))
        n_iters = _static_trip_count(args, cg, sg, builder.k)
        if n_iters is not None:
            new = caller.apply(
                P.scan_loop,
                Constant(sg, sg.name),
                Constant(eg, eg.name),
                n_iters,
                builder.k,
                *args,
                *fv_nodes,
                debug_name=f"scan_{h.name}",
            )
            report.scans += 1
            if stats is not None:
                stats.record_rule("lower_loop_scan")
        else:
            new = caller.apply(
                P.while_loop,
                Constant(cg, cg.name),
                Constant(sg, sg.name),
                Constant(eg, eg.name),
                builder.k,
                *args,
                *fv_nodes,
                debug_name=f"while_{h.name}",
            )
            if stats is not None:
                stats.record_rule("lower_loop_while")
        new.abstract = _widen_abstract(eg.return_.abstract)
        splice(new)
        report.lowered += 1
