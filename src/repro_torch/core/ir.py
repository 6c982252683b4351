"""Graph-based direct intermediate representation (the paper's §3).

A *function* is a :class:`Graph` with a list of parameter nodes and a single
return node (multiple return values via tuples).  A :class:`Node` is either

* an **apply** node: an ordered list of incoming edges; the first edge points
  to the function being applied, the rest to its arguments,
* a **parameter** node: belongs to exactly one graph,
* a **constant** node: no incoming edges, carries a ``value`` (a Python
  scalar, array, :class:`Primitive <repro_torch.core.primitives.Primitive>`, or a
  :class:`Graph` — graphs are first-class values).

Links are bidirectional (``node.users``) so graphs can be traversed either
way.  Free variables are represented *directly*: an apply node belonging to
graph ``G`` may point at a node owned by a different graph ``P``, which makes
``G`` implicitly nested inside ``P`` (the Thorin-style closure representation
of the paper §3 "Closure representation").
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Iterator

__all__ = [
    "Node",
    "Apply",
    "Parameter",
    "Constant",
    "Graph",
    "GraphCloner",
    "FamilyIndex",
    "is_constant",
    "is_constant_graph",
    "is_constant_prim",
    "is_apply",
    "is_parameter",
    "toposort",
    "dfs_nodes",
    "succ_incoming",
    "free_variables",
    "graphs_used",
    "graph_and_descendants",
]

_counter = itertools.count()


class Node:
    """Base class for IR nodes."""

    __slots__ = ("graph", "abstract", "debug_name", "_id", "users")

    def __init__(self, graph: "Graph | None", debug_name: str = "") -> None:
        self.graph = graph
        #: inferred abstract value (types/shapes/values), set by ``infer``
        self.abstract = None
        self.debug_name = debug_name
        self._id = next(_counter)
        #: set of ``(user_node, input_index)`` pairs, maintained by Graph ops
        self.users: set[tuple["Node", int]] = set()

    # -- classification helpers ------------------------------------------
    @property
    def is_apply(self) -> bool:
        return isinstance(self, Apply)

    @property
    def is_parameter(self) -> bool:
        return isinstance(self, Parameter)

    @property
    def is_constant(self) -> bool:
        return isinstance(self, Constant)

    @property
    def inputs(self) -> list["Node"]:
        return []

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        name = self.debug_name or f"%{self._id}"
        return f"<{type(self).__name__} {name}>"


class Apply(Node):
    """Function application: ``inputs[0]`` is the callee, the rest args."""

    __slots__ = ("_inputs",)

    def __init__(self, inputs: list[Node], graph: "Graph", debug_name: str = "") -> None:
        super().__init__(graph, debug_name)
        self._inputs: list[Node] = []
        for i, inp in enumerate(inputs):
            self._inputs.append(inp)
            inp.users.add((self, i))

    @property
    def inputs(self) -> list[Node]:
        return self._inputs

    @property
    def fn(self) -> Node:
        return self._inputs[0]

    @property
    def args(self) -> list[Node]:
        return self._inputs[1:]

    def set_input(self, index: int, new: Node) -> None:
        old = self._inputs[index]
        old.users.discard((self, index))
        self._inputs[index] = new
        new.users.add((self, index))


class Parameter(Node):
    __slots__ = ()

    def __init__(self, graph: "Graph", debug_name: str = "") -> None:
        super().__init__(graph, debug_name)


class Constant(Node):
    """A constant value.  ``value`` may be a Graph (first-class functions)."""

    __slots__ = ("value",)

    def __init__(self, value: Any, debug_name: str = "") -> None:
        super().__init__(None, debug_name)
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover
        from .primitives import Primitive

        if isinstance(self.value, Graph):
            return f"<Const graph:{self.value.name}>"
        if isinstance(self.value, Primitive):
            return f"<Const prim:{self.value.name}>"
        return f"<Const {self.value!r}>"


def is_constant(node: Node) -> bool:
    return isinstance(node, Constant)


def is_constant_graph(node: Node) -> bool:
    return isinstance(node, Constant) and isinstance(node.value, Graph)


def is_constant_prim(node: Node, prim: Any = None) -> bool:
    from .primitives import Primitive

    if not (isinstance(node, Constant) and isinstance(node.value, Primitive)):
        return False
    return prim is None or node.value is prim


def is_apply(node: Node, prim: Any = None) -> bool:
    if not isinstance(node, Apply):
        return False
    return prim is None or is_constant_prim(node.fn, prim)


def is_parameter(node: Node) -> bool:
    return isinstance(node, Parameter)


class Graph:
    """A function: parameter nodes + a return node.

    Graphs are first-class: wrap one in a :class:`Constant` to pass it as a
    value.  ``flags`` carries parse/transform metadata (e.g. source info).
    """

    __slots__ = (
        "name",
        "parameters",
        "return_",
        "flags",
        "parent_hint",
        "_id",
        "primal",
        "transforms",
    )

    def __init__(self, name: str = "") -> None:
        self._id = next(_counter)
        self.name = name or f"g{self._id}"
        self.parameters: list[Parameter] = []
        self.return_: Node | None = None
        self.flags: dict[str, Any] = {}
        #: graph this one was created inside of (scoping hint from the parser)
        self.parent_hint: "Graph | None" = None
        #: if this graph was produced by a transform, its source graph
        self.primal: "Graph | None" = None
        #: cache of graph transforms, e.g. {"grad": <Graph>}
        self.transforms: dict[str, Any] = {}

    # -- construction helpers --------------------------------------------
    def add_parameter(self, debug_name: str = "") -> Parameter:
        p = Parameter(self, debug_name)
        self.parameters.append(p)
        return p

    def apply(self, *inputs: Any, debug_name: str = "") -> Apply:
        """Create an apply node in this graph.  Non-Node inputs are wrapped
        in Constants (Graph/Primitive/array/scalar values alike)."""
        nodes = [i if isinstance(i, Node) else Constant(i) for i in inputs]
        return Apply(nodes, self, debug_name)

    def constant(self, value: Any) -> Constant:
        return Constant(value)

    def set_return(self, node: Node) -> None:
        self.return_ = node

    # -- queries -----------------------------------------------------------
    def nodes(self) -> list[Node]:
        """All nodes reachable from the return node (incl. nested-graph uses)."""
        return list(dfs_nodes(self.return_))

    def local_nodes(self) -> list[Node]:
        return [n for n in self.nodes() if n.graph is self]

    def free_variables(self) -> list[Node]:
        return free_variables(self)

    def child_graphs(self) -> set["Graph"]:
        """Graphs referenced as constants anywhere below this graph."""
        return graphs_used(self)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Graph {self.name}>"


# ---------------------------------------------------------------------------
# Traversals
# ---------------------------------------------------------------------------


def succ_incoming(node: Node) -> Iterable[Node]:
    """Successors following incoming edges, *entering* nested graphs."""
    if isinstance(node, Apply):
        yield from node.inputs
    elif isinstance(node, Constant) and isinstance(node.value, Graph):
        g = node.value
        if g.return_ is not None:
            yield g.return_
        # parameters are roots; reachable via uses inside the body anyway


def dfs_nodes(root: Node | None) -> Iterator[Node]:
    """Depth-first over nodes reachable from ``root``, entering graph
    constants (so the whole *graph family* below a node is visited)."""
    if root is None:
        return
    seen: set[int] = set()
    stack = [root]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        yield node
        stack.extend(succ_incoming(node))


def toposort(graph: Graph) -> list[Node]:
    """Topological order of the nodes *owned by* ``graph`` (dependencies
    first).  Nested graphs and free variables count as leaves."""
    order: list[Node] = []
    seen: set[int] = set()
    # iterative post-order
    stack: list[tuple[Node, bool]] = [(graph.return_, False)]
    while stack:
        node, processed = stack.pop()
        if processed:
            if node.graph is graph:
                order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        if isinstance(node, Apply) and node.graph is graph:
            for inp in node.inputs:
                if id(inp) not in seen:
                    stack.append((inp, False))
    return order


def graphs_used(graph: Graph) -> set[Graph]:
    """All graphs appearing as constants in ``graph``'s reachable family."""
    out: set[Graph] = set()
    for node in dfs_nodes(graph.return_):
        if is_constant_graph(node):
            out.add(node.value)
    return out


def graph_and_descendants(graph: Graph) -> set[Graph]:
    # dfs_nodes already enters graph constants transitively, so ONE dfs
    # covers the whole family (the per-graph re-walk was O(F·N)).
    out: set[Graph] = {graph}
    for node in dfs_nodes(graph.return_):
        if is_constant_graph(node):
            out.add(node.value)
    return out


def direct_free_variables(graph: Graph) -> list[Node]:
    """Nodes referenced by ``graph``'s own applies — or as its return node —
    but owned by some other graph (one level; no nested propagation)."""
    fvs: dict[int, Node] = {}
    ret = graph.return_
    if ret is not None and ret.graph is not None and ret.graph is not graph:
        fvs[ret._id] = ret
    for node in graph.nodes():
        if isinstance(node, Apply) and node.graph is graph:
            for inp in node.inputs:
                if inp.graph is not None and inp.graph is not graph:
                    fvs[inp._id] = inp
    return [fvs[k] for k in sorted(fvs)]


def free_variables(graph: Graph) -> list[Node]:
    """Transitive free variables of ``graph``: every node owned by an
    *enclosing* scope that ``graph`` — or any graph it references, directly
    or transitively — may capture.  Computed as a least fixpoint over the
    graph-reference relation (recursion through an enclosing graph must not
    make that graph's locals look bound — see tests/core/test_ir.py)."""
    # collect the reference closure
    graphs = graph_and_descendants(graph)
    direct: dict[Graph, set[Node]] = {}
    refs: dict[Graph, set[Graph]] = {}
    for g in graphs:
        direct[g] = {n for n in direct_free_variables(g)}
        refs[g] = set()
        for node in dfs_nodes(g.return_):
            if isinstance(node, Apply) and node.graph is g:
                for inp in node.inputs:
                    if is_constant_graph(inp):
                        refs[g].add(inp.value)
    fv: dict[Graph, set[Node]] = {g: set(direct[g]) for g in graphs}
    changed = True
    while changed:
        changed = False
        for g in graphs:
            acc = set(direct[g])
            for h in refs[g]:
                acc |= fv.get(h, set())
            acc = {n for n in acc if n.graph is not g}
            if acc != fv[g]:
                fv[g] = acc
                changed = True
    out = {n._id: n for n in fv[graph]}
    return [out[k] for k in sorted(out)]


# ---------------------------------------------------------------------------
# Incremental family bookkeeping
# ---------------------------------------------------------------------------


def _graph_body_facts(g: Graph) -> tuple[frozenset, frozenset]:
    """One body walk from ``g.return_`` (apply-input edges only, NOT
    entering graph constants, including free-variable chains) collecting:

    * ``crefs`` — graph constants referenced.  The transitive closure of
      this relation equals the entering-constants reachability of
      ``dfs_nodes``; it is the edge set of the graph-reference digraph
      :class:`FamilyIndex` runs SCC over.
    * ``ext`` — owners of foreign nodes the walk touches (free variables),
      including the owners of nodes referenced by
      :class:`SymbolicKey <repro_torch.core.values.SymbolicKey>` constants: a
      key is an edge for sharing purposes (writer and reader must agree
      on node identity).  Used by the shared-region clone analysis.

    Both are functions of ``g``'s body alone, so :class:`FamilyIndex`
    memoizes them per graph until the body is rewritten."""
    from .values import SymbolicKey

    crefs: set[Graph] = set()
    ext: set[Graph] = set()
    if g.return_ is None:
        return frozenset(), frozenset()
    seen: set[int] = set()
    stack: list[Node] = [g.return_]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if isinstance(n, Constant):
            if isinstance(n.value, Graph):
                crefs.add(n.value)
            elif isinstance(n.value, SymbolicKey):
                owner = n.value.node.graph
                if owner is not None and owner is not g:
                    ext.add(owner)
            continue
        owner = n.graph
        if owner is not None and owner is not g:
            ext.add(owner)
        if isinstance(n, Apply):
            stack.extend(n._inputs)
    return frozenset(crefs), frozenset(ext)


def _clone_needed(root: Graph, fam: set[Graph], body_facts) -> set[Graph]:
    """The subset of ``root``'s family an inline clone must actually copy.

    Cloning exists to rebind ``root``'s parameters (``param_repl``); any
    sub-family that is *closed* — its graphs reference, capture, and key
    only nodes inside itself — evaluates identically in the original and
    the clone, so the cloner can keep one shared copy instead of
    deep-copying it per call site (the inline "clone storm" fix).  A graph
    must be copied when its region touches anything outside itself:
    another family graph's nodes (free variables that will be remapped,
    transitively including ``root``'s parameters) or symbolic keys into
    one.  Falls back to the whole family when the reference digraph is
    cyclic (recursive families are never inlined, but stay safe anyway).
    """
    if len(fam) == 1:
        return set(fam)
    info = {g: body_facts(g) for g in fam}
    # region(g) = {g} ∪ transitive graph-constant closure, via post-order
    # over the (acyclic for inline-safe callees) reference digraph
    region: dict[Graph, frozenset] = {}
    state: dict[int, int] = {}  # id(g) -> 1 in-progress, 2 done
    for start in fam:
        if state.get(id(start)) == 2:
            continue
        stack: list[tuple[Graph, bool]] = [(start, False)]
        while stack:
            g, ready = stack.pop()
            if ready:
                acc = {g}
                for c in info[g][0]:
                    if c not in fam:
                        continue
                    if c in region:
                        acc |= region[c]
                    else:  # cycle (recursive family): share nothing
                        return set(fam)
                region[g] = frozenset(acc)
                state[id(g)] = 2
                continue
            st = state.get(id(g))
            if st == 2:
                continue
            if st == 1:  # back-edge: cyclic reference digraph
                return set(fam)
            state[id(g)] = 1
            stack.append((g, True))
            for c in info[g][0]:
                if c not in fam:
                    continue
                if state.get(id(c)) != 2:
                    if state.get(id(c)) == 1:
                        return set(fam)
                    stack.append((c, False))
    bad = {g for g in fam if any(e in fam and e not in region[g] for e in info[g][1])}
    # taint propagates up the reference digraph: a clean graph whose region
    # contains a bad one cannot be shared either (its copy must reference
    # the bad graph's copy)
    return {root} | {g for g in fam if region[g] & bad}


class FamilyIndex:
    """Incrementally-maintained family / recursion / inline-safety facts for
    a root graph under rewriting.

    The optimizer asks three questions over and over: which graphs make up
    the family below ``root``, is a graph recursive (can it reach a constant
    reference to itself), and is a callee safe to inline (nothing recursive
    reachable from it).  Recomputing these from scratch after every inline
    wave is O(family × nodes); this index instead answers from a facts
    table built in ONE pass per invalidation epoch:

    * ``_ensure_facts`` runs a single linear walk collecting per-graph
      direct graph-constant references (the edge set of the reference
      digraph — its transitive closure equals ``dfs_nodes`` reachability),
      then one iterative Tarjan SCC pass over it: ``is_recursive`` is
      membership in a cyclic SCC, ``inline_safe`` is "no cyclic SCC
      reachable", folded in reverse topological order as SCCs pop.  Every
      subsequent query is a dict hit.
    * ``note_clone`` adds the freshly-cloned graphs to the family set,
      pre-seeds their facts (an inline-safe callee's clones reference only
      other clones and shared inline-safe originals, so each clone is
      non-recursive and safe), and drops only the descendant /
      clone-family entries that contain the inline target.
    * Local rewrites may *orphan* graphs (the family set becomes a
      superset) — scanning an orphan is wasted work, never unsound.  A
      rewrite can also cut a graph's self-reference; call
      ``invalidate_rewrites`` between rewrite passes to pick that up
      (the facts table is rebuilt lazily, one linear pass per epoch).
    * ``clone_family`` memoizes the inliner's shared-region analysis
      (:func:`_clone_needed`) per callee, so inlining the same callee at
      many call sites in a wave analyses it once.
    """

    __slots__ = (
        "root",
        "_graphs",
        "_desc",
        "_rec",
        "_safe",
        "_facts",
        "_clonefam",
        "_bodyfacts",
        "_topo",
    )

    def __init__(self, root: Graph) -> None:
        self.root = root
        self._graphs: set[Graph] | None = None
        self._desc: dict[Graph, set[Graph]] = {}
        self._rec: dict[Graph, bool] = {}
        self._safe: dict[Graph, bool] = {}
        self._facts = False
        #: callee -> (its full family, the subset an inline clone must copy)
        self._clonefam: dict[Graph, tuple[frozenset, frozenset]] = {}
        #: per-graph (crefs, ext) body facts — the single-walk currency
        #: everything above is derived from; dropped per graph when its
        #: body is rewritten (see invalidate_rewrites / note_clone)
        self._bodyfacts: dict[Graph, tuple[frozenset, frozenset]] = {}
        #: Tarjan pop position per graph: lower = deeper in the reference
        #: DAG (popped before its ancestors).  The inliner sorts call
        #: sites by their owner's position so callee bodies are flattened
        #: BEFORE being cloned into callers — without the ordering, a call
        #: nested k levels deep is re-cloned k times across waves
        self._topo: dict[Graph, int] = {}

    # -- queries -----------------------------------------------------------
    def graphs(self) -> set[Graph]:
        if self._graphs is None:
            self._graphs = graph_and_descendants(self.root)
        return self._graphs

    def descendants(self, g: Graph) -> set[Graph]:
        """``{g}`` plus every graph transitively referenced from it —
        computed as the closure of the memoized per-graph crefs instead of
        a full node walk (the two are equivalent: crefs is exactly the
        one-step graph-reference relation of ``dfs_nodes``)."""
        hit = self._desc.get(g)
        if hit is None:
            out = {g}
            stack = [g]
            while stack:
                for c in self.body_facts(stack.pop())[0]:
                    if c not in out:
                        out.add(c)
                        stack.append(c)
            hit = self._desc[g] = out
        return hit

    def is_recursive(self, g: Graph) -> bool:
        """Can ``g`` reach a constant reference to itself?  Equivalent to
        membership in a cyclic SCC of the graph-reference digraph — the
        SAME reachability the cloner uses (dfs entering graph constants),
        so classification and clone scope can never disagree."""
        hit = self._rec.get(g)
        if hit is None:
            self._ensure_facts()
            hit = self._rec.get(g)
            if hit is None:  # graph surfaced after the facts pass
                hit = any(
                    is_constant_graph(n) and n.value is g
                    for n in dfs_nodes(g.return_)
                )
                self._rec[g] = hit
        return hit

    def inline_safe(self, g: Graph) -> bool:
        """True iff nothing recursive is reachable from ``g`` — the cloner
        copies ``g``'s family, and duplicating a recursive cycle exposes a
        fresh entry wrapper every wave (unbounded peeling)."""
        hit = self._safe.get(g)
        if hit is None:
            self._ensure_facts()
            hit = self._safe.get(g)
            if hit is None:  # graph surfaced after the facts pass
                hit = not any(self.is_recursive(h) for h in self.descendants(g))
                self._safe[g] = hit
        return hit

    def clone_family(self, g: Graph) -> set[Graph]:
        """The subset of ``g``'s family an inline clone must deep-copy
        (everything else is closed and shared — see :func:`_clone_needed`),
        memoized per callee until a rewrite epoch or a clone into one of
        its members invalidates it."""
        hit = self._clonefam.get(g)
        if hit is None:
            fam = frozenset(self.descendants(g))
            hit = (fam, frozenset(_clone_needed(g, fam, self.body_facts)))
            self._clonefam[g] = hit
        return set(hit[1])

    def topo_pos(self, g: Graph) -> int:
        """Reverse-topological position of ``g`` (deepest-first ordering
        for the inliner); graphs unknown to the facts pass sort last."""
        self._ensure_facts()
        return self._topo.get(g, 1 << 30)

    def body_facts(self, g: Graph) -> tuple[frozenset, frozenset]:
        """Memoized :func:`_graph_body_facts` — one walk per graph per
        body version."""
        hit = self._bodyfacts.get(g)
        if hit is None:
            hit = self._bodyfacts[g] = _graph_body_facts(g)
        return hit

    def _ensure_facts(self) -> None:
        """One linear pass: per-graph direct reference edges, then Tarjan
        SCC.  Cyclic SCC => every member recursive and unsafe; acyclic
        singleton => non-recursive, safe iff all referenced graphs are
        (folded as SCCs pop, which is reverse topological order)."""
        if self._facts:
            return
        self._facts = True
        self._topo = {}
        topo = self._topo
        # ordering discipline: graphs are visited in creation (_id) order so
        # the Tarjan pop order — and with it the inliner's deepest-first
        # site ordering — is identical run to run (sets of graphs iterate
        # in address order, which Python does not stabilize across runs)
        refs: dict[Graph, list[Graph]] = {}
        work = sorted(self.graphs(), key=lambda g: g._id, reverse=True)
        while work:
            g = work.pop()
            if g in refs:
                continue
            rs = sorted(self.body_facts(g)[0], key=lambda h: h._id)
            refs[g] = rs
            work.extend(h for h in rs if h not in refs)
        rec, safe = self._rec, self._safe
        index: dict[int, int] = {}
        low: dict[int, int] = {}
        on: set[int] = set()
        scc_stack: list[Graph] = []
        counter = 0
        for start in refs:
            if id(start) in index:
                continue
            frames: list[tuple[Graph, int]] = [(start, 0)]
            while frames:
                g, pi = frames[-1]
                gid = id(g)
                if pi == 0:
                    index[gid] = low[gid] = counter
                    counter += 1
                    scc_stack.append(g)
                    on.add(gid)
                children = refs[g]
                descended = False
                while pi < len(children):
                    h = children[pi]
                    pi += 1
                    hid = id(h)
                    if hid not in index:
                        frames[-1] = (g, pi)
                        frames.append((h, 0))
                        descended = True
                        break
                    if hid in on and index[hid] < low[gid]:
                        low[gid] = index[hid]
                if descended:
                    continue
                frames.pop()
                if frames:
                    pgid = id(frames[-1][0])
                    if low[gid] < low[pgid]:
                        low[pgid] = low[gid]
                if low[gid] == index[gid]:
                    comp: list[Graph] = []
                    while True:
                        h = scc_stack.pop()
                        on.discard(id(h))
                        comp.append(h)
                        if h is g:
                            break
                    for h in comp:
                        topo[h] = len(topo)
                    if len(comp) > 1 or any(c is g for c in refs[g]):
                        for h in comp:
                            rec[h] = True
                            safe[h] = False
                    else:
                        rec[g] = False
                        safe[g] = all(safe[c] for c in refs[g])

    # -- maintenance -------------------------------------------------------
    def note_clone(self, cloner: "GraphCloner") -> None:
        """Incremental update after an inline clone: extend the family with
        the new graphs; drop descendant entries that contained the inline
        target (they just gained the clones).  Recursion/safety caches stay
        valid — see the class docstring."""
        target = cloner.inline_target
        new_graphs = set(cloner.graph_map.values())
        if target is not None:
            new_graphs.discard(target)
        if self._graphs is not None:
            self._graphs |= new_graphs
        if self._safe.get(cloner.root) is True:
            # clones of an inline-safe family reference only other clones
            # and shared inline-safe originals: non-recursive and safe
            for ng in new_graphs:
                self._rec.setdefault(ng, False)
                self._safe.setdefault(ng, True)
        # a clone's body facts are its original's, mapped through the
        # cloner (shared references stay as-is) — seeding them here saves
        # one full body walk per cloned graph per facts epoch
        gmap = cloner.graph_map
        for og, ng in gmap.items():
            if ng is target or ng not in new_graphs:
                continue
            base = self._bodyfacts.get(og)
            if base is not None:
                self._bodyfacts[ng] = (
                    frozenset(gmap.get(c, c) for c in base[0]),
                    frozenset(gmap.get(e, e) for e in base[1]),
                )
            pos = self._topo.get(og)
            if pos is not None:
                self._topo.setdefault(ng, pos)
        if target is not None:
            self._bodyfacts.pop(target, None)
            stale = [g for g, d in self._desc.items() if target in d]
            for g in stale:
                del self._desc[g]
            stale_cf = [g for g, (fam, _) in self._clonefam.items() if target in fam]
            for g in stale_cf:
                del self._clonefam[g]

    def invalidate_rewrites(self, dirty: set[Graph] | None = None) -> None:
        """Local rewrites changed graph bodies: recursion facts may be
        stale (a rewrite can cut — or add — a graph reference), so drop
        everything derived from them; the family set only ever grows into
        a sound superset and survives.  When the rewriter can name the
        graphs whose bodies actually changed (``dirty``), per-graph body
        facts survive for every clean graph — the next facts pass is then
        a dict-lookup sweep instead of a full node walk."""
        if dirty is None:
            self._rec.clear()
            self._safe.clear()
            self._facts = False
            self._desc.clear()
            self._clonefam.clear()
            self._bodyfacts.clear()
            return
        # refresh the touched graphs' body facts eagerly: when none of
        # their graph-reference sets changed (the common case for local
        # rules), the reference digraph — and with it every recursion /
        # safety / topo fact — is untouched and survives the epoch
        refs_changed = False
        for g in dirty:
            old = self._bodyfacts.pop(g, None)
            new = self._bodyfacts[g] = _graph_body_facts(g)
            if old is None or old[0] != new[0]:
                refs_changed = True
        if refs_changed:
            self._rec.clear()
            self._safe.clear()
            self._facts = False
        stale = [g for g, d in self._desc.items() if d & dirty]
        for g in stale:
            del self._desc[g]
        stale_cf = [g for g, (fam, _) in self._clonefam.items() if fam & dirty]
        for g in stale_cf:
            del self._clonefam[g]


# ---------------------------------------------------------------------------
# Cloning
# ---------------------------------------------------------------------------


class GraphCloner:
    """Clone a graph family, remapping internal references.

    ``inline_target``: if given, nodes of the root graph are created inside
    that graph instead of a fresh one (used by the inliner), and parameters
    are replaced by ``param_map`` values.

    ``family``: if given, only these graphs are deep-copied; references to
    the rest of the root's family are kept pointing at the shared
    originals.  Callers must pass a set that is sound to share — the
    inliner uses :func:`_clone_needed` (closed sub-families evaluate
    identically in original and clone, so one shared copy suffices).
    Defaults to the whole family (full deep copy).
    """

    def __init__(
        self,
        root: Graph,
        *,
        inline_target: Graph | None = None,
        param_repl: dict[Node, Node] | None = None,
        relabel: str = "",
        family: set[Graph] | None = None,
    ) -> None:
        self.root = root
        self.inline_target = inline_target
        self.param_repl = param_repl or {}
        self.relabel = relabel
        self.node_map: dict[int, Node] = {}
        self.graph_map: dict[Graph, Graph] = {}
        self.family = set(family) if family is not None else graph_and_descendants(root)

    def clone(self) -> Graph:
        new_root = self._clone_graph_shell(self.root, inline=self.inline_target)
        for g in self.family:
            if g is self.root and self.inline_target is not None:
                continue
            self._clone_graph_shell(g)
        # clone bodies
        for g in self.family:
            tgt = self.graph_map[g]
            new_ret = self._clone_node(g.return_, g)
            if not (g is self.root and self.inline_target is not None):
                tgt.set_return(new_ret)
            else:
                # inline: stash the return value for the caller to fetch
                self.inlined_return = new_ret
        self._remap_symbolic_keys()
        return new_root

    def _remap_symbolic_keys(self) -> None:
        """Symbolic keys referencing cloned nodes must point at the clones,
        or gradient environments written by a cloned adjoint would not match
        the keys used by its (also cloned) unpackers."""
        from .values import SymbolicKey

        for new in self.node_map.values():
            if isinstance(new, Constant) and isinstance(new.value, SymbolicKey):
                target = self.node_map.get(new.value.node._id)
                if target is not None:
                    new.value = SymbolicKey(target)

    def _clone_graph_shell(self, g: Graph, inline: Graph | None = None) -> Graph:
        if g in self.graph_map:
            return self.graph_map[g]
        if inline is not None:
            self.graph_map[g] = inline
            for p in g.parameters:
                self.node_map[p._id] = self.param_repl[p]
            return inline
        ng = Graph(g.name + self.relabel)
        ng.flags = dict(g.flags)
        ng.primal = g.primal
        ng.parent_hint = g.parent_hint
        self.graph_map[g] = ng
        for p in g.parameters:
            np_ = ng.add_parameter(p.debug_name)
            np_.abstract = p.abstract
            self.node_map[p._id] = np_
        return ng

    def _clone_node(self, node: Node, owner: Graph) -> Node:
        """Iterative post-order clone (deep graphs must not hit the Python
        recursion limit)."""
        if node._id in self.node_map:
            return self.node_map[node._id]
        stack: list[tuple[Node, bool]] = [(node, False)]
        while stack:
            cur, ready = stack.pop()
            if cur._id in self.node_map:
                continue
            if isinstance(cur, Constant):
                if isinstance(cur.value, Graph) and cur.value in self.family:
                    new = Constant(self.graph_map[cur.value], cur.debug_name)
                else:
                    new = Constant(self.value_clone(cur.value), cur.debug_name)
                new.abstract = cur.abstract
                self.node_map[cur._id] = new
                continue
            if isinstance(cur, Parameter):
                # parameter of a graph outside the family: free variable
                self.node_map[cur._id] = cur
                continue
            assert isinstance(cur, Apply)
            if cur.graph not in self.family:
                # apply owned by an enclosing graph: free variable — keep
                self.node_map[cur._id] = cur
                continue
            if ready:
                new_inputs = [self.node_map[i._id] for i in cur.inputs]
                new = Apply(new_inputs, self.graph_map[cur.graph], cur.debug_name)
                new.abstract = cur.abstract
                self.node_map[cur._id] = new
            else:
                stack.append((cur, True))
                for i in cur.inputs:
                    if i._id not in self.node_map:
                        stack.append((i, False))
        return self.node_map[node._id]

    def value_clone(self, value: Any) -> Any:
        """Hook: values that must be remapped on clone (e.g. symbolic env
        keys referencing nodes) override this via subclassing in ad.py."""
        return value


def clone_graph(graph: Graph, relabel: str = "") -> Graph:
    return GraphCloner(graph, relabel=relabel).clone()
