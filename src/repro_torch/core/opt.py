"""Ahead-of-time optimization of IR graphs (paper §4.3).

The AD transform produces graphs "substantially larger than the original
source … many computations that are not necessary, such as gradients with
respect to constants, and a lot of tuple packing and unpacking.  These
graphs can be simplified using inlining and local optimizations."  (paper
§4.3 / Figure 1.)  This module implements exactly that:

* **inlining** of non-recursive graphs called through constants,
* **local rules**: tuple getitem/setitem cancellation, gradient-environment
  cancellation (``env_getitem(env_setitem(e,k,v),k,d) → v`` — this is what
  erases the Env machinery from first-order adjoints), switch-of-constant,
  algebraic simplification, constant folding, ``gadd``-with-zero removal,
* **shape-directed rules** using inferred abstracts (``shape(x) → const``,
  ``unbroadcast(d, shp) → d`` when shapes already agree) — these complete
  the Figure-1 collapse of the adjoint of ``x ** 3`` to ``3·x²``.

Dead code needs no explicit pass: execution and node counts only ever
follow edges from the return node, so orphaned computation simply vanishes
(the VM is demand-driven; ``reachable_nodes`` is the metric).

Rewriting engines
-----------------
Two engines drive the local rules to their fixed point:

* ``engine="worklist"`` (default): users-edge-driven.  Every reachable
  node is seeded once; each ``replace(old, new)`` re-enqueues only ``new``,
  its users (one and two levels — rules inspect at most grandchildren), and
  the users of the replaced node's inputs.  Local rules therefore converge
  in near-linear time instead of O(sweeps × family-size).  When the
  worklist drains, one full verification sweep confirms the fixed point
  (any stragglers — there should be none — are processed and the drain
  repeats), so both engines always reach the same normal form.
* ``engine="sweep"``: the reference fixed-point implementation — repeated
  whole-family DFS sweeps until a sweep finds nothing.  Kept as the
  equivalence oracle for tests and debugging.

``optimize(..., stats=OptStats())`` fills a per-rule hit counter plus
worklist/inline counters, so benchmarks can record *why* a graph shrank.

Compile-time scalability
------------------------
Reverse-over-reverse families are large (thousands of nodes, hundreds of
graphs), so the optimizer's asymptotics — not the backend — used to dominate
cold pipeline latency (`BENCH_higher_order.json` recorded ~9.4 s of a
9.6 s grad²-MLP pipeline inside `optimize`).  The structures that keep
it near-linear now:

* ``ir.FamilyIndex`` memoizes per-graph body facts, Tarjan-SCC
  recursion/inline-safety facts and clone-family scopes, invalidated
  *scoped to the graphs a rewrite actually touched*
  (``invalidate_rewrites(dirty=...)``) instead of wholesale;
* inline waves clone **only the open sub-family** of a callee
  (``share_closed``: closed descendant graphs are shared, not copied)
  and order sites deepest-first so shared callees are simplified once,
  pre-clone (``_simplify_callee``), not re-discovered per copy;
* the family-recursion gate on value-based partial evaluation is
  *sticky* (``_norec``): rewrites only cut graph-reference edges, so an
  acyclic family can never become cyclic again within a run — without
  this, every edge-cutting rewrite forced a fresh facts pass;
* ``replace`` retargets returns through an incrementally-maintained
  return-node index instead of scanning the family per rewrite.

The remaining cold cost is cacheable wholesale: the reference's
optimized-graph cache tier keys the *pre-opt* graph via the loose
structural hash (``serialize.structural_hash(g, loose=True)``) and skips
this module entirely on a warm hit, and so does the port's
(``torch_backend.ProgramCache.graph_key``).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable

import numpy as np

from repro_torch.obs import trace as obs_trace

from . import primitives as P
from .ir import (
    Apply,
    Constant,
    FamilyIndex,
    Graph,
    GraphCloner,
    Node,
    dfs_nodes,
    is_apply,
    is_constant_graph,
)
from .infer import AArray, AFunction, AScalar, ATuple  # noqa: F401 (ATuple used in folding)
from .primitives import COLLECTIVE_NAMES, Primitive
from .values import EnvInstance, newenv

#: primitives excluded from value-based partial evaluation (environment
#: plumbing must survive until closure elimination rewires it) —
#: prebuilt: try_rules runs per worklist pop, so even tuple construction
#: in its prologue shows up on grad² profiles
_ENV_PRIMS = frozenset((P.env_setitem, P.env_getitem))

__all__ = ["optimize", "reachable_nodes", "count_nodes", "OptStats"]


def reachable_nodes(graph: Graph) -> list[Node]:
    return list(dfs_nodes(graph.return_))


def count_nodes(graph: Graph) -> int:
    return len(reachable_nodes(graph))


# ---------------------------------------------------------------------------
# Rewriting machinery
# ---------------------------------------------------------------------------


class OptStats:
    """Counters from one ``optimize`` run (pass ``optimize(..., stats=s)``).

    * ``rule_hits`` — rewrites applied, per rule name,
    * ``inlined_calls`` / ``inline_waves`` — inliner activity,
    * ``worklist_pops`` — nodes examined by the worklist engine,
    * ``verify_sweep_hits`` — rewrites found only by the post-drain
      verification sweep (should stay 0: nonzero means the enqueue locality
      missed a rule dependency and the engine fell back to sweeping),
    * ``iterations`` — outer inline+rules iterations until fixpoint,
    * ``fallback_reasons`` — structured reasons the final pipeline graph
      still cannot lower (``FallbackReason.as_dict()`` entries, filled by
      ``api.compile_pipeline``; empty means the graph compiles VM-free).
    """

    __slots__ = (
        "rule_hits",
        "inlined_calls",
        "inline_waves",
        "worklist_pops",
        "verify_sweep_hits",
        "iterations",
        "fallback_reasons",
    )

    def __init__(self) -> None:
        self.rule_hits: dict[str, int] = {}
        self.inlined_calls = 0
        self.inline_waves = 0
        self.worklist_pops = 0
        self.verify_sweep_hits = 0
        self.iterations = 0
        self.fallback_reasons: list[dict] = []

    def record_rule(self, name: str) -> None:
        self.rule_hits[name] = self.rule_hits.get(name, 0) + 1

    @property
    def total_rewrites(self) -> int:
        return sum(self.rule_hits.values())

    def as_dict(self) -> dict:
        return {
            "rule_hits": dict(sorted(self.rule_hits.items())),
            "total_rewrites": self.total_rewrites,
            "inlined_calls": self.inlined_calls,
            "inline_waves": self.inline_waves,
            "worklist_pops": self.worklist_pops,
            "verify_sweep_hits": self.verify_sweep_hits,
            "iterations": self.iterations,
            "fallback_reasons": list(self.fallback_reasons),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"OptStats({self.as_dict()!r})"


class _Rewriter:
    def __init__(
        self,
        root: Graph,
        max_inline_size: int | None,
        stats: OptStats | None = None,
        patterns: bool = False,
    ) -> None:
        self.root = root
        self.max_inline_size = max_inline_size
        self.changed = False
        self.patterns = patterns
        self.stats = stats if stats is not None else OptStats()
        self.fam = FamilyIndex(root)
        #: enqueue hook, live only while the worklist engine drains
        self._push: Callable[[Node], None] | None = None
        #: ids of the family's return nodes, maintained while the worklist
        #: engine runs (a userless node that is no graph's return is dead)
        self._returns: set[int] | None = None
        #: return-node id -> graphs whose return_ it is.  ``replace`` used
        #: to scan the whole family per rewrite to retarget returns —
        #: O(rewrites × family), one of the superlinear optimizer costs.
        #: Lazily built, incrementally maintained (replace / inline
        #: clones), dropped when the family index is rebuilt wholesale.
        self._ret_index: dict[int, set[Graph]] | None = None
        #: graphs whose bodies changed since the last facts invalidation —
        #: lets FamilyIndex.invalidate_rewrites keep per-graph body facts
        #: for every untouched graph instead of re-walking the world
        self._dirty: set[Graph] = set()
        #: sticky "family proved non-recursive": no local rule can mint a
        #: graph constant (partial evaluation folds scalars/tuples only)
        #: and inline clones of safe callees are themselves safe, so the
        #: graph-reference digraph only ever LOSES edges during a run —
        #: once acyclic, acyclic forever.  Caching that answer keeps
        #: try_rules from re-running the Tarjan facts pass after every
        #: edge-cutting rewrite (measured: ~650 full passes per grad²
        #: pipeline without it).
        self._norec = False

    # -- helpers -----------------------------------------------------------
    def family(self) -> set[Graph]:
        # incrementally maintained: inline clones extend it (note_clone);
        # local rewrites can orphan graphs, but scanning an orphan is merely
        # wasted work, never unsound.
        return self.fam.graphs()

    def _return_index(self) -> dict[int, set[Graph]]:
        idx = self._ret_index
        if idx is None:
            idx = self._ret_index = {}
            for g in self.family():
                if g.return_ is not None:
                    idx.setdefault(g.return_._id, set()).add(g)
        return idx

    def replace(self, old: Node, new: Node) -> None:
        dirty = self._dirty
        if isinstance(new, Apply) and new.graph is not None:
            dirty.add(new.graph)
        elif isinstance(old, Apply) and old.graph is not None:
            dirty.add(old.graph)
        for user, idx in list(old.users):
            user.set_input(idx, new)
            if user.graph is not None:
                dirty.add(user.graph)
        ridx = self._return_index()
        owners = ridx.pop(old._id, None)
        if owners:
            for g in owners:
                if g.return_ is old:
                    g.set_return(new)
                    dirty.add(g)
                    ridx.setdefault(new._id, set()).add(g)
                    if self._returns is not None:
                        self._returns.discard(old._id)
                        self._returns.add(new._id)
        self.changed = True
        if isinstance(old, Apply):
            # the replaced node is gone: sever its input edges so its former
            # inputs' users sets stay live-only (this is what lets the
            # worklist engine recognise — and skip — orphaned subtrees)
            for i, inp in enumerate(old.inputs):
                inp.users.discard((old, i))
        push = self._push
        if push is not None:
            # users-edge-driven requeue: the replacement may itself match a
            # rule; its users (= the replaced node's former users, rewired
            # above) consume the new value; rules look through one level of
            # inputs (make_tuple/setitem/cast chains), so refresh two levels
            # of users; and the replaced node's inputs lost a user.
            push(new)
            if isinstance(new, Apply):
                # distribute-style rules build fresh child applies under the
                # replacement (zeros_like/gadd over tuple elements) — each
                # child may itself match a rule, so it must be seeded
                for inp in new.inputs:
                    push(inp)
            for user, _ in list(new.users):
                push(user)
                for uu, _ in list(user.users):
                    push(uu)
            if isinstance(old, Apply):
                for inp in old.inputs:
                    for user, _ in list(inp.users):
                        push(user)

    def _family_has_recursion(self) -> bool:
        """Value-based partial evaluation is gated on this: the inferencer's
        value inference is frame-insensitive for closures (AFunction joins
        dedup closure specs by graph), so in RECURSIVE families an interior
        node can be annotated with a base-case frame's value — folding it
        would be unsound.  Non-recursive families keep full constant
        propagation (the Figure-1 collapse).  The negative answer is
        sticky (``_norec``): rewrites only cut reference edges, so a
        family that went acyclic can never become cyclic again this run."""
        if self._norec:
            return False
        rec = not self.fam.inline_safe(self.root)
        if not rec:
            self._norec = True
        return rec

    def _simplify_callee(self, callee: Graph, simplified: set[Graph]) -> None:
        """Drain local rules over ``callee``'s family before the inliner
        clones it: a rewrite applied once pre-clone would otherwise be
        re-discovered (and the nodes it deletes re-copied) in every
        call-site copy.  Seeds only family members not yet drained this
        pass (``simplified`` — deepest-first site ordering means shared
        descendants are already in normal form when their callers arrive).
        Uses the same worklist machinery as ``_rules_worklist`` minus the
        verification sweep — the global pass that follows still certifies
        the fixed point."""
        members = sorted(
            (h for h in self.fam.descendants(callee) if h not in simplified),
            key=lambda h: h._id,
        )
        simplified.update(members)
        if not members:
            return
        work: deque[Apply] = deque()
        queued: set[int] = set()

        def push(node: Node) -> None:
            if isinstance(node, Apply) and id(node) not in queued:
                queued.add(id(node))
                work.append(node)

        prev_push, prev_returns = self._push, self._returns
        self._push = push
        self._returns = set(self._return_index().keys())
        dirty0 = set(self._dirty)
        try:
            seen: set[int] = set()
            for h in members:
                if h.return_ is None:
                    continue
                stack: list[Node] = [h.return_]
                while stack:
                    n = stack.pop()
                    if id(n) in seen:
                        continue
                    seen.add(id(n))
                    if isinstance(n, Apply):
                        push(n)
                        stack.extend(n._inputs)
            while work:
                n = work.popleft()
                queued.discard(id(n))
                if n.graph is None:
                    continue
                if not n.users and n._id not in self._returns:
                    for i, inp in enumerate(n.inputs):
                        inp.users.discard((n, i))
                        push(inp)
                    continue
                self.stats.worklist_pops += 1
                hit = self.try_rules(n)
                if hit is not None:
                    new, rule = hit
                    self.stats.record_rule(rule)
                    self.replace(n, new)
        finally:
            self._push = prev_push
            self._returns = prev_returns
        touched = self._dirty - dirty0
        if touched:
            # body facts / clone-family entries derived from the rewritten
            # graphs are stale NOW (the wave is still running), not at the
            # next iteration boundary — scope-invalidate immediately
            self.fam.invalidate_rewrites(dirty=touched)

    # -- inlining -----------------------------------------------------------
    def inline_pass(self, max_waves: int = 64) -> bool:
        """Wave-based inlining: one dfs collects every eligible call site,
        all are inlined, repeat until a wave finds none.

        Inlining a non-recursive callee cannot create a cycle among
        pre-existing graphs (clones only *reference* clones), so the
        recursion facts cached in the family index stay valid across waves;
        only the family set and stale descendant entries are updated, per
        clone (``FamilyIndex.note_clone``)."""
        changed = False
        # pre-clone simplification memo: a callee drained once stays
        # drained for the whole pass (later waves may touch its family,
        # making the skip merely less effective, never unsound — the
        # global rules pass still certifies the normal form)
        simplified: set[Graph] = set()
        for wave in range(max_waves):
            # one span per wave: at trace level the "clone storms" of the
            # superlinear compile-time item become directly visible as
            # wide opt.inline_wave spans with large `inlined` counts
            with obs_trace.span("opt.inline_wave", wave=wave) as sp:
                fam = self.family()
                targets: list[Apply] = []
                for n in dfs_nodes(self.root.return_):
                    if (
                        isinstance(n, Apply)
                        and n.graph in fam
                        and is_constant_graph(n.fn)
                        and n.fn.value is not n.graph
                        and self.fam.inline_safe(n.fn.value)
                    ):
                        callee = n.fn.value
                        if callee.return_ is None:
                            continue
                        if (
                            self.max_inline_size is not None
                            and count_nodes(callee) > self.max_inline_size
                        ):
                            continue
                        if len(callee.parameters) != len(n.args):
                            continue  # arity error: leave for runtime
                        targets.append(n)
                if not targets:
                    sp.set(inlined=0)
                    return changed
                # deepest callees first: a callee's OWN call sites are
                # inlined before any caller clones it, so bodies are
                # cloned flat — without this ordering a call nested k
                # levels deep is re-cloned once per wave level
                targets.sort(key=lambda t: self.fam.topo_pos(t.graph))
                self.stats.inline_waves += 1
                inlined = 0
                for n in targets:
                    if not is_constant_graph(n.fn):
                        continue  # rewritten by an earlier inline this wave
                    if not n.users and n.graph.return_ is not n:
                        continue  # orphaned by a pre-clone simplification
                    callee = n.fn.value
                    if callee not in simplified:
                        self._simplify_callee(callee, simplified)
                    if not is_constant_graph(n.fn):
                        continue
                    callee = n.fn.value
                    param_repl = dict(zip(callee.parameters, n.args))
                    cloner = GraphCloner(
                        callee,
                        inline_target=n.graph,
                        param_repl=param_repl,
                        # closed sub-families are shared, not re-copied per
                        # call site (the "clone storm" fix); the analysis
                        # is memoized per callee on the family index
                        family=self.fam.clone_family(callee),
                    )
                    cloner.clone()  # (remaps symbolic env keys internally)
                    self.replace(n, cloner.inlined_return)
                    self.fam.note_clone(cloner)
                    if self._ret_index is not None:
                        for ng in cloner.graph_map.values():
                            if ng is not n.graph and ng.return_ is not None:
                                self._ret_index.setdefault(
                                    ng.return_._id, set()
                                ).add(ng)
                    self.stats.inlined_calls += 1
                    inlined += 1
                    changed = True
                    self.changed = True
                sp.set(targets=len(targets), inlined=inlined)
        return changed

    # -- local rules ----------------------------------------------------------
    def rules_pass(self, engine: str = "worklist") -> bool:
        if engine not in ("sweep", "worklist"):
            raise ValueError(f"unknown rewrite engine {engine!r}")
        # the per-rule-class breakdown rides on the span as a hit-count
        # delta (rule spans per worklist pop would swamp the buffer AND
        # the hot path; the drain-level delta costs two dict copies,
        # armed-only)
        sp = obs_trace.span("opt.rules", engine=engine)
        before = dict(self.stats.rule_hits) if sp is not obs_trace.NULL_SPAN else None
        pops0 = self.stats.worklist_pops
        with sp:
            changed = (
                self._rules_sweep() if engine == "sweep" else self._rules_worklist()
            )
            if before is not None:
                delta = {
                    k: v - before.get(k, 0)
                    for k, v in self.stats.rule_hits.items()
                    if v != before.get(k, 0)
                }
                sp.set(
                    rewrites=sum(delta.values()),
                    pops=self.stats.worklist_pops - pops0,
                    rule_hits=delta,
                )
        return changed

    def _rules_sweep(self) -> bool:
        """Reference engine: whole-family DFS sweeps to a fixed point."""
        changed = False
        work = True
        while work:
            work = False
            for n in list(dfs_nodes(self.root.return_)):
                if not (isinstance(n, Apply) and n.graph is not None):
                    continue
                hit = self.try_rules(n)
                if hit is not None:
                    new, rule = hit
                    self.stats.record_rule(rule)
                    self.replace(n, new)
                    work = True
                    changed = True
        return changed

    def _rules_worklist(self) -> bool:
        """Worklist engine: seed every reachable node once, then follow
        users edges — each replacement requeues only its local neighborhood
        (see ``replace``), and subtrees orphaned by a rewrite are skipped
        (userless non-return nodes cannot affect the program).  A final
        verification sweep certifies the fixed point — any straggler it
        finds is rewritten on the spot and the drain repeats — so this
        engine and the sweep reference agree on normal forms."""
        changed = False
        work: deque[Apply] = deque()
        queued: set[int] = set()

        def push(node: Node) -> None:
            if isinstance(node, Apply) and id(node) not in queued:
                queued.add(id(node))
                work.append(node)

        self._push = push
        self._returns = {
            g.return_._id for g in self.family() if g.return_ is not None
        }
        try:
            for n in dfs_nodes(self.root.return_):
                push(n)
            while True:
                while work:
                    n = work.popleft()
                    queued.discard(id(n))
                    if n.graph is None:
                        continue
                    if not n.users and n._id not in self._returns:
                        # dead or orphaned: cannot affect the program.  Sever
                        # its input edges and requeue the inputs — orphan
                        # subtrees disconnect (and get skipped) transitively,
                        # mirroring how a sweep's dfs never visits them.
                        for i, inp in enumerate(n.inputs):
                            inp.users.discard((n, i))
                            push(inp)
                        continue
                    self.stats.worklist_pops += 1
                    hit = self.try_rules(n)
                    if hit is not None:
                        new, rule = hit
                        self.stats.record_rule(rule)
                        self.replace(n, new)
                        changed = True
                # verification sweep: certify the fixed point (a hit here
                # means a rule dependency the requeue policy missed — apply
                # it directly and drain the consequences)
                stragglers = 0
                for n in list(dfs_nodes(self.root.return_)):
                    if not (isinstance(n, Apply) and n.graph is not None):
                        continue
                    hit = self.try_rules(n)
                    if hit is not None:
                        new, rule = hit
                        self.stats.record_rule(rule)
                        self.replace(n, new)
                        changed = True
                        stragglers += 1
                if not stragglers:
                    break
                self.stats.verify_sweep_hits += stragglers
        finally:
            self._push = None
            self._returns = None
        return changed

    def try_rules(self, n: Apply) -> tuple[Node, str] | None:
        fn = n.fn
        if not (isinstance(fn, Constant) and isinstance(fn.value, Primitive)):
            return None
        p: Primitive = fn.value
        a = n.args

        # sharding boundary: collectives communicate across shards — no
        # local rule may fold, fold through, or eliminate one (their value
        # is NOT a function of their per-shard inputs alone)
        if p.name in COLLECTIVE_NAMES:
            return None

        # partial evaluation: the inferencer proved the value (paper §4.2,
        # "It can infer types as well as values (constant propagation)").
        # Gated off in recursive families — see _family_has_recursion.
        if p not in _ENV_PRIMS and not self._family_has_recursion():
            known = _known_abstract_value(n.abstract)
            if known is not _NO_VALUE:
                return Constant(known), "partial_eval"

        if p is P.tuple_getitem and len(a) == 2 and isinstance(a[1], Constant):
            idx = a[1].value
            src = a[0]
            if is_apply(src, P.make_tuple):
                if not (isinstance(idx, int) and -len(src.args) <= idx < len(src.args)):
                    return None  # stale/dead node from the pass snapshot
                return src.args[idx], "getitem_of_make_tuple"
            if is_apply(src, P.tuple_setitem) and isinstance(src.args[1], Constant):
                if src.args[1].value == idx:
                    return src.args[2], "getitem_of_setitem_hit"
                return (
                    n.graph.apply(P.tuple_getitem, src.args[0], idx),
                    "getitem_of_setitem_skip",
                )
            if isinstance(src, Constant) and isinstance(src.value, tuple):
                return Constant(src.value[idx]), "getitem_of_const"

        if p is P.env_getitem and len(a) == 3:
            env, key, dflt = a
            if isinstance(key, Constant):
                if is_apply(env, P.env_setitem) and isinstance(env.args[1], Constant):
                    if env.args[1].value == key.value:
                        return env.args[2], "env_getitem_of_setitem_hit"
                    return (
                        n.graph.apply(P.env_getitem, env.args[0], key, dflt),
                        "env_getitem_of_setitem_skip",
                    )
                if isinstance(env, Constant) and isinstance(env.value, EnvInstance):
                    if len(env.value) == 0:
                        return dflt, "env_getitem_empty"

        if p is P.switch and len(a) == 3 and isinstance(a[0], Constant):
            if a[0].value is True:
                return a[1], "switch_const"
            if a[0].value is False:
                return a[2], "switch_const"

        if p is P.gadd and len(a) == 2:
            for i, j in ((0, 1), (1, 0)):
                z = a[i]
                if isinstance(z, Constant) and (
                    z.value is None
                    or (isinstance(z.value, (int, float)) and z.value == 0)
                    or (isinstance(z.value, EnvInstance) and len(z.value) == 0)
                ):
                    return a[j], "gadd_zero"
                if is_apply(z, P.zeros_like) and _gadd_zero_drop_safe(z, a[j]):
                    return a[j], "gadd_zero"
            # distribute over tuples: gadd is elementwise on same-length
            # tuples (values.gadd_values), so pairing the elements lets the
            # per-element zero/closure rules fire where a whole-tuple match
            # could not (the closure-elimination tier's workhorse)
            lhs, rhs = a
            le = _tuple_elements(lhs)
            re_ = _tuple_elements(rhs)
            if le is not None and re_ is not None and len(le) == len(re_):
                g = n.graph
                items = [g.apply(P.gadd, x, y) for x, y in zip(le, re_)]
                return g.apply(P.make_tuple, *items), "gadd_tuple_distribute"

        # closure elimination (paper §3.2 / §4.3): the sensitivity of a
        # function value is an (empty) gradient environment, and zeros of a
        # tuple distribute — these erase the residual ◀-closure plumbing
        # from reverse-over-reverse adjoints so they lower without the VM
        if p is P.zeros_like and len(a) == 1:
            z = a[0]
            if isinstance(z, Constant) and isinstance(z.value, (Graph, Primitive)):
                return Constant(newenv), "zeros_of_function"
            if isinstance(z, Constant) and isinstance(z.value, EnvInstance):
                return Constant(newenv), "zeros_of_function"
            if isinstance(z.abstract, AFunction):
                return Constant(newenv), "zeros_of_function"
            if is_apply(z, P.zeros_like):
                return z, "zeros_idempotent"
            elts = _tuple_elements(z)
            if elts is not None:
                g = n.graph
                items = [g.apply(P.zeros_like, x) for x in elts]
                return g.apply(P.make_tuple, *items), "zeros_tuple_distribute"

        # algebraic: x+0, x-0, x*1, x/1, --x  (scalar literal identities only:
        # they cannot change the broadcast shape of the result)
        if p in (P.add, P.sub) and len(a) == 2:
            if _is_scalar_const(a[1], 0):
                return a[0], "add_zero"
            if p is P.add and _is_scalar_const(a[0], 0):
                return a[1], "add_zero"
        if p in (P.mul, P.div) and len(a) == 2:
            if _is_scalar_const(a[1], 1):
                return a[0], "mul_one"
            if p is P.mul and _is_scalar_const(a[0], 1):
                return a[1], "mul_one"
        if p in (P.power, P.integer_pow) and len(a) == 2 and _is_scalar_const(a[1], 1):
            return a[0], "pow_one"
        if p is P.neg and is_apply(a[0], P.neg):
            return a[0].args[0], "neg_neg"

        # shape-directed rules (need inferred abstracts)
        if p is P.shape and len(a) == 1:
            ab = a[0].abstract
            if isinstance(ab, AArray):
                return Constant(tuple(ab.shape)), "shape_const"
            if isinstance(ab, AScalar) and ab.kind in ("int", "float", "bool"):
                return Constant(()), "shape_const"
        if p is P.dtype_of and len(a) == 1:
            ab = a[0].abstract
            if isinstance(ab, AArray):
                return Constant(ab.dtype), "dtype_const"
        if p in (P.unbroadcast, P.broadcast_to) and len(a) == 2 and isinstance(a[1], Constant):
            ab = a[0].abstract
            if isinstance(ab, AArray) and tuple(ab.shape) == tuple(a[1].value):
                return a[0], "broadcast_noop"
            if (
                isinstance(ab, AScalar)
                and ab.kind in ("int", "float")
                and tuple(a[1].value) == ()
            ):
                return a[0], "broadcast_noop"
        if p is P.cast and len(a) == 2 and isinstance(a[1], Constant):
            ab = a[0].abstract
            if isinstance(ab, AArray) and ab.dtype == np.dtype(a[1].value):
                return a[0], "cast_noop"
        if p is P.reshape and len(a) == 2 and isinstance(a[1], Constant):
            ab = a[0].abstract
            if isinstance(ab, AArray) and tuple(ab.shape) == tuple(a[1].value):
                return a[0], "reshape_noop"

        # constant folding (pure, cheap prims on python scalars/tuples;
        # results may be tiny arrays, e.g. cast(1.0, f32))
        if p in _FOLDABLE and all(isinstance(x, Constant) for x in a):
            vals = [x.value for x in a]
            if all(_foldable_value(v) for v in vals):
                try:
                    res = p.impl(*vals)
                except Exception:
                    return None
                if _foldable_value(res) or _tiny_array(res):
                    return Constant(res), "const_fold"

        # kernel-pattern rules (fusion tier only): rewrite kernel-shaped
        # subgraphs to the hand-written kernel primitives
        if self.patterns:
            hit = _try_kernel_patterns(n, p)
            if hit is not None:
                return hit
        return None


def _gadd_zero_drop_safe(z: Node, other: Node) -> bool:
    """Dropping the zero operand of a gadd is only shape-preserving when
    the zeros cannot broadcast-extend the other side: ``gadd(scalar,
    zeros_like(arr))`` has the ARRAY's shape, so erasing the zeros would
    change the result.  Array-shaped zeros may go only when the other
    operand provably has (at least) the same shape; with no inferred
    abstracts we keep the legacy permissive behavior (the structural pass
    runs before inference, and pre-seed-fix graphs never mixed shapes)."""
    za = z.abstract
    if za is None or isinstance(za, (AScalar, ATuple)):
        return True
    if isinstance(za, AArray):
        oa = other.abstract
        if isinstance(oa, AArray):
            try:
                return tuple(np.broadcast_shapes(za.shape, oa.shape)) == tuple(oa.shape)
            except ValueError:
                return False
        return False  # other side scalar/unknown: zeros would extend it
    return True  # env/function zeros: structural, never shape-bearing


def _tuple_elements(node: Node) -> list[Node] | None:
    """Element nodes of a syntactic tuple: a ``make_tuple`` apply, a
    tuple-valued constant (elements wrapped as fresh Constants), or a
    constant-index ``tuple_setitem`` over one of those (the shape
    ``_bprop_tuple_getitem`` emits — resolved so gadd/zeros distribution
    reaches the real elements)."""
    if is_apply(node, P.make_tuple):
        return list(node.args)
    if isinstance(node, Constant) and isinstance(node.value, tuple):
        return [Constant(v) for v in node.value]
    if (
        is_apply(node, P.tuple_setitem)
        and len(node.args) == 3
        and isinstance(node.args[1], Constant)
        and isinstance(node.args[1].value, int)
    ):
        base = _tuple_elements(node.args[0])
        idx = node.args[1].value
        if base is not None and 0 <= idx < len(base):
            base[idx] = node.args[2]
            return base
    return None


_NO_VALUE = object()


def _known_abstract_value(ab: Any) -> Any:
    """Extract a fully-known python value from an inferred abstract."""
    if isinstance(ab, AScalar) and ab.known() and ab.kind in (
        "int", "float", "bool", "str", "none", "dtype"
    ):
        return ab.value
    if isinstance(ab, ATuple):
        vals = []
        for e in ab.elements:
            v = _known_abstract_value(e)
            if v is _NO_VALUE:
                return _NO_VALUE
            vals.append(v)
        return tuple(vals)
    return _NO_VALUE


def _tiny_array(v: Any) -> bool:
    if hasattr(v, "numel"):  # a tensor (its ``size`` is a method)
        return v.numel() <= 16
    return hasattr(v, "shape") and hasattr(v, "size") and v.size <= 16


def _is_scalar_const(node: Node, val: float) -> bool:
    """Literal scalar ``val``, possibly behind a cast (``cast(1.0, dt)``) or
    as a 0-d array constant — identities that cannot change broadcasting."""
    if is_apply(node, P.cast) and len(node.args) == 2:
        return _is_scalar_const(node.args[0], val)
    if not isinstance(node, Constant):
        return False
    v = node.value
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v == val
    if _tiny_array(v) and getattr(v, "ndim", None) == 0:
        try:
            return float(v) == val
        except Exception:
            return False
    return False


def _foldable_value(v: Any) -> bool:
    if isinstance(v, (int, float, bool, str, np.dtype)) or v is None:
        return True
    if isinstance(v, tuple):
        return all(_foldable_value(x) for x in v)
    return False


_FOLDABLE = {
    P.add, P.sub, P.mul, P.div, P.floordiv, P.mod, P.neg, P.power,
    P.lt, P.gt, P.le, P.ge, P.eq, P.ne, P.bool_and, P.bool_or, P.bool_not,
    P.maximum, P.minimum, P.tuple_getitem, P.tuple_setitem, P.tuple_len,
    P.make_tuple, P.invert_permutation, P.axes_size, P.absolute, P.cast,
    P.dtype_of, P.integer_pow,
}


# ---------------------------------------------------------------------------
# Kernel-pattern rules (fusion tier, paper §3: "write efficient low-level
# kernels … and expose them to Myia as primitives").  These recognize the
# canonical user-level spellings of rmsnorm and the softmax-attention core
# and rewrite the whole subgraph to ONE call of the corresponding
# hand-written kernel primitive from ``repro_torch.kernels.ops`` — which carries
# its own backpropagator, so ``grad`` of a rewritten graph runs the
# kernel's backward instead of the unrolled adjoint chain.
# ---------------------------------------------------------------------------


def _ashape(node: Node) -> tuple[int, ...] | None:
    ab = node.abstract
    return ab.shape if isinstance(ab, AArray) else None


def _scalar_const_value(node: Node) -> float | None:
    if isinstance(node, Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return float(node.value)
    return None


def _is_last_axis_reduce(n: Apply, prim: Primitive) -> Node | None:
    """``prim(x, (last_axis,), True)`` → x, else None."""
    if not is_apply(n, prim) or len(n.args) != 3:
        return None
    x, axes, keep = n.args
    nd_shape = _ashape(x)
    if nd_shape is None or not isinstance(axes, Constant) or not isinstance(keep, Constant):
        return None
    if keep.value is not True:
        return None
    ax = axes.value
    if isinstance(ax, int):
        ax = (ax,)
    if not isinstance(ax, tuple):
        return None
    nd = len(nd_shape)
    if tuple(a % nd for a in ax) != (nd - 1,):
        return None
    return x


def _commuted(n: Node, prim: Primitive):
    """Yield both operand orders of a binary apply of ``prim``."""
    if is_apply(n, prim) and len(n.args) == 2:
        a, b = n.args
        yield a, b
        yield b, a


def _match_rmsnorm(n: Apply):
    """``mul(mul(x, rsqrt(mean(x²) + eps)), w)`` (any commutation; mean
    spelled ``reduce_sum(x*x, (last,), True) / D``) → ``rmsnorm(x, w, eps)``."""
    for u, w in _commuted(n, P.mul):
        w_shape = _ashape(w)
        if w_shape is None or len(w_shape) != 1:
            continue
        for x, r in _commuted(u, P.mul):
            x_shape = _ashape(x)
            if x_shape is None or len(x_shape) < 2 or x_shape[-1] != w_shape[0]:
                continue
            if not (is_apply(r, P.rsqrt) and len(r.args) == 1):
                continue
            for m, eps_n in _commuted(r.args[0], P.add):
                eps = _scalar_const_value(eps_n)
                if eps is None:
                    continue
                if not (is_apply(m, P.div) and len(m.args) == 2):
                    continue
                rs, d = m.args
                dv = _scalar_const_value(d)
                if dv is None or dv != float(x_shape[-1]):
                    continue
                sq = _is_last_axis_reduce(rs, P.reduce_sum)
                if sq is None:
                    continue
                if is_apply(sq, P.square) and sq.args[0] is x:
                    pass
                elif is_apply(sq, P.mul) and sq.args[0] is x and sq.args[1] is x:
                    pass
                else:
                    continue
                from repro_torch.kernels.ops import rmsnorm_prim

                return n.graph.apply(rmsnorm_prim, x, w, eps), "pattern_rmsnorm"
    return None


def _match_attention_core(n: Apply):
    """``softmax(q @ kᵀ · scale) @ v`` with softmax spelled
    ``exp(s − max(s)) / Σ exp(s − max(s))`` (stable, last-axis) →
    ``flash_attention(q, k, v, False, None, scale)``.  Fires only on
    4-D (B, H, S, D) operands — the kernel's layout."""
    if not (is_apply(n, P.matmul) and len(n.args) == 2):
        return None
    prob, v = n.args
    if not (is_apply(prob, P.div) and len(prob.args) == 2):
        return None
    e, z = prob.args
    if _is_last_axis_reduce(z, P.reduce_sum) is not e:
        return None
    if not (is_apply(e, P.exp) and len(e.args) == 1):
        return None
    d = e.args[0]
    if not (is_apply(d, P.sub) and len(d.args) == 2):
        return None
    s, m = d.args
    if _is_last_axis_reduce(m, P.reduce_max) is not s:
        return None
    scale = 1.0
    t = s
    for cand, c in _commuted(s, P.mul):
        cv = _scalar_const_value(c)
        if cv is not None:
            t, scale = cand, cv
            break
    if not (is_apply(t, P.matmul) and len(t.args) == 2):
        return None
    q, kt = t.args
    if not (is_apply(kt, P.mT) and len(kt.args) == 1):
        return None
    k = kt.args[0]
    qs, ks, vs = _ashape(q), _ashape(k), _ashape(v)
    if not (qs and ks and vs) or not (len(qs) == len(ks) == len(vs) == 4):
        return None
    if ks != vs or qs[-1] != ks[-1] or qs[0] != ks[0] or qs[1] % ks[1] != 0:
        return None
    from repro_torch.kernels.ops import flash_attention_prim

    return (
        n.graph.apply(flash_attention_prim, q, k, v, False, None, scale),
        "pattern_flash_attention",
    )


def _try_kernel_patterns(n: Apply, p: Primitive):
    if p is P.mul:
        return _match_rmsnorm(n)
    if p is P.matmul:
        return _match_attention_core(n)
    return None


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def optimize(
    graph: Graph,
    *,
    inline: bool = True,
    max_inline_size: int | None = None,
    max_iterations: int = 50,
    engine: str = "worklist",
    stats: OptStats | None = None,
    patterns: bool = False,
    defunctionalize: bool = True,
) -> Graph:
    """Optimize ``graph`` in place (and return it).

    ``engine`` selects the local-rule driver: ``"worklist"`` (near-linear,
    the default) or ``"sweep"`` (the reference fixed-point sweep — both
    reach the same normal form; see the module docstring).  Pass an
    :class:`OptStats` as ``stats`` to collect per-rule hit counters.
    ``patterns=True`` (the fusion tier) additionally recognizes
    kernel-shaped subgraphs — rmsnorm, the softmax-attention core — and
    rewrites them to the hand-written kernel primitives registered in
    ``repro_torch.kernels.ops`` (shape-directed: requires inferred abstracts).
    ``defunctionalize=True`` monomorphizes calls of *recursive* graphs on
    graph/primitive-valued constant arguments (``repro_torch.core.closure``):
    the specialized clone's interior calls become first-order, which the
    next inline wave resolves — higher-order recursion reduces to the
    loop shapes ``lower_loops`` compiles.
    """
    rw = _Rewriter(graph, max_inline_size, stats, patterns=patterns)
    spec_memo: dict = {}
    with obs_trace.span(
        "optimize", graph=graph.name, engine=engine, patterns=patterns
    ) as osp:
        for _ in range(max_iterations):
            changed = False
            if inline:
                changed |= rw.inline_pass()
            if inline and defunctionalize:
                from .closure import specialize_recursive_calls

                with obs_trace.span("opt.defunctionalize"):
                    specialized = specialize_recursive_calls(
                        graph, stats=rw.stats, memo=spec_memo
                    )
                if specialized:
                    # whole families were cloned and rewired: rebuild the index
                    rw.fam = FamilyIndex(graph)
                    rw._ret_index = None
                    changed = True
            changed |= rw.rules_pass(engine)
            rw.stats.iterations += 1
            if not changed:
                break
            # rewrites may have cut graph references (e.g. switch-of-constant
            # dropping a branch): refresh recursion facts before re-inlining
            # (scoped to the graphs the rewrites actually touched)
            rw.fam.invalidate_rewrites(dirty=rw._dirty)
            rw._dirty = set()
        osp.set(
            iterations=rw.stats.iterations,
            rewrites=rw.stats.total_rewrites,
            inlined_calls=rw.stats.inlined_calls,
        )
    return graph
