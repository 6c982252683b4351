"""Closure-based source-transformation reverse-mode AD (paper §3.2).

Following Pearlmutter & Siskind's "Lambda the ultimate backpropagator" as
adopted by the paper:

* ``J(g)`` transforms graph ``g`` into ``▶g`` ("forward graph"): every call
  inside returns an **additional value**, a closure called the
  *backpropagator* (``◀``); ``▶g`` itself returns ``(value, ◀g)``.
* ``◀g(dout)`` calls the backpropagators of the body in reverse order and
  returns ``(env, dparam_1, …, dparam_n)`` where ``env`` carries the partial
  derivatives w.r.t. ``g``'s **free variables** keyed by symbolic keys
  (see ``repro_torch.core.values``).  The backpropagator of the scope that
  *created* a closure unpacks that env — "this unpacking being the adjoint
  of closure creation" (paper §3.2).
* Because the transform's output is ordinary IR (closures included), it can
  be applied to itself: **reverse-over-reverse** gives higher-order
  derivatives.  No tape anywhere.

There is no runtime machinery here: the result is a program, amenable to
ahead-of-time optimization (``repro_torch.core.opt``) — the paper's central
argument for ST over operator overloading.
"""

from __future__ import annotations

import inspect

import numpy as np

from . import primitives as P
from .ir import (
    Apply,
    Constant,
    Graph,
    Node,
    Parameter,
    dfs_nodes,
    free_variables,
    graph_and_descendants,
    is_constant_graph,
)
from .primitives import LOOP_NAMES, Primitive
from .values import SymbolicKey, newenv

__all__ = ["J", "Jprim", "build_grad_graph", "build_value_and_grad_graph", "build_vjp_graph"]


# ---------------------------------------------------------------------------
# J of primitives
# ---------------------------------------------------------------------------

_JPRIM_CACHE: dict[tuple[int, int], Graph] = {}


def _prim_arity(p: Primitive) -> int:
    if callable(p.bprop):
        return len(inspect.signature(p.bprop).parameters) - 2
    try:
        sig = inspect.signature(p.impl)
    except (TypeError, ValueError):  # pragma: no cover
        raise TypeError(f"cannot determine arity of primitive {p.name}")
    if any(
        prm.kind in (prm.VAR_POSITIONAL, prm.VAR_KEYWORD) for prm in sig.parameters.values()
    ):
        raise TypeError(f"variadic primitive {p.name} needs an explicit arity")
    return len(sig.parameters)


def Jprim(p: Primitive, arity: int | None = None) -> Graph:
    """``▶p``: a graph ``(j1..jn) -> (p(j1..jn), ◀p)`` built from the
    primitive's registered backpropagator definition."""
    if arity is None:
        arity = _prim_arity(p)
    key = (id(p), arity)
    if key in _JPRIM_CACHE:
        return _JPRIM_CACHE[key]

    jp = Graph(f"▶{p.name}")
    jp.flags["is_jprim"] = p.name
    params = [jp.add_parameter(f"j{i}") for i in range(arity)]
    out = jp.apply(p, *params, debug_name=f"{p.name}_out")

    bg = Graph(f"◀{p.name}")
    bg.flags["is_bprop_of_prim"] = p.name
    dout = bg.add_parameter("dout")

    if p is P.make_tuple:
        items = [bg.apply(P.tuple_getitem, dout, i) for i in range(arity)]
    elif p.bprop == "zeros":
        items = [bg.apply(P.zeros_like, prm) for prm in params]
    elif callable(p.bprop):
        from .parser import parse_function

        bpg = parse_function(p.bprop)
        tup = bg.apply(bpg, *params, out, dout)
        items = [bg.apply(P.tuple_getitem, tup, i) for i in range(arity)]
    else:
        raise TypeError(f"primitive {p.name} has no backpropagator")

    bg.set_return(bg.apply(P.make_tuple, newenv, *items))
    jp.set_return(jp.apply(P.make_tuple, out, Constant(bg)))
    _JPRIM_CACHE[key] = jp
    return jp


# ---------------------------------------------------------------------------
# J of graphs (family-wide transform)
# ---------------------------------------------------------------------------


#: ``checkpoint_policy`` → number of checkpoint slots ``S`` in the
#: while-loop adjoint's segmented scheme (the stack is a static-shape
#: loop-carried array of ``S`` saved carries; the backward pass recomputes
#: at most ``ceil(T/S)-1`` steps per adjoint step from the nearest slot).
#: ``T <= S`` degenerates to exact saved-carry recording (zero recompute);
#: ``recompute`` (S=1) stores only the initial carry — O(T²) step work,
#: O(1) memory.  An int policy is used as ``S`` directly.  ``scan_loop``
#: adjoints ignore the policy: their trip count is static, so the stack is
#: exact by construction.  See docs/pipeline.md ("Loop adjoints").
_CHECKPOINT_SLOTS = {"auto": 128, "save_all": 1024, "recompute": 1}


def _policy_slots(policy) -> int:
    if policy is None:
        policy = "auto"
    if isinstance(policy, bool):
        raise ValueError(f"invalid checkpoint_policy {policy!r}")
    if isinstance(policy, int):
        if policy < 1:
            raise ValueError("checkpoint_policy slot count must be >= 1")
        return policy
    try:
        return _CHECKPOINT_SLOTS[policy]
    except KeyError:
        raise ValueError(
            f"invalid checkpoint_policy {policy!r} "
            f"(expected one of {sorted(_CHECKPOINT_SLOTS)} or an int slot count)"
        ) from None


def _carry_meta(node: Node, what: str) -> tuple[tuple[int, ...], np.dtype]:
    """(shape, dtype) of a loop-carry argument, read from its abstract.

    The adjoint allocates the saved-carry stack as a static-shape array,
    so the carry's shape/dtype must be statically known — which is exactly
    what the pre-grad pipeline's inference pass annotates."""
    from .infer import AArray, AScalar

    ab = node.abstract
    if isinstance(ab, AArray):
        return ab.shape, ab.dtype
    if isinstance(ab, AScalar):
        dt = {"int": "int32", "float": "float32", "bool": "bool"}.get(ab.kind)
        if dt is not None:
            return (), np.dtype(dt)
    if isinstance(node, Constant) and ab is None:
        # literal / folded-array inits (trip counters, accumulator seeds)
        # may predate inference or be emitted by a rewrite without an
        # abstract — derive the meta from the constant's value itself
        from .infer import InferenceError, abstract_of_value

        v = node.value
        if isinstance(v, bool):
            return (), np.dtype("bool")
        if isinstance(v, int):
            return (), np.dtype("int32")
        if isinstance(v, float):
            return (), np.dtype("float32")
        try:
            vab = abstract_of_value(v)
        except InferenceError:
            vab = None
        if isinstance(vab, AArray):
            return vab.shape, vab.dtype
    raise TypeError(
        f"cannot differentiate loop: carry {what} has abstract {ab!r} "
        "(need a type-inferred array/scalar carry — pass example_args so "
        "the primal runs the pipeline before grad)"
    )


def _tuple_exit(name: str, n_params: int, sel: list[int]) -> Graph:
    """A loop exit graph returning ``make_tuple(params[i] for i in sel)``."""
    g = Graph(name)
    ps = [g.add_parameter(f"a{i}") for i in range(n_params)]
    g.set_return(g.apply(P.make_tuple, *[ps[i] for i in sel]))
    return g


class JTransformer:
    def __init__(self, root: Graph, checkpoint_policy="auto") -> None:
        self.root = root
        self.checkpoint_slots = _policy_slots(checkpoint_policy)
        self.family = graph_and_descendants(root)
        self.graph_map: dict[Graph, Graph] = {}  # g -> ▶g
        self.bprop_graphs: dict[Graph, Graph] = {}  # g -> ◀g
        self.node_map: dict[int, Node] = {}  # primal node id -> forward-value node
        self.bprop_map: dict[int, Node] = {}  # primal apply id -> backpropagator node
        self._fv_cache: dict[Graph, list[Node]] = {}

    # -- public ---------------------------------------------------------
    def transform(self) -> Graph:
        cached = self.root.transforms.get("J")
        if cached is not None:
            return cached
        for g in self.family:
            jg = Graph(f"▶{g.name}")
            jg.primal = g
            jg.flags["is_j"] = True
            self.graph_map[g] = jg
            for prm in g.parameters:
                jp = jg.add_parameter(prm.debug_name)
                self.node_map[prm._id] = jp
            bg = Graph(f"◀{g.name}")
            bg.primal = g
            bg.flags["is_bprop"] = True
            self.bprop_graphs[g] = bg
        for g in self.family:
            self._build_forward(g)
        for g in self.family:
            self._build_backward(g)
        for g in self.family:
            g.transforms["J"] = self.graph_map[g]
        return self.graph_map[self.root]

    # -- forward ----------------------------------------------------------
    def _fwd_fn(self, node: Node, call_arity: int | None) -> Node:
        """Transform a node used in *function position*."""
        if isinstance(node, Constant):
            v = node.value
            if isinstance(v, Primitive):
                return Constant(Jprim(v, call_arity))
            if isinstance(v, Graph):
                return Constant(self.graph_map[v])
            raise TypeError(f"cannot call non-function constant {v!r}")
        return self._fwd(node)

    def _fwd(self, node: Node) -> Node:
        """Forward-value node for a primal node (iterative post-order)."""
        if node._id in self.node_map:
            return self.node_map[node._id]
        stack: list[tuple[Node, bool]] = [(node, False)]
        while stack:
            cur, ready = stack.pop()
            if cur._id in self.node_map:
                continue
            if isinstance(cur, Constant):
                v = cur.value
                if isinstance(v, Graph):
                    new: Node = Constant(self.graph_map[v], cur.debug_name)
                elif isinstance(v, Primitive):
                    # primitive passed as a value (e.g. HOF argument)
                    new = Constant(Jprim(v, None), cur.debug_name)
                else:
                    new = Constant(v, cur.debug_name)
                self.node_map[cur._id] = new
                continue
            if isinstance(cur, Parameter):
                raise RuntimeError(f"parameter {cur!r} not pre-mapped (outside family?)")
            assert isinstance(cur, Apply)
            if not ready:
                stack.append((cur, True))
                for inp in cur.inputs[1:]:
                    if inp._id not in self.node_map:
                        stack.append((inp, False))
                fn = cur.inputs[0]
                if not isinstance(fn, Constant) and fn._id not in self.node_map:
                    stack.append((fn, False))
                continue
            fn0 = cur.inputs[0]
            if (
                isinstance(fn0, Constant)
                and isinstance(fn0.value, Primitive)
                and fn0.value.name in LOOP_NAMES
            ):
                # structured loop: tape-free loop adjoint (see _j_loop)
                self._j_loop(cur)
                continue
            jg = self.graph_map[cur.graph]
            jf = self._fwd_fn(cur.inputs[0], len(cur.inputs) - 1)
            jargs = [self.node_map[a._id] for a in cur.inputs[1:]]
            japp = Apply([jf, *jargs], jg, debug_name=f"J_{cur.debug_name}")
            fw = Apply([Constant(P.tuple_getitem), japp, Constant(0)], jg, cur.debug_name)
            bp = Apply(
                [Constant(P.tuple_getitem), japp, Constant(1)], jg, f"bprop_{cur.debug_name}"
            )
            self.node_map[cur._id] = fw
            self.bprop_map[cur._id] = bp
        return self.node_map[node._id]

    def _build_forward(self, g: Graph) -> None:
        jg = self.graph_map[g]
        ret = self._fwd(g.return_)
        # also force-transform applies only reachable through nested graphs
        for n in dfs_nodes(g.return_):
            if isinstance(n, Apply) and n.graph in self.family:
                self._fwd(n)
        jg.set_return(jg.apply(P.make_tuple, ret, Constant(self.bprop_graphs[g])))

    # -- structured loops -------------------------------------------------
    #
    # Reverse-mode rules for the loop primitives (after Innes, "Don't
    # Unroll Adjoint"): instead of unrolling or taping, the adjoint of a
    # loop is itself a loop.
    #
    # * ``scan_loop`` (static trip count L): the forward pass is replaced
    #   by an *augmented* scan whose carry additionally threads one
    #   saved-carry stack per carry slot — an ordinary loop-carried array
    #   of shape ``(L, *carry.shape)``, not a runtime tape — plus the
    #   iteration index.  The backpropagator is a reversed scan over those
    #   stacks, calling the VJP of the step graph (itself built by this
    #   same transform, so reverse-over-reverse composes).
    #
    # * ``while_loop`` (dynamic trip count): phase 1 reruns the loop with
    #   a trip counter to obtain T; the backpropagator then reruns the
    #   forward once more, checkpointing every ``k_seg = ceil(T/S)``-th
    #   carry into an S-slot stack (S from ``checkpoint_policy``), and the
    #   backward while-loop recomputes at most ``k_seg - 1`` steps from
    #   the nearest checkpoint per adjoint step.  ``T <= S`` degenerates
    #   to exact recording; ``S == 1`` is full recomputation.
    #
    # Every graph built here is closed and first-order (direct calls of
    # the closed step/exit graphs, inlined by the optimizer on the next
    # pipeline wave), so loop adjoints lower, fuse, shard and AOT-cache
    # exactly like hand-written loops.

    def _loop_operands(self, cur: Apply, k: int):
        carries_p = list(cur.inputs[5 : 5 + k])
        extras_p = list(cur.inputs[5 + k :])
        carries = [self.node_map[a._id] for a in carries_p]
        extras = [self.node_map[a._id] for a in extras_p]
        metas = [
            _carry_meta(a, a.debug_name or f"#{i}") for i, a in enumerate(carries_p)
        ]
        return carries, extras, metas

    def _zero_stack(self, host: Graph, length: int, shape: tuple, dtype) -> Node:
        z = host.apply(P.cast, 0, Constant(dtype))
        return host.apply(P.broadcast_to, z, Constant((length, *shape)))

    def _j_loop(self, cur: Apply) -> None:
        prim = cur.inputs[0].value
        raw = cur.inputs[1:]
        n_sub = 2 if prim.name == "scan_loop" else 3
        subs = raw[:n_sub]
        if not all(is_constant_graph(s) for s in subs) or not isinstance(
            raw[n_sub], Constant
        ):
            raise TypeError(
                f"cannot differentiate {prim.name}: sub-graphs are not "
                "constant graphs (graph not in lowered canonical form)"
            )
        if prim.name == "scan_loop":
            self._j_scan(cur)
        else:
            self._j_while(cur)

    def _j_scan(self, cur: Apply) -> None:
        jg = self.graph_map[cur.graph]
        sg, eg = cur.inputs[1].value, cur.inputs[2].value
        L = int(cur.inputs[3].value)
        k = int(cur.inputs[4].value)
        carries, extras, metas = self._loop_operands(cur, k)
        m = len(extras)

        # augmented forward: carry (c..., stk..., t); each iteration saves
        # its incoming carry into row t of the stacks
        asg = Graph(f"{sg.name}:aug")
        ac = [asg.add_parameter(f"c{i}") for i in range(k)]
        astk = [asg.add_parameter(f"s{i}") for i in range(k)]
        at = asg.add_parameter("t")
        ae = [asg.add_parameter(f"e{j}") for j in range(m)]
        tup = asg.apply(Constant(sg), *ac, *ae)
        ncs = [asg.apply(P.tuple_getitem, tup, i) for i in range(k)]
        nss = [asg.apply(P.index_add, astk[i], at, ac[i]) for i in range(k)]
        asg.set_return(
            asg.apply(P.make_tuple, *ncs, *nss, asg.apply(P.add, at, 1))
        )
        aeg = _tuple_exit(f"{sg.name}:aug_exit", 2 * k + 1 + m, list(range(2 * k)))

        zstks = [self._zero_stack(jg, L, sh, dt) for sh, dt in metas]
        aug = jg.apply(
            P.scan_loop, Constant(asg), Constant(aeg), L, 2 * k + 1,
            *carries, *zstks, 0, *extras,
            debug_name=f"J_{cur.debug_name}",
        )
        fins = [jg.apply(P.tuple_getitem, aug, i) for i in range(k)]
        stks = [jg.apply(P.tuple_getitem, aug, k + i) for i in range(k)]
        self.node_map[cur._id] = jg.apply(
            Constant(eg), *fins, *extras, debug_name=cur.debug_name
        )

        vjp_sg = build_vjp_graph(sg)
        vjp_eg = build_vjp_graph(eg)

        # backward: reversed scan over the saved-carry stacks; carry
        # (t, dc..., dacc_e...), extras (stk..., e...)
        bsg = Graph(f"{sg.name}:bwd")
        bt = bsg.add_parameter("t")
        bdc = [bsg.add_parameter(f"dc{i}") for i in range(k)]
        bda = [bsg.add_parameter(f"da{j}") for j in range(m)]
        bstk = [bsg.add_parameter(f"s{i}") for i in range(k)]
        bex = [bsg.add_parameter(f"e{j}") for j in range(m)]
        tm1 = bsg.apply(P.sub, bt, 1)
        cs = [bsg.apply(P.take, bstk[i], tm1) for i in range(k)]
        gr = bsg.apply(
            Constant(vjp_sg), *cs, *bex, bsg.apply(P.make_tuple, *bdc)
        )
        ndc = [bsg.apply(P.tuple_getitem, gr, i) for i in range(k)]
        nda = [
            bsg.apply(P.gadd, bda[j], bsg.apply(P.tuple_getitem, gr, k + j))
            for j in range(m)
        ]
        bsg.set_return(bsg.apply(P.make_tuple, tm1, *ndc, *nda))
        beg = _tuple_exit(
            f"{sg.name}:bwd_exit", (1 + k + m) + (k + m), list(range(1 + k + m))
        )

        b = Graph(f"◀{cur.debug_name or 'scan_loop'}")
        b.flags["is_loop_bprop"] = True
        dout = b.add_parameter("dout")
        egr = b.apply(Constant(vjp_eg), *fins, *extras, dout)
        dfc = [b.apply(P.tuple_getitem, egr, i) for i in range(k)]
        dex = [b.apply(P.tuple_getitem, egr, k + j) for j in range(m)]
        zda = [b.apply(P.zeros_like, extras[j]) for j in range(m)]
        bres = b.apply(
            P.scan_loop, Constant(bsg), Constant(beg), L, 1 + k + m,
            L, *dfc, *zda, *stks, *extras,
        )
        dcs = [b.apply(P.tuple_getitem, bres, 1 + i) for i in range(k)]
        des = [
            b.apply(P.gadd, dex[j], b.apply(P.tuple_getitem, bres, 1 + k + j))
            for j in range(m)
        ]
        zero = Constant(0)
        b.set_return(
            b.apply(P.make_tuple, Constant(newenv), zero, zero, zero, zero, *dcs, *des)
        )
        self.bprop_map[cur._id] = Constant(b)

    def _j_while(self, cur: Apply) -> None:
        jg = self.graph_map[cur.graph]
        cg, sg, eg = (cur.inputs[i].value for i in (1, 2, 3))
        k = int(cur.inputs[4].value)
        carries, extras, metas = self._loop_operands(cur, k)
        m = len(extras)
        S = self.checkpoint_slots

        def call_sub(host: Graph, sub: Graph, cs: list, es: list) -> Node:
            return host.apply(Constant(sub), *cs, *es)

        # phase 1: forward with a trip counter; carry (c..., t)
        acg = Graph(f"{cg.name}:aug")
        pc = [acg.add_parameter(f"c{i}") for i in range(k)]
        acg.add_parameter("t")
        pe = [acg.add_parameter(f"e{j}") for j in range(m)]
        acg.set_return(call_sub(acg, cg, pc, pe))

        asg = Graph(f"{sg.name}:aug")
        sc = [asg.add_parameter(f"c{i}") for i in range(k)]
        st = asg.add_parameter("t")
        se = [asg.add_parameter(f"e{j}") for j in range(m)]
        tup = call_sub(asg, sg, sc, se)
        ncs = [asg.apply(P.tuple_getitem, tup, i) for i in range(k)]
        asg.set_return(
            asg.apply(P.make_tuple, *ncs, asg.apply(P.add, st, 1))
        )
        aeg = _tuple_exit(f"{sg.name}:aug_exit", k + 1 + m, list(range(k + 1)))

        p1 = jg.apply(
            P.while_loop, Constant(acg), Constant(asg), Constant(aeg), k + 1,
            *carries, 0, *extras,
            debug_name=f"J_{cur.debug_name}",
        )
        fins = [jg.apply(P.tuple_getitem, p1, i) for i in range(k)]
        trip = jg.apply(P.tuple_getitem, p1, k)
        self.node_map[cur._id] = jg.apply(
            Constant(eg), *fins, *extras, debug_name=cur.debug_name
        )

        vjp_sg = build_vjp_graph(sg)
        vjp_eg = build_vjp_graph(eg)

        b = Graph(f"◀{cur.debug_name or 'while_loop'}")
        b.flags["is_loop_bprop"] = True
        dout = b.add_parameter("dout")
        # segment length: ceil(T / S), at least 1 (S static, T dynamic)
        kseg = b.apply(
            P.maximum, 1, b.apply(P.floordiv, b.apply(P.add, trip, S - 1), S)
        )

        # phase 2 (grad-only): rerun the forward, checkpointing every
        # kseg-th carry into slot t // kseg of an S-slot stack.  The write
        # is masked (add 0 elsewhere), so the stack stays a plain carry.
        rcg = Graph(f"{cg.name}:rec")
        rc = [rcg.add_parameter(f"c{i}") for i in range(k)]
        for i in range(k):
            rcg.add_parameter(f"s{i}")
        rcg.add_parameter("t")
        re_ = [rcg.add_parameter(f"e{j}") for j in range(m)]
        rcg.add_parameter("kseg")
        rcg.set_return(call_sub(rcg, cg, rc, re_))

        rsg = Graph(f"{sg.name}:rec")
        xc = [rsg.add_parameter(f"c{i}") for i in range(k)]
        xs = [rsg.add_parameter(f"s{i}") for i in range(k)]
        xt = rsg.add_parameter("t")
        xe = [rsg.add_parameter(f"e{j}") for j in range(m)]
        xk = rsg.add_parameter("kseg")
        slot = rsg.apply(P.floordiv, xt, xk)
        hit = rsg.apply(P.eq, rsg.apply(P.mod, xt, xk), 0)
        nss = [
            rsg.apply(
                P.index_add, xs[i], slot,
                rsg.apply(P.mul, xc[i], rsg.apply(P.cast, hit, Constant(metas[i][1]))),
            )
            for i in range(k)
        ]
        tup = call_sub(rsg, sg, xc, xe)
        ncs = [rsg.apply(P.tuple_getitem, tup, i) for i in range(k)]
        rsg.set_return(
            rsg.apply(P.make_tuple, *ncs, *nss, rsg.apply(P.add, xt, 1))
        )
        reg = _tuple_exit(
            f"{sg.name}:rec_exit", 2 * k + 1 + m + 1, list(range(k, 2 * k))
        )
        zstks = [self._zero_stack(b, S, sh, dt) for sh, dt in metas]
        p2 = b.apply(
            P.while_loop, Constant(rcg), Constant(rsg), Constant(reg), 2 * k + 1,
            *carries, *zstks, 0, *extras, kseg,
        )
        stks = [b.apply(P.tuple_getitem, p2, i) for i in range(k)]

        # inner recompute: replay r = (t-1) - seg*kseg steps from the
        # checkpointed carry; carry (c..., j), extras (e..., r)
        icg = Graph(f"{sg.name}:replay_cond")
        for i in range(k):
            icg.add_parameter(f"c{i}")
        ij = icg.add_parameter("j")
        for j in range(m):
            icg.add_parameter(f"e{j}")
        ir = icg.add_parameter("r")
        icg.set_return(icg.apply(P.lt, ij, ir))

        isg = Graph(f"{sg.name}:replay")
        yc = [isg.add_parameter(f"c{i}") for i in range(k)]
        yj = isg.add_parameter("j")
        ye = [isg.add_parameter(f"e{j}") for j in range(m)]
        isg.add_parameter("r")
        tup = call_sub(isg, sg, yc, ye)
        ncs = [isg.apply(P.tuple_getitem, tup, i) for i in range(k)]
        isg.set_return(
            isg.apply(P.make_tuple, *ncs, isg.apply(P.add, yj, 1))
        )
        ieg = _tuple_exit(f"{sg.name}:replay_exit", k + 1 + m + 1, list(range(k)))

        # backward while: carry (t, dc..., dacc_e...),
        # extras (stk..., e..., kseg)
        bwcg = Graph(f"{sg.name}:bwd_cond")
        wt = bwcg.add_parameter("t")
        for i in range(k + m):
            bwcg.add_parameter(f"d{i}")
        for i in range(k + m + 1):
            bwcg.add_parameter(f"x{i}")
        bwcg.set_return(bwcg.apply(P.gt, wt, 0))

        bwsg = Graph(f"{sg.name}:bwd")
        bt = bwsg.add_parameter("t")
        bdc = [bwsg.add_parameter(f"dc{i}") for i in range(k)]
        bda = [bwsg.add_parameter(f"da{j}") for j in range(m)]
        bstk = [bwsg.add_parameter(f"s{i}") for i in range(k)]
        bex = [bwsg.add_parameter(f"e{j}") for j in range(m)]
        bk = bwsg.add_parameter("kseg")
        tm1 = bwsg.apply(P.sub, bt, 1)
        seg = bwsg.apply(P.floordiv, tm1, bk)
        c0 = [bwsg.apply(P.take, bstk[i], seg) for i in range(k)]
        r = bwsg.apply(P.sub, tm1, bwsg.apply(P.mul, seg, bk))
        inner = bwsg.apply(
            P.while_loop, Constant(icg), Constant(isg), Constant(ieg), k + 1,
            *c0, 0, *bex, r,
        )
        cs = [bwsg.apply(P.tuple_getitem, inner, i) for i in range(k)]
        gr = bwsg.apply(
            Constant(vjp_sg), *cs, *bex, bwsg.apply(P.make_tuple, *bdc)
        )
        ndc = [bwsg.apply(P.tuple_getitem, gr, i) for i in range(k)]
        nda = [
            bwsg.apply(P.gadd, bda[j], bwsg.apply(P.tuple_getitem, gr, k + j))
            for j in range(m)
        ]
        bwsg.set_return(bwsg.apply(P.make_tuple, tm1, *ndc, *nda))
        bweg = _tuple_exit(
            f"{sg.name}:bwd_exit", (1 + k + m) + (k + m + 1), list(range(1 + k + m))
        )

        egr = b.apply(Constant(vjp_eg), *fins, *extras, dout)
        dfc = [b.apply(P.tuple_getitem, egr, i) for i in range(k)]
        dex = [b.apply(P.tuple_getitem, egr, k + j) for j in range(m)]
        zda = [b.apply(P.zeros_like, extras[j]) for j in range(m)]
        bres = b.apply(
            P.while_loop, Constant(bwcg), Constant(bwsg), Constant(bweg), 1 + k + m,
            trip, *dfc, *zda, *stks, *extras, kseg,
        )
        dcs = [b.apply(P.tuple_getitem, bres, 1 + i) for i in range(k)]
        des = [
            b.apply(P.gadd, dex[j], b.apply(P.tuple_getitem, bres, 1 + k + j))
            for j in range(m)
        ]
        zero = Constant(0)
        b.set_return(
            b.apply(P.make_tuple, Constant(newenv), zero, zero, zero, zero, *dcs, *des)
        )
        self.bprop_map[cur._id] = Constant(b)

    # -- backward ---------------------------------------------------------
    def _fvs(self, g: Graph) -> list[Node]:
        if g not in self._fv_cache:
            self._fv_cache[g] = free_variables(g)
        return self._fv_cache[g]

    def _adjoint_order(self, g: Graph) -> list[Apply]:
        """g-owned apply nodes, topo-sorted with closure-capture edges:
        an apply that references a nested graph depends on the g-owned free
        variables that graph captures (closure creation 'uses' them)."""
        owned = [
            n
            for n in dfs_nodes(g.return_)
            if isinstance(n, Apply) and n.graph is g
        ]
        deps: dict[int, list[Node]] = {}
        for u in owned:
            d: list[Node] = []
            for inp in u.inputs:
                if inp.graph is g:
                    d.append(inp)
                elif is_constant_graph(inp) and inp.value in self.family:
                    d.extend(v for v in self._fvs(inp.value) if v.graph is g)
            deps[u._id] = d
        order: list[Apply] = []
        state: dict[int, int] = {}  # 0 visiting, 1 done

        for root in owned:
            if root._id in state:
                continue
            stack: list[tuple[Node, bool]] = [(root, False)]
            while stack:
                cur, ready = stack.pop()
                if ready:
                    state[cur._id] = 1
                    order.append(cur)  # type: ignore[arg-type]
                    continue
                st = state.get(cur._id)
                if st is not None:
                    continue
                state[cur._id] = 0
                stack.append((cur, True))
                for dep in deps.get(cur._id, ()):
                    if isinstance(dep, Apply) and dep.graph is g and state.get(dep._id) is None:
                        stack.append((dep, False))
        return order

    def _build_backward(self, g: Graph) -> None:
        bg = self.bprop_graphs[g]
        dout = bg.add_parameter("dout")
        contribs: dict[int, list[Node]] = {}
        env_contribs: dict[int, tuple[Node, list[Node]]] = {}
        sens_memo: dict[int, Node] = {}

        def fold(vals: list[Node]) -> Node:
            acc = vals[0]
            for v in vals[1:]:
                acc = bg.apply(P.gadd, acc, v)
            return acc

        def sens_of(primal: Node) -> Node:
            if primal._id in sens_memo:
                return sens_memo[primal._id]
            lst = contribs.get(primal._id)
            if lst:
                s = fold(lst)
            else:
                s = bg.apply(P.zeros_like, self.node_map[primal._id])
            sens_memo[primal._id] = s
            return s

        def route(primal: Node, val: Node) -> None:
            if isinstance(primal, Constant):
                v = primal.value
                if isinstance(v, Graph) and v in self.family:
                    # adjoint of closure creation: unpack free-var grads
                    for fv in self._fvs(v):
                        fw_fv = self.node_map[fv._id]
                        key = Constant(SymbolicKey(fw_fv))
                        dflt = bg.apply(P.zeros_like, fw_fv)
                        dv = bg.apply(P.env_getitem, val, key, dflt)
                        route(fv, dv)
                return  # sensitivities of data/primitive constants: discarded
            if primal.graph is g:
                contribs.setdefault(primal._id, []).append(val)
            else:
                # free variable of g: goes into the returned env
                ec = env_contribs.setdefault(primal._id, (primal, []))
                ec[1].append(val)

        route(g.return_, dout)

        for u in reversed(self._adjoint_order(g)):
            du = sens_of(u)
            ct = bg.apply(self.bprop_map[u._id], du, debug_name=f"d_{u.debug_name}")
            for i, inp in enumerate(u.inputs):
                route(inp, bg.apply(P.tuple_getitem, ct, i))

        env_node: Node = Constant(newenv)
        for nid in sorted(env_contribs):
            primal, vals = env_contribs[nid]
            fw = self.node_map[primal._id]
            env_node = bg.apply(
                P.env_setitem, env_node, Constant(SymbolicKey(fw)), fold(vals)
            )
        param_sens = [sens_of(prm) for prm in g.parameters]
        bg.set_return(bg.apply(P.make_tuple, env_node, *param_sens))


def J(g: Graph, checkpoint_policy="auto") -> Graph:
    """Transform ``g`` into ``▶g`` (cached on the graph)."""
    cached = g.transforms.get("J")
    if cached is not None:
        return cached
    return JTransformer(g, checkpoint_policy).transform()


# ---------------------------------------------------------------------------
# User-facing graph builders
# ---------------------------------------------------------------------------


def _needs_loop_pipeline(root: Graph) -> bool:
    """True when ``root``'s family still holds recursion (parser-canonical
    loops not yet lowered) or already-lowered loop primitive applies —
    either way the primal must run the pipeline (inference + lower_loops)
    before J so the loop AD rules see typed loop primitives instead of raw
    recursion."""
    for g in graph_and_descendants(root):
        if g.return_ is None:
            continue
        for n in dfs_nodes(g.return_):
            if is_constant_graph(n) and n.value is g:
                return True
            if isinstance(n, Apply):
                f = n.inputs[0]
                if (
                    isinstance(f, Constant)
                    and isinstance(f.value, Primitive)
                    and f.value.name in LOOP_NAMES
                ):
                    return True
    return False


def _prepare_primal(g: Graph, example_args) -> Graph:
    """Pre-grad pipeline: when the primal needs loop lowering and example
    arguments are available, run ``compile_pipeline`` (inline → infer →
    optimize → lower_loops) so grad-of-loop sees ``while_loop`` /
    ``scan_loop`` primitives with inferred carry types.  Straight-line
    primals (and calls without example args — e.g. the parse-time grad
    macro) keep the direct J path."""
    if example_args is None or not _needs_loop_pipeline(g):
        return g
    from .api import compile_pipeline
    from .infer import AbstractValue, abstract_of_value

    example = tuple(
        a if isinstance(a, AbstractValue) else abstract_of_value(a)
        for a in example_args
    )
    return compile_pipeline(g, example)


def _seed_cotangent(gg: Graph, out: Node) -> Node:
    """The seed ``d(out)``: ones *at the output's shape*.  A bare scalar
    1.0 relies on broadcasting through every backpropagator — sound for
    scalar outputs, but under reverse-over-reverse the outer adjoint's
    output is an array and a scalar seed leaves shape-mismatched zero
    terms that the optimizer's ``gadd_zero`` must then treat as
    broadcasts.  ``broadcast_to(cast(1, dtype), shape)`` is exact and
    folds to a no-op for scalar outputs (the ``broadcast_noop`` rule)."""
    one = gg.apply(P.cast, 1.0, gg.apply(P.dtype_of, out))
    return gg.apply(P.broadcast_to, one, gg.apply(P.shape, out))


def build_grad_graph(
    g: Graph,
    wrt: int | tuple[int, ...] = 0,
    *,
    example_args=None,
    checkpoint_policy="auto",
) -> Graph:
    """``grad(f)``: a graph computing df/dx_wrt for a scalar-output ``f``.

    ``example_args`` (values or abstracts, one per primal parameter) arms
    the pre-grad pipeline for loop-containing primals; ``checkpoint_policy``
    selects the while-loop adjoint's memory/recompute tradeoff (see
    ``repro_torch.core.api.CompileOptions``)."""
    from repro_torch.obs import trace as obs_trace

    with obs_trace.span("ad.grad", graph=g.name):
        g = _prepare_primal(g, example_args)
        return _build_grad_graph_body(g, wrt, checkpoint_policy)


def _build_grad_graph_body(
    g: Graph, wrt: int | tuple[int, ...], checkpoint_policy="auto"
) -> Graph:
    jg = J(g, checkpoint_policy)
    gg = Graph(f"grad_{g.name}")
    params = [gg.add_parameter(p.debug_name) for p in g.parameters]
    japp = gg.apply(jg, *params)
    out = gg.apply(P.tuple_getitem, japp, 0)
    bp = gg.apply(P.tuple_getitem, japp, 1)
    grads = gg.apply(bp, _seed_cotangent(gg, out))
    if isinstance(wrt, int):
        gg.set_return(gg.apply(P.tuple_getitem, grads, wrt + 1))
    else:
        items = [gg.apply(P.tuple_getitem, grads, i + 1) for i in wrt]
        gg.set_return(gg.apply(P.make_tuple, *items))
    gg.primal = g
    return gg


def build_value_and_grad_graph(
    g: Graph,
    wrt: int | tuple[int, ...] = 0,
    *,
    example_args=None,
    checkpoint_policy="auto",
) -> Graph:
    g = _prepare_primal(g, example_args)
    jg = J(g, checkpoint_policy)
    gg = Graph(f"value_and_grad_{g.name}")
    params = [gg.add_parameter(p.debug_name) for p in g.parameters]
    japp = gg.apply(jg, *params)
    out = gg.apply(P.tuple_getitem, japp, 0)
    bp = gg.apply(P.tuple_getitem, japp, 1)
    grads = gg.apply(bp, _seed_cotangent(gg, out))
    if isinstance(wrt, int):
        gnode = gg.apply(P.tuple_getitem, grads, wrt + 1)
    else:
        gnode = gg.apply(P.make_tuple, *[gg.apply(P.tuple_getitem, grads, i + 1) for i in wrt])
    gg.set_return(gg.apply(P.make_tuple, out, gnode))
    gg.primal = g
    return gg


def build_vjp_graph(
    g: Graph, *, example_args=None, checkpoint_policy="auto"
) -> Graph:
    """``vjp(f)``: graph ``(x1..xn, dout) -> (dx1..dxn)`` — arbitrary output
    cotangent (non-scalar outputs)."""
    g = _prepare_primal(g, example_args)
    jg = J(g, checkpoint_policy)
    gg = Graph(f"vjp_{g.name}")
    params = [gg.add_parameter(p.debug_name) for p in g.parameters]
    dout = gg.add_parameter("dout")
    japp = gg.apply(jg, *params)
    bp = gg.apply(P.tuple_getitem, japp, 1)
    grads = gg.apply(bp, dout)
    items = [gg.apply(P.tuple_getitem, grads, i + 1) for i in range(len(params))]
    gg.set_return(gg.apply(P.make_tuple, *items))
    gg.primal = g
    return gg
