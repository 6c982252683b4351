"""Python-subset frontend (paper §4.1).

Parses a *pure* subset of Python into the graph IR:

* functions (including nested defs and lambdas — closures come for free
  from the free-variable representation), recursion,
* ``if``/``while``/``for i in range(...)`` — converted to the functional
  form: each basic block is a graph, jumps are tail calls, conditionals are
  ``switch(cond, true_graph, false_graph)()``,
* tuples, arithmetic/comparison/boolean operators, calls.

Mutating statements (``x[i] = v``, ``x += y``) are **forbidden**, exactly as
in the paper ("We currently forbid these statements in Myia").
"""

from __future__ import annotations

import ast
import inspect
import textwrap
import types
from typing import Any, Callable

from . import primitives as P
from .ir import Constant, Graph, Node
from .primitives import Primitive

__all__ = ["parse_function", "MyiaSyntaxError", "macro"]


class MyiaSyntaxError(Exception):
    pass


_PARSE_CACHE: dict[Any, Graph] = {}


def macro(expand: Callable) -> Callable:
    """Decorator factory: mark a callable as a parse-time macro.  The parser
    calls ``fn.__myia_macro_expand__(parser, block, ast_args)``."""

    def mark(fn: Callable) -> Callable:
        fn.__is_myia_macro__ = True
        fn.__myia_macro_expand__ = expand
        return fn

    return mark


_BINOPS = {
    ast.Add: P.add,
    ast.Sub: P.sub,
    ast.Mult: P.mul,
    ast.Div: P.div,
    ast.Pow: P.power,
    ast.FloorDiv: P.floordiv,
    ast.Mod: P.mod,
    ast.MatMult: P.matmul,
}

_CMPOPS = {
    ast.Lt: P.lt,
    ast.Gt: P.gt,
    ast.LtE: P.le,
    ast.GtE: P.ge,
    ast.Eq: P.eq,
    ast.NotEq: P.ne,
}

_ATTRS = {
    "T": P.mT,
    "mT": P.mT,
    "shape": P.shape,
    "dtype": P.dtype_of,
}

_BUILTINS: dict[str, Primitive] = {
    "len": P.tuple_len,
    "abs": P.absolute,
    "max": P.maximum,
    "min": P.minimum,
}


def _assigned_names(stmts: list[ast.stmt]) -> list[str]:
    """Names (syntactically) assigned anywhere in a suite, in first-seen
    order — these become the parameters of continuation/loop blocks."""
    out: list[str] = []

    def add(name: str) -> None:
        if name not in out:
            out.append(name)

    def visit_target(t: ast.expr) -> None:
        if isinstance(t, ast.Name):
            add(t.id)
        elif isinstance(t, ast.Tuple):
            for e in t.elts:
                visit_target(e)

    def visit(s: ast.stmt) -> None:
        if isinstance(s, ast.Assign):
            for t in s.targets:
                visit_target(t)
        elif isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name):
            add(s.target.id)
        elif isinstance(s, ast.FunctionDef):
            add(s.name)
        elif isinstance(s, ast.If):
            for b in (*s.body, *s.orelse):
                visit(b)
        elif isinstance(s, ast.While):
            for b in (*s.body, *s.orelse):
                visit(b)
        elif isinstance(s, ast.For):
            visit_target(s.target)
            for b in (*s.body, *s.orelse):
                visit(b)

    for s in stmts:
        visit(s)
    return out


class Block:
    """A basic block: a graph plus local name bindings and a lexical parent."""

    __slots__ = ("graph", "bindings", "parent", "parser")

    def __init__(self, graph: Graph, parent: "Block | None", parser: "Parser") -> None:
        self.graph = graph
        self.bindings: dict[str, Node] = {}
        self.parent = parent
        self.parser = parser

    def bind(self, name: str, node: Node) -> None:
        self.bindings[name] = node

    def read(self, name: str) -> Node:
        blk: Block | None = self
        while blk is not None:
            if name in blk.bindings:
                return blk.bindings[name]
            blk = blk.parent
        return self.parser.resolve_global(name)


class _LoopCtx:
    __slots__ = ("incr_graph", "loop_names", "after_const")

    def __init__(self, incr_graph: Graph, loop_names: list[str], after_const: Constant):
        #: graph to tail-call on `continue` (header for while, incr for for)
        self.incr_graph = incr_graph
        self.loop_names = loop_names
        self.after_const = after_const


#: continuation spec: (graph_to_jump_to, names_passed_as_args) or None
#: (None means: falling off the end returns None from the function)
Cont = "tuple[Graph, list[str]] | None"


class Parser:
    def __init__(self, fn: Callable) -> None:
        self.fn = fn
        self.globals = getattr(fn, "__globals__", {})
        self.closure_vars: dict[str, Any] = {}
        if getattr(fn, "__closure__", None):
            for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
                try:
                    self.closure_vars[name] = cell.cell_contents
                except ValueError:
                    pass
        self.loop_stack: list[_LoopCtx] = []

    # -- name resolution ---------------------------------------------------
    def resolve_global(self, name: str) -> Node:
        if name in self.closure_vars:
            return self.value_to_node(self.closure_vars[name], name)
        if name in self.globals:
            return self.value_to_node(self.globals[name], name)
        if name in _BUILTINS:
            return Constant(_BUILTINS[name], name)
        raise MyiaSyntaxError(f"name {name!r} is not defined in the Myia subset")

    def value_to_node(self, value: Any, name: str = "") -> Node:
        if isinstance(value, (Primitive, Graph)):
            return Constant(value, name)
        factory = getattr(value, "__myia_graph_factory__", None)
        if factory is not None:  # @myia-decorated function
            return Constant(factory(), name)
        if isinstance(value, types.FunctionType) and not getattr(
            value, "__is_myia_macro__", False
        ):
            return Constant(parse_function(value), name)
        return Constant(value, name)

    # -- entry ---------------------------------------------------------------
    def parse(self, target: Graph | None = None) -> Graph:
        src = textwrap.dedent(inspect.getsource(self.fn))
        tree = ast.parse(src)
        fndef = tree.body[0]
        if not isinstance(fndef, ast.FunctionDef):
            raise MyiaSyntaxError("expected a function definition")
        module_block = Block(Graph("__module__"), None, self)
        return self.process_function(fndef, module_block, graph=target)

    # -- functions -----------------------------------------------------------
    def process_function(
        self,
        node: ast.FunctionDef | ast.Lambda,
        parent: Block | None,
        graph: Graph | None = None,
    ) -> Graph:
        name = getattr(node, "name", "<lambda>")
        g = graph if graph is not None else Graph(name)
        args = node.args
        if args.vararg or args.kwarg or args.kwonlyargs or args.defaults or args.posonlyargs:
            raise MyiaSyntaxError(f"{name}: only plain positional parameters are supported")
        block = Block(g, parent, self)
        # direct recursion by name
        block.bind(name, Constant(g, name))
        for a in args.args:
            p = g.add_parameter(a.arg)
            block.bind(a.arg, p)
        if isinstance(node, ast.Lambda):
            g.set_return(self.expr(block, node.body))
        else:
            self.process_stmts(block, list(node.body), None)
        return g

    def make_thunk(self, block: Block, expr: ast.expr, name: str) -> Graph:
        """A zero-arg nested graph evaluating ``expr`` (for lazy branches)."""
        g = Graph(name)
        b = Block(g, block, self)
        g.set_return(self.expr(b, expr))
        return g

    # -- statements ------------------------------------------------------------
    def process_stmts(self, block: Block, stmts: list[ast.stmt], cont) -> None:
        """Process a suite inside ``block``.  ``cont`` is the fall-through
        continuation ``(graph, arg_names)`` or None (end of function)."""
        while True:
            if not stmts:
                self._fall_through(block, cont)
                return
            s = stmts[0]
            rest = stmts[1:]
            if isinstance(s, ast.FunctionDef):
                # Hoist a run of consecutive defs: bind all names first so
                # sibling functions can recurse mutually.
                defs = [s]
                while rest and isinstance(rest[0], ast.FunctionDef):
                    defs.append(rest[0])
                    rest = rest[1:]
                graphs = [Graph(d.name) for d in defs]
                for d, dg in zip(defs, graphs):
                    block.bind(d.name, Constant(dg, d.name))
                for d, dg in zip(defs, graphs):
                    self.process_function(d, block, graph=dg)
                stmts = rest
                continue
            if isinstance(s, ast.Return):
                val = self.expr(block, s.value) if s.value is not None else Constant(None)
                block.graph.set_return(val)
                return
            if isinstance(s, ast.If):
                self._process_if(block, s, rest, cont)
                return
            if isinstance(s, ast.While):
                self._process_while(block, s, rest, cont)
                return
            if isinstance(s, ast.For):
                self._process_for(block, s, rest, cont)
                return
            if isinstance(s, ast.Break):
                ctx = self._loop_ctx()
                block.graph.set_return(block.graph.apply(ctx.after_const))
                return
            if isinstance(s, ast.Continue):
                ctx = self._loop_ctx()
                args = [block.read(n) for n in ctx.loop_names]
                block.graph.set_return(block.graph.apply(Constant(ctx.incr_graph), *args))
                return
            self._process_simple(block, s)
            stmts = rest

    def _fall_through(self, block: Block, cont) -> None:
        if block.graph.return_ is not None:
            return
        if cont is None:
            block.graph.set_return(Constant(None))
        else:
            cont_g, names = cont
            args = [self._read_or_none(block, n) for n in names]
            block.graph.set_return(block.graph.apply(Constant(cont_g), *args))

    def _loop_ctx(self) -> _LoopCtx:
        if not self.loop_stack:
            raise MyiaSyntaxError("break/continue outside loop")
        return self.loop_stack[-1]

    def _read_or_none(self, block: Block, name: str) -> Node:
        try:
            return block.read(name)
        except MyiaSyntaxError:
            return Constant(None)

    def _process_simple(self, block: Block, s: ast.stmt) -> None:
        if isinstance(s, ast.Assign):
            if len(s.targets) != 1:
                raise MyiaSyntaxError("chained assignment is not supported")
            target = s.targets[0]
            if isinstance(target, (ast.Subscript, ast.Attribute)):
                raise MyiaSyntaxError(
                    "mutating assignment (x[i] = v / x.a = v) is forbidden in the "
                    "pure Myia subset (paper §4.1)"
                )
            val = self.expr(block, s.value)
            self._bind_target(block, target, val)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None and isinstance(s.target, ast.Name):
                block.bind(s.target.id, self.expr(block, s.value))
        elif isinstance(s, ast.AugAssign):
            raise MyiaSyntaxError(
                "augmented assignment (x += y) is forbidden in the pure Myia "
                "subset (paper §4.1); write x = x + y"
            )
        elif isinstance(s, ast.Expr):
            if isinstance(s.value, ast.Constant) and isinstance(s.value.value, str):
                return  # docstring
            raise MyiaSyntaxError("expression statements have no effect in a pure language")
        elif isinstance(s, ast.Pass):
            return
        else:
            raise MyiaSyntaxError(f"unsupported statement: {type(s).__name__}")

    def _bind_target(self, block: Block, target: ast.expr, val: Node) -> None:
        if isinstance(target, ast.Name):
            val.debug_name = val.debug_name or target.id
            block.bind(target.id, val)
        elif isinstance(target, ast.Tuple):
            for i, elt in enumerate(target.elts):
                if isinstance(elt, ast.Starred):
                    raise MyiaSyntaxError("starred unpacking is not supported")
                item = block.graph.apply(P.tuple_getitem, val, Constant(i))
                self._bind_target(block, elt, item)
        else:
            raise MyiaSyntaxError(f"unsupported assignment target: {type(target).__name__}")

    # -- control flow -------------------------------------------------------
    def _process_if(self, block: Block, s: ast.If, rest: list[ast.stmt], cont) -> None:
        cond = self.expr(block, s.test)
        assigned = _assigned_names([*s.body, *s.orelse])
        after = Graph(f"{block.graph.name}:after_if")
        ablock = Block(after, block, self)
        for n in assigned:
            ablock.bind(n, after.add_parameter(n))

        tb = Graph(f"{block.graph.name}:if_true")
        self.process_stmts(Block(tb, block, self), list(s.body), (after, assigned))
        fb = Graph(f"{block.graph.name}:if_false")
        self.process_stmts(Block(fb, block, self), list(s.orelse), (after, assigned))

        sel = block.graph.apply(P.switch, cond, Constant(tb), Constant(fb))
        block.graph.set_return(block.graph.apply(sel))
        self.process_stmts(ablock, rest, cont)

    def _process_while(self, block: Block, s: ast.While, rest: list[ast.stmt], cont) -> None:
        if s.orelse:
            raise MyiaSyntaxError("while/else is not supported")
        loop_names = _assigned_names(s.body)
        header = Graph(f"{block.graph.name}:while_header")
        hblock = Block(header, block, self)
        for n in loop_names:
            hblock.bind(n, header.add_parameter(n))

        # enter the loop
        entry_args = [self._read_or_none(block, n) for n in loop_names]
        block.graph.set_return(block.graph.apply(Constant(header), *entry_args))

        cond = self.expr(hblock, s.test)
        after = Graph(f"{block.graph.name}:after_while")
        ablock = Block(after, hblock, self)

        body_g = Graph(f"{block.graph.name}:while_body")
        self.loop_stack.append(_LoopCtx(header, loop_names, Constant(after)))
        try:
            # body falls through -> loop back to header
            self.process_stmts(Block(body_g, hblock, self), list(s.body), (header, loop_names))
        finally:
            self.loop_stack.pop()
        sel = header.apply(P.switch, cond, Constant(body_g), Constant(after))
        header.set_return(header.apply(sel))

        self.process_stmts(ablock, rest, cont)

    def _process_for(self, block: Block, s: ast.For, rest: list[ast.stmt], cont) -> None:
        if s.orelse:
            raise MyiaSyntaxError("for/else is not supported")
        if not (
            isinstance(s.iter, ast.Call)
            and isinstance(s.iter.func, ast.Name)
            and s.iter.func.id == "range"
        ):
            raise MyiaSyntaxError("only `for i in range(...)` loops are supported")
        if not isinstance(s.target, ast.Name):
            raise MyiaSyntaxError("for loop target must be a simple name")
        ivar = s.target.id
        rargs = [self.expr(block, a) for a in s.iter.args]
        if len(rargs) == 1:
            start, stop, step = Constant(0), rargs[0], Constant(1)
        elif len(rargs) == 2:
            start, stop, step = rargs[0], rargs[1], Constant(1)
        elif len(rargs) == 3:
            start, stop, step = rargs
        else:
            raise MyiaSyntaxError("range() takes 1-3 arguments")

        body_names = _assigned_names(s.body)
        loop_names = [ivar] + [n for n in body_names if n != ivar]
        header = Graph(f"{block.graph.name}:for_header")
        hblock = Block(header, block, self)
        for n in loop_names:
            hblock.bind(n, header.add_parameter(n))

        entry_args = [start] + [self._read_or_none(block, n) for n in loop_names[1:]]
        block.graph.set_return(block.graph.apply(Constant(header), *entry_args))

        i_node = hblock.read(ivar)
        if isinstance(step, Constant) and isinstance(step.value, int) and step.value < 0:
            cond = header.apply(P.gt, i_node, stop)
        else:
            cond = header.apply(P.lt, i_node, stop)

        after = Graph(f"{block.graph.name}:after_for")
        ablock = Block(after, hblock, self)

        # `incr` shim: bump the induction variable, jump back to the header
        incr = Graph(f"{block.graph.name}:for_incr")
        inc_params = [incr.add_parameter(n) for n in loop_names]
        next_i = incr.apply(P.add, inc_params[0], step)
        incr.set_return(incr.apply(Constant(header), next_i, *inc_params[1:]))

        body_g = Graph(f"{block.graph.name}:for_body")
        self.loop_stack.append(_LoopCtx(incr, loop_names, Constant(after)))
        try:
            self.process_stmts(Block(body_g, hblock, self), list(s.body), (incr, loop_names))
        finally:
            self.loop_stack.pop()
        sel = header.apply(P.switch, cond, Constant(body_g), Constant(after))
        header.set_return(header.apply(sel))

        self.process_stmts(ablock, rest, cont)

    # -- expressions -----------------------------------------------------------
    def expr(self, block: Block, e: ast.expr) -> Node:
        g = block.graph
        if isinstance(e, ast.Constant):
            if isinstance(e.value, (int, float, bool, str)) or e.value is None:
                return Constant(e.value)
            raise MyiaSyntaxError(f"unsupported constant: {e.value!r}")
        if isinstance(e, ast.Name):
            return block.read(e.id)
        if isinstance(e, ast.BinOp):
            # x ** <int literal> → integer_pow: its backpropagator has no
            # log term, so it is NaN-safe for negative bases (like jax)
            if (
                isinstance(e.op, ast.Pow)
                and isinstance(e.right, ast.Constant)
                and isinstance(e.right.value, int)
                and not isinstance(e.right.value, bool)
            ):
                return g.apply(P.integer_pow, self.expr(block, e.left), Constant(e.right.value))
            op = _BINOPS.get(type(e.op))
            if op is None:
                raise MyiaSyntaxError(f"unsupported operator: {type(e.op).__name__}")
            return g.apply(op, self.expr(block, e.left), self.expr(block, e.right))
        if isinstance(e, ast.UnaryOp):
            if isinstance(e.op, ast.USub):
                return g.apply(P.neg, self.expr(block, e.operand))
            if isinstance(e.op, ast.UAdd):
                return self.expr(block, e.operand)
            if isinstance(e.op, ast.Not):
                return g.apply(P.bool_not, self.expr(block, e.operand))
            raise MyiaSyntaxError(f"unsupported unary op: {type(e.op).__name__}")
        if isinstance(e, ast.Compare):
            left = self.expr(block, e.left)
            result = None
            for op, comparator in zip(e.ops, e.comparators):
                prim = _CMPOPS.get(type(op))
                if prim is None:
                    raise MyiaSyntaxError(f"unsupported comparison: {type(op).__name__}")
                right = self.expr(block, comparator)
                c = g.apply(prim, left, right)
                result = c if result is None else g.apply(P.bool_and, result, c)
                left = right
            return result
        if isinstance(e, ast.BoolOp):
            # short-circuit via switch over thunks (lazy rhs)
            node = self.expr(block, e.values[0])
            for v in e.values[1:]:
                rhs = self.make_thunk(block, v, "bool_rhs")
                keep = Graph("bool_lhs")
                keep.set_return(node)
                if isinstance(e.op, ast.And):
                    sel = g.apply(P.switch, node, Constant(rhs), Constant(keep))
                else:
                    sel = g.apply(P.switch, node, Constant(keep), Constant(rhs))
                node = g.apply(sel)
            return node
        if isinstance(e, ast.IfExp):
            cond = self.expr(block, e.test)
            t = self.make_thunk(block, e.body, "ifexp_true")
            f = self.make_thunk(block, e.orelse, "ifexp_false")
            sel = g.apply(P.switch, cond, Constant(t), Constant(f))
            return g.apply(sel)
        if isinstance(e, ast.Call):
            return self._process_call(block, e)
        if isinstance(e, ast.Tuple):
            return g.apply(P.make_tuple, *[self.expr(block, x) for x in e.elts])
        if isinstance(e, ast.Subscript):
            val = self.expr(block, e.value)
            if isinstance(e.slice, ast.Slice):
                raise MyiaSyntaxError("slicing is not supported; use slice_axis()")
            idx = self.expr(block, e.slice)
            return g.apply(P.tuple_getitem, val, idx)
        if isinstance(e, ast.Attribute):
            if isinstance(e.value, ast.Name):
                # module attribute access (np.float32, jnp.float32, ...)
                try:
                    base_val = None
                    if e.value.id in self.closure_vars:
                        base_val = self.closure_vars[e.value.id]
                    elif e.value.id in self.globals:
                        base_val = self.globals[e.value.id]
                    if isinstance(base_val, types.ModuleType):
                        return self.value_to_node(getattr(base_val, e.attr), e.attr)
                except AttributeError:
                    pass
            base = self.expr(block, e.value)
            if e.attr in _ATTRS:
                return g.apply(_ATTRS[e.attr], base)
            if e.attr == "ndim":
                return g.apply(P.tuple_len, g.apply(P.shape, base))
            raise MyiaSyntaxError(f"unsupported attribute: .{e.attr}")
        if isinstance(e, ast.Lambda):
            return Constant(self.process_function(e, block))
        raise MyiaSyntaxError(f"unsupported expression: {type(e).__name__}")

    def _static_value(self, e: ast.expr) -> tuple[bool, Any]:
        """Resolve an expression to a Python value at parse time if it is a
        plain global/closure name or a module attribute chain."""
        if isinstance(e, ast.Name):
            if e.id in self.closure_vars:
                return True, self.closure_vars[e.id]
            if e.id in self.globals:
                return True, self.globals[e.id]
            return False, None
        if isinstance(e, ast.Attribute):
            ok, base = self._static_value(e.value)
            if ok and isinstance(base, types.ModuleType) and hasattr(base, e.attr):
                return True, getattr(base, e.attr)
            return False, None
        return False, None

    def _process_call(self, block: Block, e: ast.Call) -> Node:
        if e.keywords:
            raise MyiaSyntaxError("keyword arguments are not supported")
        for a in e.args:
            if isinstance(a, ast.Starred):
                raise MyiaSyntaxError("star-args are not supported")
        # macro expansion (e.g. grad) — parse-time, per paper Fig. 1
        ok, val = self._static_value(e.func)
        if ok and getattr(val, "__is_myia_macro__", False):
            return val.__myia_macro_expand__(self, block, e.args)
        fn = self.expr(block, e.func)
        args = [self.expr(block, a) for a in e.args]
        return block.graph.apply(fn, *args)


def parse_function(fn: Callable) -> Graph:
    """Parse a Python function into the IR (cached by function object).

    The shell graph is registered in the cache BEFORE parsing the body, so
    module-level mutual recursion (f referencing g referencing f through
    their globals) resolves to the in-progress graph instead of looping."""
    from repro_torch.obs import trace as obs_trace

    key = getattr(fn, "__wrapped__", fn)
    if key in _PARSE_CACHE:
        return _PARSE_CACHE[key]
    g = Graph(getattr(key, "__name__", "<fn>"))
    _PARSE_CACHE[key] = g
    try:
        with obs_trace.span("parse", fn=g.name):
            Parser(key).parse(target=g)
    except BaseException:
        _PARSE_CACHE.pop(key, None)  # don't cache a half-parsed shell
        raise
    return g
