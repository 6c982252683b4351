"""Type / shape / value inference (paper §4.2).

"When a Myia function is called, we use the types of the user-provided
arguments as a starting point for type inference … No type annotations are
required, even when using higher order functions … The inferrer operates on
an untyped version of the IR.  It can infer types as well as values
(constant propagation) and shapes."

Implementation: abstract interpretation over the IR.

* Abstract domain: scalars (with optional known value — value inference
  doubles as constant propagation), arrays (dtype × shape), tuples,
  functions (sets of abstract closures), gradient environments.
* Calls are memoized per ``(graph, argument signature, free-variable
  signature)`` — the call-site specialization of the paper.  Recursion hits
  an in-flight signature and iterates to a least fixpoint from ⊥.
* Loops (tail-recursive headers) converge because scalar values are
  *widened* to unknown when a signature re-enters with different values.
* Array primitives default to abstract evaluation of their torch
  implementations on meta-device tensors (the reference's
  ``jax.eval_shape``) — the registry needs no per-primitive shape rules.

The paper used coroutines for the same semantics; a fixpoint evaluator is
easier to verify (see DESIGN.md §7).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import primitives as P
from .ir import Apply, Constant, Graph, Node, Parameter, free_variables
from .dtypes import np_dtype, torch_dtype
from .primitives import Primitive
from .values import Closure, EnvInstance, SymbolicKey

__all__ = [
    "AScalar",
    "AArray",
    "ATuple",
    "AFunction",
    "AEnv",
    "BOTTOM",
    "ANY",
    "InferenceError",
    "abstract_of_value",
    "infer",
    "Inferencer",
]


class InferenceError(Exception):
    pass


class _Any:
    def __repr__(self) -> str:
        return "ANY"


ANY = _Any()


class AbstractValue:
    pass


class _Bottom(AbstractValue):
    def __repr__(self) -> str:
        return "⊥"


BOTTOM = _Bottom()


class AScalar(AbstractValue):
    """Python-level scalar: int/float/bool/str/none/dtype/key/opaque."""

    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: Any = ANY) -> None:
        self.kind = kind
        self.value = value

    def known(self) -> bool:
        return self.value is not ANY

    def __eq__(self, o: object) -> bool:
        return isinstance(o, AScalar) and o.kind == self.kind and _veq(o.value, self.value)

    def __hash__(self) -> int:
        try:
            return hash((self.kind, self.value))
        except TypeError:
            return hash(self.kind)

    def __repr__(self) -> str:
        v = "" if self.value is ANY else f"={self.value!r}"
        return f"{self.kind}{v}"


def _veq(a: Any, b: Any) -> bool:
    if a is ANY or b is ANY:
        return a is b
    try:
        return bool(a == b)
    except Exception:
        return a is b


class AArray(AbstractValue):
    __slots__ = ("dtype", "shape")

    def __init__(self, dtype: Any, shape: tuple[int, ...]) -> None:
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(s) for s in shape)

    def __eq__(self, o: object) -> bool:
        return isinstance(o, AArray) and o.dtype == self.dtype and o.shape == self.shape

    def __hash__(self) -> int:
        return hash((self.dtype, self.shape))

    def __repr__(self) -> str:
        return f"{self.dtype.name}{list(self.shape)}"


class ATuple(AbstractValue):
    __slots__ = ("elements",)

    def __init__(self, elements: tuple[AbstractValue, ...]) -> None:
        self.elements = tuple(elements)

    def __eq__(self, o: object) -> bool:
        return isinstance(o, ATuple) and o.elements == self.elements

    def __hash__(self) -> int:
        return hash(self.elements)

    def __repr__(self) -> str:
        return f"({', '.join(map(repr, self.elements))})"


class AClosureSpec:
    """A graph + the frame that resolves its free variables (abstractly)."""

    __slots__ = ("graph", "frame")

    def __init__(self, graph: Graph, frame: "_AFrame | None") -> None:
        self.graph = graph
        self.frame = frame

    def __repr__(self) -> str:
        return f"<aclosure {self.graph.name}>"


class AFunction(AbstractValue):
    __slots__ = ("options",)

    def __init__(self, options: tuple) -> None:  # Primitive | AClosureSpec
        self.options = tuple(options)

    def __eq__(self, o: object) -> bool:
        return isinstance(o, AFunction) and _fn_ids(o.options) == _fn_ids(self.options)

    def __hash__(self) -> int:
        return hash(_fn_ids(self.options))

    def __repr__(self) -> str:
        return f"fn{{{', '.join(map(repr, self.options))}}}"


def _fn_ids(opts: tuple) -> frozenset:
    out = set()
    for o in opts:
        if isinstance(o, AClosureSpec):
            out.add(("g", id(o.graph)))
        else:
            out.add(("p", id(o)))
    return frozenset(out)


class AEnv(AbstractValue):
    def __eq__(self, o: object) -> bool:
        return isinstance(o, AEnv)

    def __hash__(self) -> int:
        return hash("AEnv")

    def __repr__(self) -> str:
        return "env"


_AENV = AEnv()


def abstract_of_value(v: Any) -> AbstractValue:
    if isinstance(v, bool):
        return AScalar("bool", v)
    if isinstance(v, int):
        return AScalar("int", v)
    if isinstance(v, float):
        return AScalar("float", v)
    if isinstance(v, str):
        return AScalar("str", v)
    if v is None:
        return AScalar("none", None)
    if isinstance(v, np.dtype):
        return AScalar("dtype", v)
    if isinstance(v, type):
        return AScalar("dtype", np.dtype(v)) if _is_dtype_like(v) else AScalar("opaque", ANY)
    if isinstance(v, SymbolicKey):
        return AScalar("key", v)
    if isinstance(v, EnvInstance):
        return _AENV
    if isinstance(v, tuple):
        return ATuple(tuple(abstract_of_value(x) for x in v))
    if isinstance(v, torch.Tensor):  # a meta tensor is the ShapeDtypeStruct
        return AArray(np_dtype(v.dtype), tuple(v.shape))
    if isinstance(v, (np.ndarray, np.generic)):
        return AArray(v.dtype, np.shape(v))
    if isinstance(v, Graph):
        return AFunction((AClosureSpec(v, None),))
    if isinstance(v, Primitive):
        return AFunction((v,))
    if isinstance(v, Closure):
        return AFunction((AClosureSpec(v.graph, None),))
    raise InferenceError(f"no abstract value for {type(v)}")


def _is_dtype_like(v: type) -> bool:
    try:
        np.dtype(v)
        return True
    except TypeError:
        return False


# ---------------------------------------------------------------------------
# Join (least upper bound)
# ---------------------------------------------------------------------------


def join(a: AbstractValue, b: AbstractValue) -> AbstractValue:
    if a is BOTTOM:
        return b
    if b is BOTTOM:
        return a
    if a == b:
        return a
    if isinstance(a, AScalar) and isinstance(b, AScalar) and a.kind == b.kind:
        return AScalar(a.kind)
    if isinstance(a, AScalar) and isinstance(b, AScalar):
        # int/float widening (python semantics would promote at runtime)
        if {a.kind, b.kind} <= {"int", "float", "bool"}:
            return AScalar("float" if "float" in (a.kind, b.kind) else "int")
    if isinstance(a, ATuple) and isinstance(b, ATuple) and len(a.elements) == len(b.elements):
        return ATuple(tuple(join(x, y) for x, y in zip(a.elements, b.elements)))
    if isinstance(a, AFunction) and isinstance(b, AFunction):
        seen = dict()
        for o in (*a.options, *b.options):
            seen[_fn_ids((o,))] = o
        return AFunction(tuple(seen.values()))
    if isinstance(a, AEnv) and isinstance(b, AEnv):
        return _AENV
    if (
        isinstance(a, AArray) and isinstance(b, AArray)
        and a.dtype == b.dtype and a.shape == b.shape
    ):
        return a
    # scalar/0-d array mixing (jnp promotes python scalars to weak arrays)
    if isinstance(a, AArray) and isinstance(b, AScalar) and b.kind in ("int", "float", "bool"):
        return a
    if isinstance(b, AArray) and isinstance(a, AScalar) and a.kind in ("int", "float", "bool"):
        return b
    raise InferenceError(f"cannot join {a!r} and {b!r}")


# ---------------------------------------------------------------------------
# The inferencer
# ---------------------------------------------------------------------------


class _AFrame:
    __slots__ = ("graph", "values")

    def __init__(self, graph: Graph) -> None:
        self.graph = graph
        self.values: dict[int, AbstractValue] = {}


def _sig(abs_list: tuple) -> tuple:
    return tuple(abs_list)


class Inferencer:
    def __init__(self, max_fixpoint_iters: int = 25, max_depth: int = 300) -> None:
        self.memo: dict[tuple, AbstractValue] = {}
        self.inflight: dict[tuple, AbstractValue] = {}
        self.inflight_graphs: dict[int, int] = {}  # graph id -> inflight count
        self.max_fixpoint_iters = max_fixpoint_iters
        self.max_depth = max_depth
        self.depth = 0
        self._fv_cache: dict[int, list[Node]] = {}
        #: per-active-call sets of inflight keys whose *approximations* were
        #: read — results depending on one may not be memoized (unsound until
        #: the enclosing fixpoint settles).
        self._dep_stack: list[set] = []

    def _read_inflight(self, key: tuple) -> AbstractValue:
        for deps in self._dep_stack:
            deps.add(key)
        return self.inflight[key]

    # -- public ------------------------------------------------------------
    def infer_graph(self, g: Graph, args: tuple[AbstractValue, ...]) -> AbstractValue:
        return self._call_closure(AClosureSpec(g, None), tuple(args))

    # -- helpers -----------------------------------------------------------
    def _fvs(self, g: Graph) -> list[Node]:
        if g._id not in self._fv_cache:
            self._fv_cache[g._id] = free_variables(g)
        return self._fv_cache[g._id]

    def _call_closure(self, clos: AClosureSpec, args: tuple) -> AbstractValue:
        g = clos.graph
        if len(args) != len(g.parameters):
            raise InferenceError(
                f"{g.name} expects {len(g.parameters)} args, got {len(args)}"
            )
        fv_nodes = self._fvs(g)
        fv_abs = []
        for v in fv_nodes:
            if clos.frame is None:
                raise InferenceError(
                    f"closure {g.name} needs free variable {v!r} but has no frame"
                )
            fv_abs.append(self._eval(v, clos.frame))
        key = (id(g), _sig(args), _sig(tuple(fv_abs)))
        if key in self.memo:
            return self.memo[key]
        if key in self.inflight:
            return self._read_inflight(key)

        # Widening: re-entering an already-inflight graph with a *different*
        # signature (a loop header counting 0,1,2,… or recursion on a known
        # scalar) would specialize forever.  Drop known scalar values from
        # the recursive signature so it reaches a stable key.
        if self.inflight_graphs.get(id(g), 0) > 0:
            wargs = tuple(_widen(a) for a in args)
            if wargs != args:
                args = wargs
                key = (id(g), _sig(args), _sig(tuple(fv_abs)))
                if key in self.memo:
                    return self.memo[key]
                if key in self.inflight:
                    return self._read_inflight(key)

        self.inflight[key] = BOTTOM
        self.inflight_graphs[id(g)] = self.inflight_graphs.get(id(g), 0) + 1
        self.depth += 1
        if self.depth > self.max_depth:
            raise InferenceError("inference recursion too deep (widening failed?)")
        deps: set = set()
        self._dep_stack.append(deps)
        try:
            for _ in range(self.max_fixpoint_iters):
                frame = _AFrame(g)
                for p, a in zip(g.parameters, args):
                    frame.values[p._id] = a
                    p.abstract = _merge_annot(p.abstract, a)
                for v, a in zip(fv_nodes, fv_abs):
                    frame.values[v._id] = a
                res = self._eval(g.return_, frame)
                prev = self.inflight[key]
                merged = join(prev, res)
                if merged == prev:
                    # Stable — including stable-at-⊥, which means the result
                    # hinges on an *enclosing* inflight call; return ⊥ and
                    # let that outer fixpoint iterate.
                    break
                self.inflight[key] = merged
            else:
                raise InferenceError(f"fixpoint did not converge for {g.name}")
            result = self.inflight[key]
        finally:
            self._dep_stack.pop()
            self.depth -= 1
            self.inflight.pop(key, None)
            self.inflight_graphs[id(g)] -= 1
        # Memoize only if the result did not consult an approximation that is
        # *still* being refined by an enclosing fixpoint.
        deps.discard(key)
        if result is not BOTTOM and not any(d in self.inflight for d in deps):
            self.memo[key] = result
        return result

    def _eval(self, node: Node, frame: _AFrame) -> AbstractValue:
        if node._id in frame.values:
            return frame.values[node._id]
        if isinstance(node, Constant):
            v = node.value
            if isinstance(v, Graph):
                ab: AbstractValue = AFunction((AClosureSpec(v, frame),))
            elif isinstance(v, Primitive):
                ab = AFunction((v,))
            else:
                ab = abstract_of_value(v)
            node.abstract = _merge_annot(node.abstract, ab)
            return ab
        if isinstance(node, Parameter):
            raise InferenceError(f"unbound parameter {node!r} during inference")
        assert isinstance(node, Apply)
        fnab = self._eval(node.fn, frame)
        argabs = tuple(self._eval(a, frame) for a in node.args)
        ab = self._apply(fnab, argabs, frame)
        frame.values[node._id] = ab
        node.abstract = _merge_annot(node.abstract, ab)
        return ab

    def _apply(self, fnab: AbstractValue, args: tuple, frame: _AFrame) -> AbstractValue:
        if fnab is BOTTOM or any(a is BOTTOM for a in args):
            return BOTTOM
        if not isinstance(fnab, AFunction):
            raise InferenceError(f"calling a non-function: {fnab!r}")
        result: AbstractValue = BOTTOM
        for opt in fnab.options:
            if isinstance(opt, Primitive):
                r = self._apply_prim(opt, args, frame)
            else:
                r = self._call_closure(opt, args)
            result = join(result, r)
        return result

    # -- primitives ---------------------------------------------------------
    def _apply_prim(self, p: Primitive, args: tuple, frame: _AFrame) -> AbstractValue:
        rule = _STRUCTURAL_RULES.get(p.name)
        if rule is not None:
            return rule(self, args, frame)

        # full constant propagation when every argument value is known
        if all(_is_concrete(a) for a in args):
            try:
                return abstract_of_value(p.impl(*[_concrete(a) for a in args]))
            except InferenceError:
                raise
            except Exception as e:
                raise InferenceError(f"{p.name} failed during value inference: {e}")

        # The abstract result is a pure function of (prim, arg abstracts):
        # memoize process-wide — adjoint graphs apply the same prim at the
        # same signature hundreds of times.
        try:
            cache_key = (id(p), args)
            hash(cache_key)
        except TypeError:
            cache_key = None
        if cache_key is not None:
            hit = _EVAL_SHAPE_MEMO.get(cache_key)
            if hit is not None:
                return hit

        # default: shape inference by running the torch impl on meta-device
        # tensors (the reference's jax.eval_shape).  Known scalars/tuples
        # pass as themselves (axes, dtypes and flags stay static); unknown
        # arrays become meta tensors.  Unknown scalars beside an array become
        # Python stand-ins (torch types them weakly, as jax does); with no
        # array they become 0-d meta tensors, so that no stand-in value is
        # computed with (0 // 0) — the result is demoted to a scalar anyway.
        meta_scalars = not any(_contains_array(a) for a in args)
        merged = [
            _concrete(a) if _is_concrete(a) else _materialize(a, meta_scalars)
            for a in args
        ]
        try:
            out = p.impl(*merged)
        except InferenceError:
            raise
        except Exception as e:
            raise InferenceError(f"shape inference failed for {p.name}{args!r}: {e}")
        ab = _abstract_of_spec(out)
        # Python-scalar in ⇒ Python-scalar out: if no argument carried an
        # array, a 0-d result is a scalar of the promoted kind, not an array.
        if not any(_contains_array(a) for a in args):
            ab = _demote_scalars(ab)
        if cache_key is not None:
            if len(_EVAL_SHAPE_MEMO) > 8192:
                # Evict the oldest half (dict preserves insertion order)
                # instead of wiping: later specializations of the same
                # family re-ask the same (prim, signature) questions, and a
                # full clear turns every one back into a jax trace.
                for k in list(_EVAL_SHAPE_MEMO)[:4096]:
                    del _EVAL_SHAPE_MEMO[k]
            _EVAL_SHAPE_MEMO[cache_key] = ab
        return ab


#: (id(prim), arg abstracts) -> result abstract; see _apply_prim
_EVAL_SHAPE_MEMO: dict[tuple, AbstractValue] = {}

_KIND_OF_DTYPE = {"f": "float", "i": "int", "u": "int", "b": "bool"}


def _contains_array(a: AbstractValue) -> bool:
    if isinstance(a, AArray):
        return True
    if isinstance(a, ATuple):
        return any(_contains_array(e) for e in a.elements)
    return False


def _demote_scalars(ab: AbstractValue) -> AbstractValue:
    if isinstance(ab, ATuple):
        return ATuple(tuple(_demote_scalars(e) for e in ab.elements))
    if isinstance(ab, AArray) and ab.shape == ():
        kind = _KIND_OF_DTYPE.get(ab.dtype.kind)
        if kind is not None:
            return AScalar(kind)
    return ab


def _widen(a: AbstractValue) -> AbstractValue:
    """Forget known int/float/bool values (keep structure-relevant kinds:
    str/none/dtype/key stay concrete — they select code paths)."""
    if isinstance(a, AScalar) and a.known() and a.kind in ("int", "float", "bool"):
        return AScalar(a.kind)
    if isinstance(a, ATuple):
        return ATuple(tuple(_widen(e) for e in a.elements))
    return a


def _merge_annot(old: AbstractValue | None, new: AbstractValue) -> AbstractValue | None:
    if old is None or old is BOTTOM:
        return new
    try:
        return join(old, new)
    except InferenceError:
        return None  # polymorphic reuse: drop annotation (sound)


def _is_concrete(a: AbstractValue) -> bool:
    if isinstance(a, AScalar):
        return a.known()
    if isinstance(a, ATuple):
        return all(_is_concrete(e) for e in a.elements)
    return False


def _concrete(a: AbstractValue) -> Any:
    if isinstance(a, AScalar):
        return a.value
    if isinstance(a, ATuple):
        return tuple(_concrete(e) for e in a.elements)
    raise InferenceError("not concrete")


_SCALAR_DTYPE = {"float": torch.float32, "int": torch.int32, "bool": torch.bool}


def _materialize(a: AbstractValue, meta_scalars: bool = False) -> Any:
    """Stand-in runtime value for abstract evaluation: a meta tensor for an
    array; for an unknown scalar a Python scalar (torch types it weakly, as
    jax types a Python scalar traced by eval_shape), or with ``meta_scalars``
    a 0-d meta tensor of its default type."""
    if isinstance(a, AArray):
        return torch.empty(a.shape, dtype=torch_dtype(a.dtype), device="meta")
    if isinstance(a, AScalar):
        if a.known():
            return a.value
        if meta_scalars and a.kind in _SCALAR_DTYPE:
            return torch.empty((), dtype=_SCALAR_DTYPE[a.kind], device="meta")
        if a.kind == "float":
            return 0.0  # value cannot affect shapes/dtypes
        if a.kind == "bool":
            return False
        if a.kind == "int":
            # ints may be shape-relevant; unknown int in an array prim is
            # almost always a runtime index (take etc.) where 0 is safe
            return 0
        if a.kind == "none":
            return None
        if a.kind == "dtype":
            raise InferenceError("unknown dtype at inference time")
        raise InferenceError(f"cannot materialize scalar kind {a.kind}")
    if isinstance(a, ATuple):
        return tuple(_materialize(e, meta_scalars) for e in a.elements)
    raise InferenceError(f"cannot materialize {a!r}")


#: the array jax.eval_shape makes of a Python scalar result (weakly typed)
_PY_RESULT_DTYPE = {bool: "bool", int: "int32", float: "float32"}


def _abstract_of_spec(out: Any) -> AbstractValue:
    """The abstract of an abstract evaluation's result.  As under
    jax.eval_shape, a Python scalar result is a 0-d array of its default
    type (its value is not known: it was computed from stand-ins); the
    caller demotes it to a scalar when no argument carried an array."""
    if isinstance(out, tuple):
        return ATuple(tuple(_abstract_of_spec(o) for o in out))
    if isinstance(out, torch.Tensor):
        return AArray(np_dtype(out.dtype), tuple(out.shape))
    dt = _PY_RESULT_DTYPE.get(type(out))
    if dt is not None:
        return AArray(dt, ())
    return abstract_of_value(out)


# ---------------------------------------------------------------------------
# Structural rules
# ---------------------------------------------------------------------------


def _r_make_tuple(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    return ATuple(args)


def _r_tuple_getitem(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    t, i = args
    if isinstance(t, ATuple):
        if isinstance(i, AScalar) and i.known():
            return t.elements[i.value]
        out: AbstractValue = BOTTOM
        for e in t.elements:
            out = join(out, e)
        return out
    raise InferenceError(f"tuple_getitem on {t!r}")


def _r_tuple_setitem(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    t, i, v = args
    if isinstance(t, ATuple) and isinstance(i, AScalar) and i.known():
        elts = list(t.elements)
        elts[i.value] = v
        return ATuple(tuple(elts))
    raise InferenceError("tuple_setitem needs a tuple and a known index")


def _r_tuple_len(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    (t,) = args
    if isinstance(t, ATuple):
        return AScalar("int", len(t.elements))
    raise InferenceError(f"len of {t!r}")


def _r_shape(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    (x,) = args
    if isinstance(x, AArray):
        return ATuple(tuple(AScalar("int", int(d)) for d in x.shape))
    if isinstance(x, AScalar) and x.kind in ("int", "float", "bool"):
        return ATuple(())
    raise InferenceError(f"shape of {x!r}")


def _r_dtype_of(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    (x,) = args
    if isinstance(x, AArray):
        return AScalar("dtype", x.dtype)
    if isinstance(x, AScalar) and x.known():
        return AScalar("dtype", P.dtype_of.impl(x.value))
    if isinstance(x, AScalar) and x.kind == "int":
        return AScalar("dtype", np.dtype("int32"))
    if isinstance(x, AScalar) and x.kind == "float":
        return AScalar("dtype", np.dtype("float32"))
    raise InferenceError(f"dtype_of {x!r}")


def _contains_fn_or_env(a: AbstractValue) -> bool:
    if isinstance(a, (AFunction, AEnv)):
        return True
    if isinstance(a, ATuple):
        return any(_contains_fn_or_env(e) for e in a.elements)
    return False


def _r_switch(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    c, t, f = args
    if isinstance(c, AScalar) and c.known():
        return t if c.value else f
    if isinstance(c, AScalar):
        return join(t, f)
    if isinstance(c, AArray):
        if _contains_fn_or_env(t) or _contains_fn_or_env(f):
            # selecting between closures on a traced (0-d array) condition
            # — e.g. a loop header whose bound is an array: the branches
            # cannot be materialized for jnp.where, but the result is just
            # their join (both control paths stay live for inference)
            return join(t, f)
        out = P.where.impl(  # elementwise select
            _materialize(c), _materialize(t), _materialize(f)
        )
        return _abstract_of_spec(out)
    raise InferenceError(f"switch on {c!r}")


def _r_zeros_like(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    (x,) = args
    if isinstance(x, AFunction):
        return _AENV
    if isinstance(x, AEnv):
        return _AENV
    if isinstance(x, ATuple):
        return ATuple(tuple(_r_zeros_like(inf, (e,), frame) for e in x.elements))
    if isinstance(x, AScalar):
        if x.kind in ("int", "float", "bool"):
            return AScalar(x.kind, {"int": 0, "float": 0.0, "bool": False}[x.kind])
        return AScalar("none", None)
    if isinstance(x, AArray):
        return x
    raise InferenceError(f"zeros_like {x!r}")


def _r_gadd(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    a, b = args
    if isinstance(a, AEnv) or isinstance(b, AEnv):
        return _AENV
    if isinstance(a, AScalar) and a.kind == "none":
        return b
    if isinstance(b, AScalar) and b.kind == "none":
        return a
    if isinstance(a, ATuple) and isinstance(b, ATuple):
        return ATuple(tuple(_r_gadd(inf, (x, y), frame) for x, y in zip(a.elements, b.elements)))
    out = P.gadd.impl(_materialize(a), _materialize(b))
    return _abstract_of_spec(out)


def _r_env_setitem(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    return _AENV


def _r_env_getitem(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    return args[2]  # the default has the right abstract (zeros_like of target)


def _r_stop_gradient(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    return args[0]


def _widen_value(a: AbstractValue) -> AbstractValue:
    """Collectives preserve shape/dtype but NOT the value (psum of a known
    scalar is value × devices) — drop known scalar values so constant
    propagation can never fold across a resharding point."""
    if isinstance(a, AArray):
        return a
    if isinstance(a, AScalar):
        return AScalar(a.kind)
    raise InferenceError(f"collective on non-numeric {a!r}")


def _r_psum_axes(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    return _widen_value(args[0])


def _r_all_gather_axes(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    x, _axes, dim, sizes = args
    if not (isinstance(x, AArray) and _is_concrete(dim) and _is_concrete(sizes)):
        raise InferenceError(f"all_gather_axes needs an array and static config: {args!r}")
    d = _concrete(dim)
    factor = int(np.prod(_concrete(sizes)))
    shp = list(x.shape)
    shp[d] = shp[d] * factor
    return AArray(x.dtype, tuple(shp))


def _r_shard_slice(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    x, _axes, dim, sizes = args
    if not (isinstance(x, AArray) and _is_concrete(dim) and _is_concrete(sizes)):
        raise InferenceError(f"shard_slice needs an array and static config: {args!r}")
    d = _concrete(dim)
    factor = int(np.prod(_concrete(sizes)))
    shp = list(x.shape)
    if shp[d] % factor != 0:
        raise InferenceError(f"shard_slice: dim {d} of {x!r} not divisible by {factor}")
    shp[d] = shp[d] // factor
    return AArray(x.dtype, tuple(shp))


def _loop_exit_closure(exit_ab: AbstractValue) -> AClosureSpec:
    if (
        isinstance(exit_ab, AFunction)
        and len(exit_ab.options) == 1
        and isinstance(exit_ab.options[0], AClosureSpec)
    ):
        return exit_ab.options[0]
    raise InferenceError(f"loop exit must be a single closed graph, got {exit_ab!r}")


def _annotate_loop_bodies(inf: Inferencer, subs: tuple, rest: tuple) -> None:
    """Infer through a loop's cond/step closures for the annotation side
    effect: their interior nodes (including *nested* loop applies emitted
    by the while-adjoint's replay recomputation) need abstracts so a later
    J pass can differentiate them (reverse-over-reverse).  Best-effort —
    the loop's own result type comes from the exit graph alone."""
    for s in subs:
        try:
            inf._call_closure(_loop_exit_closure(s), rest)
        except InferenceError:
            pass


def _r_while_loop(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    # (cond, step, exit, n_carry, *carry_and_extras).  The carry is
    # type-stable but its VALUES iterate — widen before applying the exit
    # graph so constant propagation can never fold across the back-edge.
    exit_spec = _loop_exit_closure(args[2])
    rest = tuple(_widen(a) for a in args[4:])
    _annotate_loop_bodies(inf, args[:2], rest)
    return inf._call_closure(exit_spec, rest)


def _r_scan_loop(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    # (step, exit, length, n_carry, *carry_and_extras)
    exit_spec = _loop_exit_closure(args[1])
    rest = tuple(_widen(a) for a in args[4:])
    _annotate_loop_bodies(inf, args[:1], rest)
    return inf._call_closure(exit_spec, rest)


def _r_cast(inf: Inferencer, args: tuple, frame) -> AbstractValue:
    x, dt = args
    if isinstance(dt, AScalar) and dt.known():
        dtype = np.dtype(dt.value)
        if isinstance(x, AArray):
            return AArray(dtype, x.shape)
        if isinstance(x, AScalar):
            return AArray(dtype, ())
    raise InferenceError("cast needs a known dtype")


_STRUCTURAL_RULES = {
    "make_tuple": _r_make_tuple,
    "tuple_getitem": _r_tuple_getitem,
    "tuple_setitem": _r_tuple_setitem,
    "tuple_len": _r_tuple_len,
    "shape": _r_shape,
    "dtype_of": _r_dtype_of,
    "switch": _r_switch,
    "zeros_like": _r_zeros_like,
    "gadd": _r_gadd,
    "env_setitem": _r_env_setitem,
    "env_getitem": _r_env_getitem,
    "stop_gradient": _r_stop_gradient,
    "cast": _r_cast,
    # SPMD collectives: axis names are unbound outside shard_map, so the
    # eval_shape default would fail — shapes are derived structurally
    "psum_axes": _r_psum_axes,
    "pmax_axes": _r_psum_axes,
    "all_gather_axes": _r_all_gather_axes,
    "shard_slice": _r_shard_slice,
    # structured loops (repro_torch.core.closure): carry-widened exit application
    "while_loop": _r_while_loop,
    "scan_loop": _r_scan_loop,
}


def infer(graph: Graph, *args: Any) -> AbstractValue:
    """Infer output abstract of ``graph`` for ``args`` (abstract values, or
    runtime values / meta tensors which are converted).  Annotates the
    graph family's nodes with inferred abstracts as a side effect."""
    from repro_torch.obs import trace as obs_trace

    abs_args = tuple(
        a if isinstance(a, AbstractValue) else abstract_of_value(a) for a in args
    )
    with obs_trace.span("infer", graph=graph.name):
        return Inferencer().infer_graph(graph, abs_args)
