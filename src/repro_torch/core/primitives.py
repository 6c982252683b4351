"""Primitive operations of the IR, implemented in PyTorch.

The port of ``repro/core/primitives.py``: the same primitive names, the
same backpropagators (Myia-subset Python, parsed lazily into IR graphs by
the frontend, so reverse-over-reverse works) and the same structural
inference rules, with torch implementations in place of ``jnp``:

* ``impl`` — the runtime implementation, with Python-scalar fast paths so
  that loop counters stay concrete and control flow can unroll.  Results
  carry the reference's dtypes: Python floats compute as ``float32`` and
  ints as ``int32``, and 64-bit results are narrowed as jax narrows them
  with 64-bit mode off (:func:`repro_torch.core.dtypes.canon`).  ``take``,
  ``index_add`` and ``one_hot`` keep jnp's semantics for out-of-range
  indices (fill, drop, zero row), negative indices included.
* ``bprop`` — its backpropagator definition (paper §3.2: "The
  backpropagators of primitives are known").
* an optional ``infer`` rule; array prims default to abstract evaluation
  of the torch ``impl`` on meta-device tensors in the inferencer.

The structured loops run as host loops (the reference traces them into
``lax.while_loop`` / ``lax.scan``).  The SPMD collectives stay registered,
so the names and :data:`COLLECTIVE_NAMES` match the reference, but raise:
the sharded tier is ROADMAP item A9.  Hand-written kernels register
themselves as primitives with their own backpropagators in
``repro_torch.kernels.ops``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from .dtypes import canon, np_dtype, to_tensor, torch_dtype
from .values import EnvInstance, gadd_values, zeros_like_value

__all__ = ["Primitive", "PRIMITIVES", "register_primitive", "COLLECTIVE_NAMES"]

_PY_NUM = (bool, int, float)


def _all_py(*xs: Any) -> bool:
    return all(isinstance(x, _PY_NUM) for x in xs)


class Primitive:
    """A named primitive with implementation + backpropagator definition."""

    def __init__(
        self,
        name: str,
        impl: Callable,
        *,
        bprop: Callable | str | None = None,
        vararg: bool = False,
        infer: Callable | None = None,
    ) -> None:
        self.name = name
        self.impl = impl
        #: Python function (Myia subset) computing input gradients, with
        #: signature ``(x1..xn, out, dout) -> (dx1..dxn)``; the string
        #: "zeros" means all-zero gradients (non-differentiable prim);
        #: None means AD must special-case it (make_tuple, …).
        self.bprop = bprop
        self.vararg = vararg
        self.infer = infer
        self._bprop_graph = None  # parsed lazily by repro_torch.core.ad

    def __call__(self, *args: Any) -> Any:
        return self.impl(*args)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Prim {self.name}>"


PRIMITIVES: dict[str, Primitive] = {}


def register_primitive(
    name: str,
    impl: Callable,
    *,
    bprop: Callable | str | None = None,
    vararg: bool = False,
    infer: Callable | None = None,
) -> Primitive:
    p = Primitive(name, impl, bprop=bprop, vararg=vararg, infer=infer)
    PRIMITIVES[name] = p
    return p


# ===========================================================================
# Implementations
# ===========================================================================


def _arr(x: Any) -> Any:
    """A tensor operand: tensors pass, numpy values and Python scalars become
    tensors of the reference's type (``jnp.asarray``)."""
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _operand(x: Any) -> Any:
    """A binary operand: tensors and Python scalars pass (torch types a Python
    scalar weakly, as jax does); numpy values become tensors."""
    return x if isinstance(x, (torch.Tensor, bool, int, float)) else to_tensor(x)


def _binary(py: Callable, op: Callable) -> Callable:
    def impl(x, y):
        if _all_py(x, y):
            return py(x, y)
        return canon(op(_operand(x), _operand(y)))

    return impl


def _impl_neg(x):
    return -x if _all_py(x) else canon(-_arr(x))


def _tensor_pair(x: Any, y: Any) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands as tensors on one device (for torch ops that take no
    Python scalar); a Python scalar becomes a 0-d tensor beside the other."""
    if isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        return x, _arr(y).to(x.device)
    if isinstance(y, torch.Tensor) and not isinstance(x, torch.Tensor):
        return _arr(x).to(y.device), y
    return _arr(x), _arr(y)


def _cmp(py, op):
    def impl(a, b):
        return py(a, b) if _all_py(a, b) else op(*_tensor_pair(a, b))

    return impl


def _impl_switch(c, t, f):
    if isinstance(c, (bool, np.bool_)):
        return t if c else f
    if isinstance(c, torch.Tensor) and c.numel() == 1:
        return t if bool(c) else f
    # an array condition: only valid for array-like branches
    return _impl_where(c, t, f)


def _impl_shape(x):
    if isinstance(x, _PY_NUM):
        return ()
    return tuple(int(d) for d in x.shape)


def _sum(x: torch.Tensor, axes: tuple | None, keepdims: bool = False) -> torch.Tensor:
    """``jnp.sum``: ``axes=()`` reduces nothing (torch's ``dim=()`` reduces
    everything); integer and bool sums are ``int32``."""
    if axes is not None and len(axes) == 0:
        return x.to(torch.int32) if x.dtype == torch.bool else x
    if axes is None:
        out = torch.sum(x)
        if keepdims:
            out = out.reshape((1,) * x.dim())
    else:
        out = torch.sum(x, dim=tuple(axes), keepdim=keepdims)
    return canon(out)


def _impl_unbroadcast(x, shp):
    shp = tuple(shp)
    if isinstance(x, _PY_NUM):
        return x
    x = _arr(x)
    if shp == ():
        return _sum(x, None)
    ndiff = x.dim() - len(shp)
    if ndiff > 0:
        x = _sum(x, tuple(range(ndiff)))
    axes = tuple(i for i, (a, b) in enumerate(zip(x.shape, shp)) if b == 1 and a != 1)
    if axes:
        x = _sum(x, axes, keepdims=True)
    return x


def _norm_axes(axes, ndim):
    if axes is None:
        return tuple(range(ndim))
    if isinstance(axes, int):
        axes = (axes,)
    return tuple(sorted(a % ndim for a in axes))


def _impl_reduce_sum(x, axes, keepdims):
    return _sum(_arr(x), None if axes is None else tuple(axes), keepdims)


def _impl_reduce_max(x, axes, keepdims):
    x = _arr(x)
    if axes is not None and len(tuple(axes)) == 0:
        return x
    dims = tuple(range(x.dim())) if axes is None else tuple(axes)
    if not dims:  # a 0-d array
        return x
    return torch.amax(x, dim=dims, keepdim=keepdims)


def _impl_unreduce(x, shp, axes, keepdims):
    shp = tuple(shp)
    x = _arr(x)
    if not keepdims:
        for a in _norm_axes(axes, len(shp)):
            x = x.unsqueeze(a)
    return x.expand(shp)


def _impl_axes_size(x, axes):
    shp = _impl_shape(x)
    return int(np.prod([shp[a] for a in _norm_axes(axes, len(shp))])) if shp else 1


def _impl_mT(x):
    return _arr(x).transpose(-1, -2)


def _wrap_index(idx: Any, n: int, device) -> torch.Tensor:
    """Indices along an axis of length ``n``, negative ones wrapped (numpy)."""
    idx = _arr(idx).to(device)
    if idx.dtype == torch.bool:
        idx = idx.to(torch.int32)
    return torch.where(idx < 0, idx + n, idx)


def _fill_value(dtype: torch.dtype):
    """jnp.take's fill for an out-of-range index: NaN for inexact types, the
    most negative value for signed ints, the largest for unsigned, True."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _impl_take(x, idx):
    x = _arr(x)
    n = x.shape[0]
    i = _wrap_index(idx, n, x.device)
    ok = (i >= 0) & (i < n)
    flat = i.reshape(-1).clamp(0, max(n - 1, 0)).long()
    rows = x.index_select(0, flat).reshape(tuple(i.shape) + tuple(x.shape[1:]))
    mask = ok.reshape(ok.shape + (1,) * (x.dim() - 1))
    return torch.where(mask, rows, torch.full((), _fill_value(x.dtype), dtype=x.dtype,
                                               device=x.device))


def _impl_index_add(base, idx, val):
    base = _arr(base)
    n = base.shape[0]
    i = _wrap_index(idx, n, base.device)
    val = _arr(val).to(device=base.device, dtype=base.dtype)
    val = val.expand(tuple(i.shape) + tuple(base.shape[1:]))
    out = base.clone(memory_format=torch.contiguous_format)
    if base.device.type == "meta":
        return out
    ok = (i >= 0) & (i < n)  # out-of-range updates are dropped, as jnp's
    out.index_put_((i[ok].long(),), val[ok], accumulate=True)
    return out


def _impl_slice_axis(x, axis, start, stop):
    x = _arr(x)
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop)
    return x[tuple(idx)]


def _impl_pad_zeros_axis(x, axis, before, after):
    x = _arr(x)
    axis = axis % x.dim()
    pads = [0, 0] * (x.dim() - axis)
    pads[-2:] = [before, after]
    return F.pad(x, pads)


def _impl_concat_axis(xs, axis):
    return torch.cat([_arr(x) for x in xs], dim=axis)


def _impl_concat_grad(xs, axis, dout):
    outs = []
    off = 0
    for x in xs:
        n = x.shape[axis]
        outs.append(_impl_slice_axis(dout, axis, off, off + n))
        off += n
    return tuple(outs)


def _impl_cast(x, dtype):
    return _arr(x).to(torch_dtype(dtype))


def _impl_dtype_of(x):
    if isinstance(x, (bool, np.bool_)):
        return np.dtype(bool)
    if isinstance(x, int):
        return np.dtype("int32")
    if isinstance(x, float):
        return np.dtype("float32")
    return np_dtype(x.dtype)


def _impl_stop_gradient(x):
    return x


def _impl_env_setitem(env: EnvInstance, key, val):
    return env.set(key, val)


def _impl_env_getitem(env: EnvInstance, key, default):
    return env.get(key, default)


def _impl_invert_permutation(perm):
    return tuple(int(i) for i in np.argsort(np.asarray(perm)))


def _impl_tuple_getitem(t, i):
    return t[i]


def _impl_tuple_setitem(t, i, v):
    lst = list(t)
    lst[i] = v
    return tuple(lst)


def _impl_one_hot(idx, num, dtype):
    # jax.nn.one_hot: an out-of-range (or negative) index gives a zero row
    idx = _arr(idx)
    return (idx.unsqueeze(-1) == torch.arange(num, device=idx.device)).to(torch_dtype(dtype))


def _impl_where(c, a, b):
    c = _arr(c)
    if c.dtype != torch.bool:
        c = c != 0
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = _operand(a), _operand(b)
        return canon(torch.where(c, a, b))
    return canon(torch.where(c, _arr(a).to(c.device), _arr(b).to(c.device)))


def _impl_matmul(a, b):
    a, b = _arr(a), _arr(b)
    if a.dtype != b.dtype:  # jnp promotes; torch.matmul refuses mixed types
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.matmul(a, b)


def _float_arg(x):
    """``jnp.asarray(x, jnp.result_type(x, 1.0))``: ints and bools as float32."""
    x = _arr(x)
    return x if x.dtype.is_floating_point else x.to(torch.float32)


def _unary(op: Callable, floating: bool = False) -> Callable:
    def impl(x):
        return canon(op(_float_arg(x) if floating else _arr(x)))

    return impl


def _impl_maximum(x, y):
    return max(x, y) if _all_py(x, y) else canon(torch.maximum(*_tensor_pair(x, y)))


def _impl_minimum(x, y):
    return min(x, y) if _all_py(x, y) else canon(torch.minimum(*_tensor_pair(x, y)))


def _impl_bool_not(x):
    return (not x) if _all_py(x) else torch.logical_not(_arr(x))


# ---------------------------------------------------------------------------
# Collectives (SPMD tier).  In the reference these execute only inside a
# ``shard_map`` region and carry no backpropagators (they are inserted
# after AD).  The port registers the names so graphs, fusion's opaque set
# and the optimizer's no-fold set match; executing one raises until the
# sharded tier (ROADMAP item A9) is ported.
# ---------------------------------------------------------------------------


def _collective(name: str) -> Callable:
    def impl(*args):
        raise NotImplementedError(
            f"{name}: the SPMD collectives wait for the sharded tier (ROADMAP item A9)"
        )

    return impl


#: primitive names that communicate across shards (or re-partition a
#: replicated value).  Fusion classifies these as opaque — a cluster can
#: never span a resharding point — and the optimizer never folds them.
COLLECTIVE_NAMES = frozenset(
    {"psum_axes", "pmax_axes", "all_gather_axes", "shard_slice"}
)


# ---------------------------------------------------------------------------
# Structured loops (closure-elimination tier).  ``repro_torch.core.closure``
# rewrites residual recursive families (parsed while/for loops, nested
# loop SCCs, affine non-tail self-recursion) into these primitives; their
# adjoints are loop-shaped, built by ``ad.JTransformer._j_while/_j_scan``.
# ``cond``/``step``/``exit`` arrive as closed first-order graphs (bound as
# lowered callables on the direct path, as Closures on the VM path); the
# trailing arguments split at ``n_carry`` into the loop carry and the
# loop-invariant environment.  Eager torch has no traced control flow, so
# both run as host loops; the carry needs no fixed type.
# ---------------------------------------------------------------------------


def _call_loop_fn(f: Any, args: tuple) -> Any:
    """Call a loop sub-function: a lowered Python callable (direct path)
    or a Graph/Closure evaluated by the reference VM (fallback path)."""
    from .ir import Graph
    from .values import Closure

    if isinstance(f, (Graph, Closure)):
        from .vm import VM

        return VM().call(f, tuple(args))
    return f(*args)


def _impl_while_loop(cond, step, exit_, n_carry, *args):
    carry = tuple(args[:n_carry])
    extras = tuple(args[n_carry:])
    while bool(_call_loop_fn(cond, (*carry, *extras))):
        carry = tuple(_call_loop_fn(step, (*carry, *extras)))
    return _call_loop_fn(exit_, (*carry, *extras))


def _impl_scan_loop(step, exit_, length, n_carry, *args):
    carry = tuple(args[:n_carry])
    extras = tuple(args[n_carry:])
    for _ in range(int(length)):
        carry = tuple(_call_loop_fn(step, (*carry, *extras)))
    return _call_loop_fn(exit_, (*carry, *extras))


#: loop primitives and, per name, how many leading arguments are
#: graph-valued sub-functions (legal graph constants for the lowerer)
LOOP_GRAPH_ARGS: dict[str, int] = {"while_loop": 3, "scan_loop": 2}
LOOP_NAMES = frozenset(LOOP_GRAPH_ARGS)


def _impl_integer_pow(x, n):
    if _all_py(x, n):
        return x**n
    return canon(_arr(x) ** int(n))


# ===========================================================================
# Registration.  bprop functions are defined at the end of this module and
# attached afterwards (they reference the prim globals below).
# ===========================================================================

add = register_primitive("add", _binary(lambda a, b: a + b, lambda a, b: a + b))
sub = register_primitive("sub", _binary(lambda a, b: a - b, lambda a, b: a - b))
mul = register_primitive("mul", _binary(lambda a, b: a * b, lambda a, b: a * b))
div = register_primitive("div", _binary(lambda a, b: a / b, lambda a, b: a / b))
power = register_primitive("power", _binary(lambda a, b: a**b, lambda a, b: a**b))
integer_pow = register_primitive("integer_pow", _impl_integer_pow)
floordiv = register_primitive(
    "floordiv", _binary(lambda a, b: a // b, lambda a, b: a // b), bprop="zeros"
)
mod = register_primitive("mod", _binary(lambda a, b: a % b, lambda a, b: a % b), bprop="zeros")
neg = register_primitive("neg", _impl_neg)

exp = register_primitive("exp", _unary(torch.exp, True))
log = register_primitive("log", _unary(torch.log, True))
tanh = register_primitive("tanh", _unary(torch.tanh, True))
sigmoid = register_primitive("sigmoid", _unary(torch.sigmoid, True))
relu = register_primitive("relu", _unary(torch.relu))
sqrt = register_primitive("sqrt", _unary(torch.sqrt, True))
rsqrt = register_primitive("rsqrt", _unary(torch.rsqrt, True))
sin = register_primitive("sin", _unary(torch.sin, True))
cos = register_primitive("cos", _unary(torch.cos, True))
square = register_primitive("square", _unary(torch.square))
absolute = register_primitive(
    "absolute", lambda x: abs(x) if _all_py(x) else canon(torch.abs(_arr(x)))
)
sign = register_primitive("sign", _unary(torch.sign), bprop="zeros")
erf = register_primitive("erf", _unary(torch.erf, True))

lt = register_primitive("lt", _cmp(lambda a, b: a < b, torch.lt), bprop="zeros")
gt = register_primitive("gt", _cmp(lambda a, b: a > b, torch.gt), bprop="zeros")
le = register_primitive("le", _cmp(lambda a, b: a <= b, torch.le), bprop="zeros")
ge = register_primitive("ge", _cmp(lambda a, b: a >= b, torch.ge), bprop="zeros")
eq = register_primitive("eq", _cmp(lambda a, b: a == b, torch.eq), bprop="zeros")
ne = register_primitive("ne", _cmp(lambda a, b: a != b, torch.ne), bprop="zeros")
bool_and = register_primitive(
    "bool_and", _cmp(lambda a, b: a and b, torch.logical_and), bprop="zeros"
)
bool_or = register_primitive(
    "bool_or", _cmp(lambda a, b: a or b, torch.logical_or), bprop="zeros"
)
bool_not = register_primitive("bool_not", _impl_bool_not, bprop="zeros")

maximum = register_primitive("maximum", _impl_maximum)
minimum = register_primitive("minimum", _impl_minimum)
where = register_primitive("where", _impl_where)

matmul = register_primitive("matmul", _impl_matmul)
mT = register_primitive("mT", _impl_mT)
transpose = register_primitive("transpose", lambda x, perm: _arr(x).permute(tuple(perm)))
reshape = register_primitive("reshape", lambda x, shp: _arr(x).reshape(tuple(shp)))
broadcast_to = register_primitive("broadcast_to", lambda x, shp: _arr(x).expand(tuple(shp)))
unbroadcast = register_primitive("unbroadcast", _impl_unbroadcast)
reduce_sum = register_primitive("reduce_sum", _impl_reduce_sum)
reduce_max = register_primitive("reduce_max", _impl_reduce_max)
unreduce = register_primitive("unreduce", _impl_unreduce)

shape = register_primitive("shape", _impl_shape, bprop="zeros")
axes_size = register_primitive("axes_size", _impl_axes_size, bprop="zeros")
dtype_of = register_primitive("dtype_of", _impl_dtype_of, bprop="zeros")
invert_permutation = register_primitive(
    "invert_permutation", _impl_invert_permutation, bprop="zeros"
)
cast = register_primitive("cast", _impl_cast)

take = register_primitive("take", _impl_take)
index_add = register_primitive("index_add", _impl_index_add)
slice_axis = register_primitive("slice_axis", _impl_slice_axis)
pad_zeros_axis = register_primitive("pad_zeros_axis", _impl_pad_zeros_axis)
concat_axis = register_primitive("concat_axis", _impl_concat_axis)
concat_grad = register_primitive("concat_grad", _impl_concat_grad)
one_hot = register_primitive("one_hot", _impl_one_hot, bprop="zeros")

# collectives: bprop=None — AD through a resharding point must fail loudly
psum_axes = register_primitive("psum_axes", _collective("psum_axes"))
pmax_axes = register_primitive("pmax_axes", _collective("pmax_axes"))
all_gather_axes = register_primitive("all_gather_axes", _collective("all_gather_axes"))
shard_slice = register_primitive("shard_slice", _collective("shard_slice"))

# structured loops: bprop=None — their adjoints are loop-shaped, built by
# ad.JTransformer._j_while/_j_scan rather than a pointwise VJP rule
while_loop = register_primitive("while_loop", _impl_while_loop, vararg=True)
scan_loop = register_primitive("scan_loop", _impl_scan_loop, vararg=True)

switch = register_primitive("switch", _impl_switch)
stop_gradient = register_primitive("stop_gradient", _impl_stop_gradient)

make_tuple = register_primitive("make_tuple", lambda *xs: tuple(xs), vararg=True, bprop=None)
tuple_getitem = register_primitive("tuple_getitem", _impl_tuple_getitem)
tuple_setitem = register_primitive("tuple_setitem", _impl_tuple_setitem)
tuple_len = register_primitive("tuple_len", lambda t: len(t), bprop="zeros")

gadd = register_primitive("gadd", gadd_values)
zeros_like = register_primitive("zeros_like", zeros_like_value)

env_setitem = register_primitive("env_setitem", _impl_env_setitem)
env_getitem = register_primitive("env_getitem", _impl_env_getitem)

# ===========================================================================
# Backpropagator definitions (Myia-subset Python; parsed, never executed).
# Signature: (args..., out, dout) -> tuple of gradients w.r.t. args.
# ===========================================================================


def _bprop_add(x, y, out, dout):
    return (unbroadcast(dout, shape(x)), unbroadcast(dout, shape(y)))


def _bprop_sub(x, y, out, dout):
    return (unbroadcast(dout, shape(x)), unbroadcast(neg(dout), shape(y)))


def _bprop_mul(x, y, out, dout):
    return (unbroadcast(mul(dout, y), shape(x)), unbroadcast(mul(dout, x), shape(y)))


def _bprop_div(x, y, out, dout):
    return (
        unbroadcast(div(dout, y), shape(x)),
        unbroadcast(neg(div(mul(dout, x), mul(y, y))), shape(y)),
    )


def _bprop_power(x, y, out, dout):
    return (
        unbroadcast(mul(dout, mul(y, power(x, sub(y, 1)))), shape(x)),
        unbroadcast(mul(dout, mul(out, log(x))), shape(y)),
    )


def _bprop_integer_pow(x, n, out, dout):
    # no log term: safe for negative bases (cf. jax.lax.integer_pow)
    return (mul(dout, mul(n, integer_pow(x, sub(n, 1)))), zeros_like(n))


def _bprop_neg(x, out, dout):
    return (neg(dout),)


def _bprop_exp(x, out, dout):
    return (mul(dout, out),)


def _bprop_log(x, out, dout):
    return (div(dout, x),)


def _bprop_tanh(x, out, dout):
    return (mul(dout, sub(1.0, mul(out, out))),)


def _bprop_sigmoid(x, out, dout):
    return (mul(dout, mul(out, sub(1.0, out))),)


def _bprop_relu(x, out, dout):
    return (mul(dout, cast(gt(x, 0), dtype_of(dout))),)


def _bprop_sqrt(x, out, dout):
    return (div(mul(dout, 0.5), out),)


def _bprop_rsqrt(x, out, dout):
    return (div(mul(mul(dout, -0.5), out), x),)


def _bprop_sin(x, out, dout):
    return (mul(dout, cos(x)),)


def _bprop_cos(x, out, dout):
    return (neg(mul(dout, sin(x))),)


def _bprop_square(x, out, dout):
    return (mul(dout, mul(2.0, x)),)


def _bprop_absolute(x, out, dout):
    return (mul(dout, sign(x)),)


def _bprop_erf(x, out, dout):
    return (mul(dout, mul(1.1283791670955126, exp(neg(mul(x, x))))),)


def _bprop_maximum(x, y, out, dout):
    return (
        unbroadcast(mul(dout, cast(ge(x, y), dtype_of(dout))), shape(x)),
        unbroadcast(mul(dout, cast(lt(x, y), dtype_of(dout))), shape(y)),
    )


def _bprop_minimum(x, y, out, dout):
    return (
        unbroadcast(mul(dout, cast(le(x, y), dtype_of(dout))), shape(x)),
        unbroadcast(mul(dout, cast(gt(x, y), dtype_of(dout))), shape(y)),
    )


def _bprop_where(c, a, b, out, dout):
    return (
        zeros_like(c),
        unbroadcast(mul(dout, cast(c, dtype_of(dout))), shape(a)),
        unbroadcast(mul(dout, cast(bool_not(c), dtype_of(dout))), shape(b)),
    )


def _bprop_matmul(a, b, out, dout):
    return (
        unbroadcast(matmul(dout, mT(b)), shape(a)),
        unbroadcast(matmul(mT(a), dout), shape(b)),
    )


def _bprop_mT(x, out, dout):
    return (mT(dout),)


def _bprop_transpose(x, perm, out, dout):
    return (transpose(dout, invert_permutation(perm)), zeros_like(perm))


def _bprop_reshape(x, shp, out, dout):
    return (reshape(dout, shape(x)), zeros_like(shp))


def _bprop_broadcast_to(x, shp, out, dout):
    return (unbroadcast(dout, shape(x)), zeros_like(shp))


def _bprop_unbroadcast(x, shp, out, dout):
    return (broadcast_to(dout, shape(x)), zeros_like(shp))


def _bprop_reduce_sum(x, axes, keepdims, out, dout):
    return (unreduce(dout, shape(x), axes, keepdims), zeros_like(axes), zeros_like(keepdims))


def _bprop_unreduce(x, shp, axes, keepdims, out, dout):
    return (
        reduce_sum(dout, axes, keepdims),
        zeros_like(shp),
        zeros_like(axes),
        zeros_like(keepdims),
    )


def _bprop_reduce_max(x, axes, keepdims, out, dout):
    m = cast(eq(x, unreduce(out, shape(x), axes, keepdims)), dtype_of(dout))
    cnt = reduce_sum(m, axes, keepdims)
    return (
        mul(m, unreduce(div(dout, cnt), shape(x), axes, keepdims)),
        zeros_like(axes),
        zeros_like(keepdims),
    )


def _bprop_cast(x, dtype, out, dout):
    return (cast(dout, dtype_of(x)), zeros_like(dtype))


def _bprop_take(x, idx, out, dout):
    return (index_add(zeros_like(x), idx, dout), zeros_like(idx))


def _bprop_index_add(base, idx, val, out, dout):
    return (dout, zeros_like(idx), take(dout, idx))


def _bprop_slice_axis(x, axis, start, stop, out, dout):
    total = tuple_getitem(shape(x), axis)
    return (
        pad_zeros_axis(dout, axis, start, sub(total, stop)),
        zeros_like(axis),
        zeros_like(start),
        zeros_like(stop),
    )


def _bprop_pad_zeros_axis(x, axis, before, after, out, dout):
    n = tuple_getitem(shape(x), axis)
    return (
        slice_axis(dout, axis, before, add(before, n)),
        zeros_like(axis),
        zeros_like(before),
        zeros_like(after),
    )


def _bprop_concat_axis(xs, axis, out, dout):
    return (concat_grad(xs, axis, dout), zeros_like(axis))


def _bprop_concat_grad(xs, axis, dout_in, out, dout):
    return (zeros_like(xs), zeros_like(axis), concat_axis(dout, axis))


def _bprop_switch(c, t, f, out, dout):
    return (zeros_like(c), switch(c, dout, zeros_like(t)), switch(c, zeros_like(f), dout))


def _bprop_stop_gradient(x, out, dout):
    return (zeros_like(x),)


def _bprop_gadd(x, y, out, dout):
    return (dout, dout)


def _bprop_zeros_like(x, out, dout):
    return (zeros_like(x),)


def _bprop_tuple_getitem(t, i, out, dout):
    return (tuple_setitem(zeros_like(t), i, dout), zeros_like(i))


def _bprop_tuple_setitem(t, i, v, out, dout):
    return (tuple_setitem(dout, i, zeros_like(v)), zeros_like(i), tuple_getitem(dout, i))


def _bprop_env_setitem(env, key, val, out, dout):
    return (
        env_setitem(dout, key, zeros_like(val)),
        zeros_like(key),
        env_getitem(dout, key, zeros_like(val)),
    )


def _bprop_env_getitem(env, key, default, out, dout):
    return (
        env_setitem(zeros_like(env), key, dout),
        zeros_like(key),
        zeros_like(default),
    )


_BPROPS = {
    "add": _bprop_add,
    "sub": _bprop_sub,
    "mul": _bprop_mul,
    "div": _bprop_div,
    "power": _bprop_power,
    "integer_pow": _bprop_integer_pow,
    "neg": _bprop_neg,
    "exp": _bprop_exp,
    "log": _bprop_log,
    "tanh": _bprop_tanh,
    "sigmoid": _bprop_sigmoid,
    "relu": _bprop_relu,
    "sqrt": _bprop_sqrt,
    "rsqrt": _bprop_rsqrt,
    "sin": _bprop_sin,
    "cos": _bprop_cos,
    "square": _bprop_square,
    "absolute": _bprop_absolute,
    "erf": _bprop_erf,
    "maximum": _bprop_maximum,
    "minimum": _bprop_minimum,
    "where": _bprop_where,
    "matmul": _bprop_matmul,
    "mT": _bprop_mT,
    "transpose": _bprop_transpose,
    "reshape": _bprop_reshape,
    "broadcast_to": _bprop_broadcast_to,
    "unbroadcast": _bprop_unbroadcast,
    "reduce_sum": _bprop_reduce_sum,
    "unreduce": _bprop_unreduce,
    "reduce_max": _bprop_reduce_max,
    "cast": _bprop_cast,
    "take": _bprop_take,
    "index_add": _bprop_index_add,
    "slice_axis": _bprop_slice_axis,
    "pad_zeros_axis": _bprop_pad_zeros_axis,
    "concat_axis": _bprop_concat_axis,
    "concat_grad": _bprop_concat_grad,
    "switch": _bprop_switch,
    "stop_gradient": _bprop_stop_gradient,
    "gadd": _bprop_gadd,
    "zeros_like": _bprop_zeros_like,
    "tuple_getitem": _bprop_tuple_getitem,
    "tuple_setitem": _bprop_tuple_setitem,
    "env_setitem": _bprop_env_setitem,
    "env_getitem": _bprop_env_getitem,
}

for _name, _fn in _BPROPS.items():
    PRIMITIVES[_name].bprop = _fn
