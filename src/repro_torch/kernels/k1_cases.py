"""Programs that put every elementwise primitive and every reduction root of
the fusion tier into a K1 cluster, for K1's checks on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 17).

Each case is a Myia-subset program of two arrays ``(x, y)``: a cluster of
at least three members (``fusion.partition_graph``'s minimum) around the
primitive under test.  :func:`compile_case` runs it through the pipeline
with ``fuse=True``; the caller holds the generated Triton kernels (kernel
mode ``None`` on CUDA tensors) against their torch oracles (kernel mode
``"ref"``) on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

import repro_torch.core.primitives as P
from repro_torch.core.api import compile_pipeline
from repro_torch.core.infer import abstract_of_value
from repro_torch.core.lowering import lower_graph
from repro_torch.core.parser import parse_function

__all__ = [
    "ELEMENTWISE_CASES", "ELEMENTWISE_SHAPES", "REDUCE_CASES", "REDUCE_SHAPES", "compile_case",
    "case_inputs", "MAP_ULPS", "REDUCE_TOL", "ulps",
]

#: K1's map kernels against their torch oracles, in units in the last place: f32 and
#: bf16 within one (the same libdevice functions in the same order, division by
#: div_rn, no FMA contraction), integer and bool results exactly.  ``power`` takes two:
#: with FMA contraction off, libdevice's powf inlined into the kernel rounds its
#: intermediate products apart from torch's (read on an H100: 2 ulps at most).
MAP_ULPS = {"power": 2, "power_scalar": 2}
#: reduce kernels are allclose only, as the reference holds them: the same terms
#: summed in another order (f32 accumulation; bf16 rounds the f32 result once)
REDUCE_TOL = {
    "float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2),
}

_F32 = np.dtype("float32")
_I32 = np.dtype("int32")


def _unary(op, shift):
    def prog(x, y):
        return op(x * y + shift)

    return prog


def _binary(op):
    def prog(x, y):
        return op(x * y + 0.5, x + 0.25)

    return prog


def _compare(op):
    def prog(x, y):
        return P.cast(op(x * y, x + y), _F32)

    return prog


def _bool_and(x, y):
    return P.cast(P.bool_and(P.lt(x, y), P.gt(x * y, 0.25)), _F32)


def _bool_or(x, y):
    return P.cast(P.bool_or(P.lt(x, y), P.gt(x * y, 0.25)), _F32)


def _bool_not(x, y):
    return P.cast(P.bool_not(P.lt(x * y, 0.25)), _F32)


def _where(x, y):
    return P.where(P.lt(x, y), x * y, x + y)


def _cast_int(x, y):
    return P.cast(x * y * 8.0 - 2.0, _I32)


def _integer_pow(x, y):
    return P.integer_pow(x * y + 0.5, 3)


def _power_scalar(x, y):
    return P.power(x * y + 0.5, 2.5)


def _div_scalar(x, y):
    return (x * y + 0.5) / 3.0


def _rdiv_scalar(x, y):
    return 2.0 / (x * y + 0.5)


def _neg(x, y):
    return -(x * y) + 0.5


#: (case name, program): each name of ``fusion.ELEMENTWISE`` at least once
ELEMENTWISE_CASES = {
    "add": _unary(P.tanh, 0.5),  # mul, add, tanh
    "sub": _binary(P.sub),
    "mul": _binary(P.mul),
    "div": _binary(P.div),
    "div_scalar": _div_scalar,
    "rdiv_scalar": _rdiv_scalar,
    "power": _binary(P.power),
    "power_scalar": _power_scalar,
    "integer_pow": _integer_pow,
    "neg": _neg,
    "exp": _unary(P.exp, -0.5),
    "log": _unary(P.log, 0.5),
    "tanh": _unary(P.tanh, -0.5),
    "sigmoid": _unary(P.sigmoid, -0.5),
    "relu": _unary(P.relu, -0.5),
    "sqrt": _unary(P.sqrt, 0.5),
    "rsqrt": _unary(P.rsqrt, 0.5),
    "sin": _unary(P.sin, -0.5),
    "cos": _unary(P.cos, -0.5),
    "square": _unary(P.square, -0.5),
    "absolute": _unary(P.absolute, -0.5),
    "sign": _unary(P.sign, -0.5),
    "erf": _unary(P.erf, -0.5),
    "maximum": _binary(P.maximum),
    "minimum": _binary(P.minimum),
    "where": _where,
    "cast": _cast_int,
    "lt": _compare(P.lt),
    "gt": _compare(P.gt),
    "le": _compare(P.le),
    "ge": _compare(P.ge),
    "eq": _compare(P.eq),
    "ne": _compare(P.ne),
    "bool_and": _bool_and,
    "bool_or": _bool_or,
    "bool_not": _bool_not,
}


def _red_sum(axes, keep):
    def prog(x, y):
        return P.reduce_sum(P.tanh(x) * y + 1.0, axes, keep)

    return prog


def _red_max(axes, keep):
    def prog(x, y):
        return P.reduce_max(P.tanh(x) * y + 1.0, axes, keep)

    return prog


def _unbroadcast(shp):
    def prog(x, y):
        return P.unbroadcast(P.tanh(x) * y + 1.0, shp)

    return prog


#: (case name, program) over a rank-3 body: leading, trailing, middle, two and
#: all axes, with and without keepdims, for each reduction root
REDUCE_CASES = {
    "sum_leading": _red_sum((0,), False),
    "sum_trailing_keep": _red_sum((2,), True),
    "sum_middle": _red_sum((1,), False),
    "sum_outer_keep": _red_sum((0, 2), True),
    "sum_all": _red_sum(None, False),
    "max_leading_keep": _red_max((0,), True),
    "max_trailing": _red_max((2,), False),
    "max_middle_keep": _red_max((1,), True),
    "max_all": _red_max(None, False),
    "unbroadcast_rows": _unbroadcast((1, 37, 1)),
    "unbroadcast_lastdim": _unbroadcast((129,)),
    "unbroadcast_scalar": _unbroadcast(()),
}

#: body shapes of the reduce cases (ragged; the unbroadcast targets assume the
#: last two axes); the larger one splits its full reductions over many programs
REDUCE_SHAPES = ((3, 37, 129), (16, 37, 129))
#: body shapes of the elementwise cases: ragged, one partial block, many blocks
ELEMENTWISE_SHAPES = ((5, 7), (3, 37, 129), (2, 300, 1000))


def case_inputs(name: str, shape: tuple, y_rank: int, dtype: torch.dtype, device,
                seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` at ``shape``; ``y`` at the body shape (``y_rank`` = len(shape)), its
    last axis (1) or a 0-d tensor (0).  Comparison cases get small integer values,
    so that ``eq`` and ``ne`` see equal pairs."""
    rng = np.random.default_rng(seed)
    yshape = shape[len(shape) - y_rank:] if y_rank else ()
    if name in ("lt", "gt", "le", "ge", "eq", "ne"):
        x = rng.integers(0, 3, shape).astype(np.float32)
        y = rng.integers(0, 3, yshape).astype(np.float32)
    else:
        x = rng.random(shape, dtype=np.float32)
        y = rng.random(yshape, dtype=np.float32)
    return (torch.from_numpy(x).to(device=device, dtype=dtype),
            torch.from_numpy(np.asarray(y)).to(device=device, dtype=dtype))


def ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Units in the last place between two f32 or bf16 tensors (±0 coincide, a
    NaN equals a NaN)."""
    nbits = 32 if got.dtype == torch.float32 else 16
    view = torch.int32 if nbits == 32 else torch.int16

    def ordered(t):
        bits = t.contiguous().view(view).to(torch.int64)
        return torch.where(bits < 0, -(bits + (1 << (nbits - 1))), bits)

    d = (ordered(got) - ordered(want)).abs()
    return int(torch.where(torch.isnan(got) & torch.isnan(want), 0, d).max())


def compile_case(prog, x: torch.Tensor, y: torch.Tensor, fuse: bool = True):
    """The lowered callable of ``prog`` at ``(x, y)``'s signature (fused by
    default)."""
    g = compile_pipeline(parse_function(prog), (abstract_of_value(x), abstract_of_value(y)))
    return lower_graph(g, fuse=fuse)
