"""The port's primitives against the reference's, impl by impl.

Each case calls one primitive's ``impl`` in both packages on the same inputs
(numpy arrays made into jax arrays for the reference and tensors for the
port, Python scalars, tuples, dtypes).  The results must have the same
structure, the same kinds (a Python scalar stays one), the same dtypes — the
reference's canonical ``int32`` / ``float32``, weak Python scalars — and
allclose values (f32 at rtol 1e-6: the same op on the same inputs, with
transcendentals that differ by an ulp), exact for integers and bools.  The
index primitives keep jnp's semantics for out-of-range and negative indices:
``take`` fills (NaN, or the most negative int), ``index_add`` drops,
``one_hot`` gives a zero row.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.primitives as RP
import repro.kernels.ops  # noqa: F401  (registers the kernel primitives)
import repro_torch.core.primitives as TP
import repro_torch.kernels.ops  # noqa: F401  (registers the kernel primitives)
from repro_torch.core.dtypes import np_dtype, to_numpy

RS = np.random.RandomState(0)
F = RS.randn(3, 4).astype(np.float32)
G = RS.randn(3, 4).astype(np.float32)
POS = (np.abs(F) + 0.1).astype(np.float32)
V = RS.randn(4).astype(np.float32)
F3 = RS.randn(2, 3, 4).astype(np.float32)
W = RS.randn(4, 5).astype(np.float32)
I = RS.randint(-5, 6, (3, 4)).astype(np.int32)
B = RS.rand(3, 4) > 0.5
B2 = RS.rand(3, 4) > 0.5
IDX = np.array([0, -1, 4, -5, 2], np.int32)
IDX2 = np.array([[1, 0], [3, -2]], np.int32)
ROWS = RS.randn(4, 3).astype(np.float32)
F32, I32, BOOL = np.dtype("float32"), np.dtype("int32"), np.dtype("bool")


class _Cat:
    """Marks a tuple whose arrays both sides should convert (concat inputs)."""

    def __init__(self, *xs):
        self.xs = xs


CASES = [
    # arithmetic, with the reference's promotions
    ("add", (F, G)), ("add", (F, 2.0)), ("add", (2.0, F)), ("add", (I, 3)), ("add", (I, 2.5)),
    ("add", (B, 1)), ("add", (B, B2)), ("add", (F, V)), ("add", (3, 4)), ("add", (1.5, 2)),
    ("sub", (F, G)), ("sub", (1.0, F)), ("sub", (I, 2)),
    ("mul", (F, G)), ("mul", (I, I)), ("mul", (B, 2.0)), ("mul", (2, 3)),
    ("div", (F, G)), ("div", (F, 3.0)), ("div", (2.0, POS)), ("div", (I, I + 7)), ("div", (7, 2)),
    ("power", (POS, G)), ("power", (POS, 2.5)), ("power", (2.0, G)),
    ("integer_pow", (F, 3)), ("integer_pow", (I, 2)), ("integer_pow", (1.5, 2)),
    ("floordiv", (F, 0.7)), ("floordiv", (I, 3)), ("floordiv", (7, 2)),
    ("mod", (F, 0.7)), ("mod", (I, 3)), ("mod", (-7, 3)),
    ("neg", (F,)), ("neg", (I,)), ("neg", (2.0,)),
    # transcendentals and friends
    ("exp", (F,)), ("exp", (0.5,)), ("exp", (I,)), ("log", (POS,)), ("tanh", (F,)),
    ("tanh", (0.3,)), ("sigmoid", (F,)), ("relu", (F,)), ("relu", (I,)), ("relu", (-1.0,)),
    ("sqrt", (POS,)), ("sqrt", (2,)), ("rsqrt", (POS,)), ("rsqrt", (I + 6,)), ("sin", (F,)),
    ("cos", (F,)), ("square", (F,)), ("square", (I,)), ("absolute", (F,)), ("absolute", (I,)),
    ("absolute", (-2.5,)), ("sign", (F,)), ("sign", (I,)), ("erf", (F,)), ("erf", (1,)),
    # comparisons and logic
    ("lt", (F, G)), ("gt", (I, 1)), ("le", (F, 0.5)), ("ge", (0.5, F)), ("eq", (I, I)),
    ("ne", (I, 0)), ("lt", (1, 2)), ("eq", (1.0, 1)),
    ("bool_and", (B, B2)), ("bool_or", (B, True)), ("bool_not", (B,)), ("bool_and", (True, False)),
    ("bool_not", (False,)),
    ("maximum", (F, G)), ("maximum", (F, 0.0)), ("maximum", (I, 2)), ("maximum", (1, 2.5)),
    ("minimum", (F, G)), ("minimum", (0.0, F)), ("minimum", (I, I.T.copy().T)),
    ("where", (B, F, G)), ("where", (B, F, 0.0)), ("where", (B, 1.0, 0.0)), ("where", (B, I, 0)),
    # shapes and layouts
    ("matmul", (F, W)), ("matmul", (F3, W)), ("matmul", (V, W)), ("mT", (F,)), ("mT", (F3,)),
    ("transpose", (F3, (2, 0, 1))), ("reshape", (F, (4, 3))), ("reshape", (F3, (-1,))),
    ("broadcast_to", (V, (3, 4))), ("broadcast_to", (1.0, (2, 3))), ("broadcast_to", (3, (2,))),
    ("unbroadcast", (F, (1, 4))), ("unbroadcast", (F, (4,))), ("unbroadcast", (F, ())),
    ("unbroadcast", (I, ())), ("unbroadcast", (F3, (3, 1))), ("unbroadcast", (1.5, (3,))),
    ("reduce_sum", (F, None, False)), ("reduce_sum", (F, (1,), True)),
    ("reduce_sum", (F, (), False)), ("reduce_sum", (B, None, False)),
    ("reduce_sum", (I, (0,), False)), ("reduce_sum", (F3, (0, 2), True)),
    ("reduce_sum", (2.0, None, False)),
    ("reduce_max", (F, (0,), False)), ("reduce_max", (F, None, True)),
    ("reduce_max", (I, (1,), True)), ("reduce_max", (F3, (1, 2), False)),
    ("unreduce", (F[:, :1], (3, 4), (1,), True)), ("unreduce", (V[:3], (3, 4), (1,), False)),
    ("unreduce", (1.0, (2, 3), None, False)), ("unreduce", (F[0], (2, 3, 4), (0,), False)),
    ("shape", (F3,)), ("shape", (1.0,)), ("axes_size", (F3, (0, 2))), ("axes_size", (F, None)),
    ("dtype_of", (F,)), ("dtype_of", (I,)), ("dtype_of", (B,)), ("dtype_of", (1.0,)),
    ("dtype_of", (2,)), ("dtype_of", (True,)), ("invert_permutation", ((2, 0, 1),)),
    ("cast", (F, I32)), ("cast", (I, F32)), ("cast", (B, F32)), ("cast", (1.0, F32)),
    ("cast", (F, BOOL)), ("cast", (2, F32)), ("cast", (F, np.dtype("float64"))),
    # gathers and scatters, out-of-range and negative indices included
    ("take", (ROWS, IDX)), ("take", (I, np.array([2, -1, 3, -4], np.int32))),
    ("take", (ROWS, 2)), ("take", (ROWS, IDX2)), ("take", (V, IDX)),
    ("index_add", (np.zeros((4, 3), np.float32), IDX, np.ones((5, 3), np.float32))),
    ("index_add", (ROWS, 2, 1.0)),
    ("index_add", (ROWS, IDX2, RS.randn(2, 2, 3).astype(np.float32))),
    ("index_add", (I, np.array([1, 7, -1], np.int32), np.ones((3, 4), np.int32))),
    ("one_hot", (IDX, 4, F32)), ("one_hot", (IDX2, 4, I32)),
    ("slice_axis", (F, 1, 1, 3)), ("slice_axis", (F3, 0, 1, 2)),
    ("pad_zeros_axis", (F, 0, 1, 2)), ("pad_zeros_axis", (F3, 2, 0, 3)),
    ("concat_axis", (_Cat(F, G), 0)), ("concat_axis", (_Cat(F, G, F), 1)),
    ("concat_grad", (_Cat(F, G), 0, np.concatenate([F, G], 0))),
    # control and structure
    ("switch", (True, 1, 2)), ("switch", (False, F, G)), ("switch", (np.asarray(True), F, G)),
    ("stop_gradient", (F,)), ("stop_gradient", (1.5,)), ("make_tuple", (F, 1, 2.0)),
    ("tuple_getitem", ((1, 2, 3), 1)), ("tuple_setitem", ((1, 2, 3), 0, 9)),
    ("tuple_len", ((1, 2, 3),)),
    ("gadd", (F, G)), ("gadd", (_Cat(F, 1.0), _Cat(G, 2.0))), ("gadd", (None, F)),
    ("gadd", (1, 2.5)), ("zeros_like", (F,)), ("zeros_like", (_Cat(F, 1.0),)),
    ("zeros_like", (2,)), ("zeros_like", (True,)), ("zeros_like", (1.5,)),
]


def _to(side: str, a):
    if isinstance(a, _Cat):
        return tuple(_to(side, x) for x in a.xs)
    if isinstance(a, np.ndarray):
        return jnp.asarray(a) if side == "ref" else torch.from_numpy(a.copy())
    return a


def _norm(x):
    """A backend-free description: arrays as (dtype, shape, values), Python
    scalars as (type, value), tuples recursively."""
    if isinstance(x, tuple):
        return ("tuple", tuple(_norm(e) for e in x))
    if isinstance(x, torch.Tensor):
        return ("array", np_dtype(x.dtype), to_numpy(x))
    if isinstance(x, (np.ndarray, jnp.ndarray)) or hasattr(x, "__jax_array__"):
        a = np.asarray(x)
        return ("array", a.dtype, a)
    if isinstance(x, np.dtype):
        return ("dtype", x)
    return (type(x).__name__, x)


def _assert_same(got, want, where="out"):
    assert got[0] == want[0], (where, got, want)
    if got[0] == "tuple":
        assert len(got[1]) == len(want[1]), where
        for i, (a, b) in enumerate(zip(got[1], want[1])):
            _assert_same(a, b, f"{where}[{i}]")
    elif got[0] == "array":
        assert got[1] == want[1], (where, got[1], want[1])
        assert got[2].shape == want[2].shape, where
        if got[1].kind == "f":
            np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6, err_msg=where)
        else:
            np.testing.assert_array_equal(got[2], want[2], err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_impl_matches_reference(name, args):
    want = RP.PRIMITIVES[name].impl(*(_to("ref", a) for a in args))
    got = TP.PRIMITIVES[name].impl(*(_to("port", a) for a in args))
    _assert_same(_norm(got), _norm(want))


def test_every_primitive_is_registered_with_the_same_bprop_kind():
    assert sorted(TP.PRIMITIVES) == sorted(RP.PRIMITIVES)
    assert KERNEL_PRIMS <= set(TP.PRIMITIVES)

    def kind(p):
        return p.bprop if p.bprop in (None, "zeros") else "graph"

    for n, p in RP.PRIMITIVES.items():
        assert kind(TP.PRIMITIVES[n]) == kind(p), n
        assert TP.PRIMITIVES[n].vararg == p.vararg, n
    assert TP.COLLECTIVE_NAMES == RP.COLLECTIVE_NAMES
    assert TP.LOOP_GRAPH_ARGS == RP.LOOP_GRAPH_ARGS


#: the kernel primitives run through Myia in tests/test_torch_myia_fusion.py
KERNEL_PRIMS = {"flash_attention", "flash_attention_vjp", "rmsnorm", "rmsnorm_vjp",
                "ssd_scan", "ssd_scan_vjp"}


def test_the_array_primitives_are_covered():
    structural = {"env_setitem", "env_getitem", "while_loop", "scan_loop",
                  *TP.COLLECTIVE_NAMES, *KERNEL_PRIMS}
    covered = {n for n, _ in CASES}
    assert set(TP.PRIMITIVES) - structural - covered == set()


@pytest.mark.parametrize("name", sorted(TP.COLLECTIVE_NAMES))
def test_collectives_raise_until_the_sharded_tier(name):
    """The collectives run only inside a per-shard program of the SPMD tier
    (``tests/test_torch_spmd*.py`` run them); outside one they raise, as the
    reference's raise outside ``shard_map``."""
    extra = () if name in ("psum_axes", "pmax_axes") else (0, (1,))
    with pytest.raises(RuntimeError, match="per-shard program"):
        TP.PRIMITIVES[name].impl(torch.ones(2), ("data",), *extra)


def test_loops_run_on_the_host():
    def cond(i, acc, x):
        return i < 3

    def step(i, acc, x):
        return (i + 1, acc * x)

    def exit_(i, acc, x):
        return acc

    x = torch.tensor(1.5)
    assert float(TP.while_loop.impl(cond, step, exit_, 2, 0, x, x)) == pytest.approx(1.5**4)
    assert float(TP.scan_loop.impl(step, exit_, 3, 2, 0, x, x)) == pytest.approx(1.5**4)
