"""The Myia pipeline of the port against the reference's, program by program.

One shared corpus, each program run through both packages
(``repro.core`` and ``repro_torch.core``) from the same inputs, made with
numpy.  It holds the programs of ``tests/core/test_lowering.py``'s
``CORPUS``, the extra programs of ``tests/core/test_fusion.py``'s corpus,
the 11 programs of ``benchmarks/bench_compile_time.py``'s
``_fallback_corpus`` (loops, loop adjoints, recursion, higher-order calls),
two grad-of-grad programs of ``tests/core/test_ad_higher_order.py`` and the
``--compiler myia`` LM loss at tiny dims with D, H and V all different.
Programs that name primitives take the primitive module as an argument, so
one definition serves both packages.

Exact parity (graph-level artefacts are backend-free, so any difference is a
port bug): the canonical encodings and structural hashes of the parsed,
adjoint and optimized graphs; ``OptStats``; the inferred abstracts of every
node, dtypes included; the fusion plans (clusters, members, kinds, body
shapes, ``stats()``, the generator's verdicts); ``specialize(args).lowered``;
and no VM fallback on the 11-program corpus.  Numerics: values and
gradients allclose, f32 at rtol 1e-5 (XLA's CPU and torch's transcendentals
and sums differ by ulps).
"""

from __future__ import annotations

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.primitives as RP
import repro_torch.core as T
import repro_torch.core.primitives as TP
from repro.core import api as R_api
from repro.core import closure as R_closure
from repro.core import fusion as R_fusion
from repro.core import ir as R_ir
from repro.core import serialize as R_ser
from repro.kernels import codegen as R_codegen
from repro.launch import myia_step as R_step
from repro_torch.core import api as T_api
from repro_torch.core import closure as T_closure
from repro_torch.core import fusion as T_fusion
from repro_torch.core import ir as T_ir
from repro_torch.core import serialize as T_ser
from repro_torch.core.dtypes import to_numpy
from repro_torch.kernels import codegen as T_codegen
from repro_torch.launch import myia_step as T_step

RTOL, ATOL = 1e-5, 1e-6

# the packages export ``infer`` the function, which shadows the module
R_infer = importlib.import_module("repro.core.infer")
T_infer = importlib.import_module("repro_torch.core.infer")


class Side:
    """One package's entry points, and how its arrays are made and read."""

    def __init__(self, core, P, api, ser, fusion, infer, ir, closure, codegen, step, arr, read):
        self.core, self.P, self.api, self.ser = core, P, api, ser
        self.fusion, self.infer, self.ir, self.closure = fusion, infer, ir, closure
        self.codegen, self.step, self.arr, self.read = codegen, step, arr, read


def _read_jax(x):
    return np.asarray(x)


def _read_torch(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _arr_jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _arr_torch(a):
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


REF = Side(R, RP, R_api, R_ser, R_fusion, R_infer, R_ir, R_closure, R_codegen, R_step,
           _arr_jax, _read_jax)
PORT = Side(T, TP, T_api, T_ser, T_fusion, T_infer, T_ir, T_closure, T_codegen, T_step,
            _arr_torch, _read_torch)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------

# tests/core/test_lowering.py and tests/core/test_fusion.py


def _cube(x):
    return x**3


def _poly(x):
    return 2.0 * x**3 + 4.0 * x * x + x + 1.0


def _mlp(P):
    def mlp(x, w):
        return P.reduce_sum(P.tanh(x @ w), None, False)

    return mlp


def _two_layer(P):
    def two_layer(w1, w2, x):
        h = P.tanh(x @ w1)
        return P.reduce_sum(P.tanh(h @ w2), (0, 1), False)

    return two_layer


def _reduce_chain(P):
    def reduce_chain(x):
        return P.reduce_sum(P.tanh(x) * P.sigmoid(x) + 1.0, (0, 1), False)

    return reduce_chain


def _softplusish(P):
    def softplusish(x, w):
        h = x @ w
        return P.reduce_sum(P.log(1.0 + P.exp(h)) * P.sigmoid(h), (0, 1), False)

    return softplusish


# benchmarks/bench_compile_time.py's VM-fallback corpus


def _sq(y):
    return y * y


def _iterate(f, x, n):
    i = 0
    while i < n:
        x = f(x)
        i = i + 1
    return x


def _while_pow(x, n):
    i = 0
    acc = x
    while i < n:
        acc = acc * x
        i = i + 1
    return acc


def _for_fold(x):
    s = 0.0
    for i in range(5):
        s = s + x * x
    return s


def _defunc(x, n):
    return _iterate(_sq, x, n)


def _partial(x, y, n):
    g = lambda z: z * y  # noqa: E731
    return _iterate(g, x, n)


def _compose_use(x):
    h = lambda v: _sq(_sq(v))  # noqa: E731
    return h(x)


def _fold_rec(x, n):
    if n == 0:
        return 1.0
    return x * _fold_rec(x, n - 1)


def _nested(x, n):
    i = 0
    s = 0.0
    while i < n:
        j = 0
        while j < i:
            s = s + x
            j = j + 1
        i = i + 1
    return s


def _mlp_sum(P):
    def mlp_sum(w, x):
        return P.reduce_sum(P.tanh(x @ w), None, False)

    return mlp_sum


# tests/core/test_ad_higher_order.py


def _exp_sq(P):
    def exp_sq(x):
        return P.exp(x * x)

    return exp_sq


def _closure_sq(x, y):
    def inner(z):
        return z * z * y

    return inner(x)


def _lm_loss(side):
    return side.step.build_lm_loss(side.step.MyiaLMDims(96, 16, 40), 2, 8)


def _plain(fn):
    return lambda side: fn


def _with_P(factory):
    return lambda side: factory(side.P)


_F = np.asarray(1.3, np.float32)
_N = np.asarray(4, np.int32)
_WM = np.ones((4, 4), np.float32) * 0.3
_XM = np.ones((2, 4), np.float32)
_LIN = np.linspace(-2, 2, 32, dtype=np.float32).reshape(4, 8)


def _lm_args():
    params = R_step.init_lm_params(R_step.MyiaLMDims(96, 16, 40), jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    tok = rs.randint(0, 96, (2, 8)).astype(np.int32)
    lab = rs.randint(0, 96, (2, 8)).astype(np.int32)
    return (*(np.asarray(p) for p in params), tok, lab)


# name: (make(side) -> function, AD transforms, args, arm the loop pipeline, in the
# 11-program corpus).  Transforms: ("grad", wrt) applied in order, or ("vag", wrt).
CORPUS = {
    # test_lowering.py
    "grad_cube": (_plain(_cube), (("grad", 0),), (_F,), False, False),
    "grad_poly": (_plain(_poly), (("grad", 0),), (_F,), False, False),
    "grad_mlp": (_with_P(_mlp), (("grad", 1),),
                 (np.ones((3, 4), np.float32) * 0.3, np.ones((4, 5), np.float32) * 0.2),
                 False, False),
    "grad_two_layer": (_with_P(_two_layer), (("grad", 0),),
                       (np.ones((8, 8), np.float32) * 0.1, np.ones((8, 8), np.float32) * 0.2,
                        np.ones((4, 8), np.float32) * 0.7), False, False),
    "fwd_poly": (_plain(_poly), (), (_F,), False, False),
    # test_fusion.py
    "fwd_reduce_chain": (_with_P(_reduce_chain), (), (_LIN,), False, False),
    "grad_reduce_chain": (_with_P(_reduce_chain), (("grad", 0),), (_LIN,), False, False),
    "grad_softplusish": (_with_P(_softplusish), (("grad", 1),),
                         (np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 6),
                          np.ones((6, 8), np.float32) * 0.3), False, False),
    # bench_compile_time.py's _fallback_corpus
    "fb_fwd_mlp": (_with_P(_mlp_sum), (), (_WM, _XM), False, True),
    "fb_grad_mlp": (_with_P(_mlp_sum), (("grad", 0),), (_WM, _XM), False, True),
    "fb_grad2_cube": (_plain(_cube), (("grad", 0), ("grad", 0)), (_F,), False, True),
    "fb_while_pow": (_plain(_while_pow), (), (_F, _N), False, True),
    "fb_for_fold": (_plain(_for_fold), (), (_F,), False, True),
    "fb_defunc_iterate": (_plain(_defunc), (), (_F, _N), False, True),
    "fb_partial_application": (_plain(_partial), (), (_F, _F, _N), False, True),
    "fb_compose": (_plain(_compose_use), (), (_F,), False, True),
    "fb_grad_while_pow": (_plain(_while_pow), (("grad", 0),), (_F, _N), True, True),
    "fb_fold_rec_grad": (_plain(_fold_rec), (("grad", 0),), (_F, 5), True, True),
    "fb_nested_loops": (_plain(_nested), (), (_F, _N), False, True),
    # test_ad_higher_order.py
    "grad2_exp_sq": (_with_P(_exp_sq), (("grad", 0), ("grad", 0)),
                     (np.asarray(0.7, np.float32),), False, False),
    "grad2_closure": (_plain(_closure_sq), (("grad", 0), ("grad", 0)),
                      (np.asarray(3.0, np.float32), np.asarray(5.0, np.float32)), False, False),
    # the --compiler myia LM loss, V 96 / D 16 / H 40, batch 2 x 8
    "lm_loss_vag": (_lm_loss, (("vag", (0, 1, 2, 3)),), None, False, False),
}
NAMES = sorted(CORPUS)
FALLBACK_11 = sorted(n for n in NAMES if CORPUS[n][4])


def _args(name):
    args = CORPUS[name][2]
    return _lm_args() if args is None else args


class Built:
    """One program through one package: its stages and what they produced."""

    def __init__(self, side: Side, name: str) -> None:
        make, transforms, _, example, _ = CORPUS[name]
        self.side = side
        self.args = tuple(side.arr(a) for a in _args(name))
        self.abstracts = tuple(side.infer.abstract_of_value(a) for a in self.args)
        g = side.core.parse_function(make(side))
        self.parsed = g
        for kind, wrt in transforms:
            build = {"grad": side.core.build_grad_graph,
                     "vag": side.core.build_value_and_grad_graph}[kind]
            g = build(g, wrt, example_args=self.args if example else None)
        self.adjoint = g
        self.stats = side.core.OptStats()
        self.optimized = side.api.compile_pipeline(g, self.abstracts, stats=self.stats)


@functools.lru_cache(maxsize=None)
def built(name: str) -> tuple[Built, Built]:
    return Built(REF, name), Built(PORT, name)


def _enc(side: Side, g, loose: bool) -> tuple[str, str]:
    return (side.ser.dumps(g, names=False, loose=loose),
            side.ser.structural_hash(g, loose=loose))


def _flat(x):
    if isinstance(x, tuple):
        out = []
        for e in x:
            out += _flat(e)
        return out
    return [x]


# ---------------------------------------------------------------------------
# Exact parity
# ---------------------------------------------------------------------------


def test_corpus_has_the_fallback_corpus():
    assert len(FALLBACK_11) == 11


@pytest.mark.parametrize("name", NAMES)
def test_parsed_encoding_equal(name):
    r, t = built(name)
    assert _enc(PORT, t.parsed, True) == _enc(REF, r.parsed, True)
    assert PORT.ser.dumps(t.parsed, loose=True) == REF.ser.dumps(r.parsed, loose=True)


@pytest.mark.parametrize("name", NAMES)
def test_adjoint_encoding_equal(name):
    r, t = built(name)
    assert _enc(PORT, t.adjoint, True) == _enc(REF, r.adjoint, True)


@pytest.mark.parametrize("name", NAMES)
def test_optimized_encoding_equal(name):
    r, t = built(name)
    assert _enc(PORT, t.optimized, False) == _enc(REF, r.optimized, False)


@pytest.mark.parametrize("name", NAMES)
def test_opt_stats_equal(name):
    """Rule hits and inliner activity (``worklist_pops`` is left out: it follows
    the iteration order of node-id sets, and varies between runs of the
    reference itself)."""
    r, t = built(name)
    for field in ("rule_hits", "inlined_calls", "inline_waves", "verify_sweep_hits",
                  "iterations", "fallback_reasons"):
        assert getattr(t.stats, field) == getattr(r.stats, field), field


@pytest.mark.parametrize("name", NAMES)
def test_inferred_abstracts_equal(name):
    r, t = built(name)
    assert repr(t.abstracts) == repr(r.abstracts)
    out_r = REF.core.infer(r.optimized, *r.abstracts)
    out_t = PORT.core.infer(t.optimized, *t.abstracts)
    assert repr(out_t) == repr(out_r)

    def node_abstracts(side, g):
        return [repr(n.abstract) for n in side.ir.toposort(g)]

    assert node_abstracts(PORT, t.optimized) == node_abstracts(REF, r.optimized)


def _plan(side: Side, g):
    plan = side.fusion.partition_graph(g)
    clusters = []
    for c in plan.clusters:
        kernel, reason = side.codegen.emit_cluster_explained(c)
        clusters.append((
            c.kind, tuple(c.body_shape), tuple(c.out_shape), str(c.out_dtype),
            tuple(n.fn.value.name for n in c.order), len(c.inputs),
            None if reason is None else reason.kind,
            None if kernel is None else kernel.bytes_moved,
        ))
    return clusters, plan.stats()


@pytest.mark.parametrize("name", NAMES)
def test_fusion_plan_equal(name):
    r, t = built(name)
    assert _plan(PORT, t.optimized) == _plan(REF, r.optimized)
    fused_r = R.lower_graph(r.optimized, fuse=True).__fusion_plan__.stats() \
        if not R.lowering_blockers(r.optimized) else None
    fused_t = T.lower_graph(t.optimized, fuse=True).__fusion_plan__.stats() \
        if not T.lowering_blockers(t.optimized) else None
    assert fused_t == fused_r


@pytest.mark.parametrize("name", NAMES)
def test_specialize_lowered_equal(name):
    r, t = built(name)
    lowered_r = REF.api.MyiaFunction(graph=r.adjoint).specialize(r.args).lowered
    lowered_t = PORT.api.MyiaFunction(graph=t.adjoint).specialize(t.args).lowered
    assert lowered_t == lowered_r


@pytest.mark.parametrize("name", FALLBACK_11)
def test_no_vm_fallback(name):
    r, t = built(name)
    assert [b.kind for b in PORT.closure.analyze_blockers(t.optimized)] == []
    assert [b.kind for b in REF.closure.analyze_blockers(r.optimized)] == []
    assert t.stats.fallback_reasons == [] == r.stats.fallback_reasons


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_values_and_gradients_allclose(name):
    r, t = built(name)
    got_r = _flat(R.lower_graph(r.optimized)(*r.args))
    got_t = _flat(T.lower_graph(t.optimized)(*t.args))
    assert len(got_t) == len(got_r)
    for a, b in zip(got_t, got_r):
        a, b = PORT.read(a), REF.read(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["grad_mlp", "fb_grad_while_pow", "lm_loss_vag"])
def test_fused_and_vm_paths_agree_with_the_reference(name):
    """The port's fused lowering (through ``compile_graph``) and its VM
    (``trace_graph``) on the optimized graph give the reference's values too."""
    r, t = built(name)
    want = [REF.read(x) for x in _flat(R.lower_graph(r.optimized)(*r.args))]
    compiled = T.compile_graph(t.optimized, fuse=True)
    assert compiled.lowered
    fused = _flat(compiled(*t.args))
    vm = _flat(T.trace_graph(t.optimized)(*t.args))
    for got in (fused, vm):
        for a, b in zip(got, want):
            np.testing.assert_allclose(PORT.read(a), b, rtol=RTOL, atol=ATOL)
