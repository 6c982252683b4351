"""The fusion tier inside the port, and the kernel primitives across packages.

* K1's torch oracle twins are bitwise equal to the unfused lowering (the same
  primitive impl calls in the same order), for every program of the shared
  corpus and every case of ``repro_torch.kernels.k1_cases``; on a CPU tensor a
  fused kernel runs its oracle and launches nothing.
* The generated source is plain Python that parses, with one ``@triton.jit``
  kernel per cluster, its launch wrapper and its oracle, made without
  importing ``triton``.
* The ``--compiler myia`` LM step's plan is exactly the reference's four
  clusters: 3 map and 1 reduce.
* The kernel mode takes the port's implementations only; the compile options
  of later slices raise, naming their ROADMAP item.
* The kernel primitives (``rmsnorm``, ``flash_attention``, ``ssd_scan``) work
  through Myia's ``grad``, and the ``patterns=True`` rewrites hit the same rules
  and give the reference's values (f32, rtol 1e-5).
"""

from __future__ import annotations

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.kernels.ops as R_ops
import repro_torch.core as T
import repro_torch.kernels.ops as T_ops
from repro_torch import kernels
from repro_torch.kernels import k1_cases
from repro_torch.launch.myia_step import MyiaLMDims, make_myia_train_step
from test_torch_myia_corpus import NAMES, built


@pytest.fixture(autouse=True)
def _restore_kernel_mode():
    mode = kernels.get_kernel_mode()
    yield
    kernels.set_kernel_mode(mode)


def _flat(x):
    if isinstance(x, tuple):
        return [y for e in x for y in _flat(e)]
    return [x]


def _triton_kernels(source: str) -> list[str]:
    tree = ast.parse(source)
    return [
        f.name for f in tree.body
        if isinstance(f, ast.FunctionDef)
        and any(ast.unparse(d) == "triton.jit" for d in f.decorator_list)
    ]


@pytest.mark.parametrize("name", NAMES)
def test_fused_oracles_match_the_unfused_lowering_bitwise(name):
    _, t = built(name)
    if T.lowering_blockers(t.optimized):
        pytest.fail(f"{name} does not lower")
    kernels.reset_launches()
    unfused = _flat(T.lower_graph(t.optimized)(*t.args))
    fused_fn = T.lower_graph(t.optimized, fuse=True)
    fused = _flat(fused_fn(*t.args))
    assert kernels.LAUNCHES["fused_map"] == kernels.LAUNCHES["fused_reduce"] == 0
    for a, b in zip(fused, unfused):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name
    for k in fused_fn.__fused_kernels__:
        assert _triton_kernels(k.source) == [k.name]


ALL_CASES = sorted({**k1_cases.ELEMENTWISE_CASES, **k1_cases.REDUCE_CASES})


@pytest.mark.parametrize("name", ALL_CASES)
def test_k1_case_forms_a_cluster_and_its_oracle_is_exact(name):
    prog = {**k1_cases.ELEMENTWISE_CASES, **k1_cases.REDUCE_CASES}[name]
    kind = "map" if name in k1_cases.ELEMENTWISE_CASES else "reduce"
    shape = (k1_cases.ELEMENTWISE_SHAPES if kind == "map" else k1_cases.REDUCE_SHAPES)[1]
    for y_rank in (3, 1, 0):
        x, y = k1_cases.case_inputs(name, shape, y_rank, torch.float32, "cpu")
        fused = k1_cases.compile_case(prog, x, y)
        ks = fused.__fused_kernels__
        assert ks and {k.kind for k in ks} == {kind}, (name, y_rank)
        for k in ks:
            src = k.source
            assert _triton_kernels(src) == [k.name]
            assert "def _launch(" in src and "def _oracle(" in src
            assert "enable_fp_fusion=False" in src
            assert src.count("    _counted()") == k.launches_per_call
        got = fused(x, y)
        want = k1_cases.compile_case(prog, x, y, fuse=False)(x, y)
        assert got.dtype == want.dtype and torch.equal(got, want), (name, y_rank)


def test_map_kernel_reads_broadcasts_as_strided_views():
    """An ``unreduce`` member and a smaller input are expand views in the wrapper
    (stride 0 on the broadcast axes), never materialised at the body shape."""
    dims = MyiaLMDims(96, 16, 40)
    step_fn, init_fn = make_myia_train_step(dims, 2, 8, 0.1, device="cpu")
    tok = torch.zeros((2, 8), dtype=torch.int32)
    g = step_fn.vag.optimized_graph(*init_fn()["params"], tok, tok)
    fn = T.lower_graph(g, fuse=True)
    first = fn.__fused_kernels__[0]
    assert first.name.startswith("fused_map") and first.name.endswith("unreduce_eq_cast")
    assert "_prim_unreduce_0(a0, (2, 8, 96), (2,), True)" in first.source
    assert "torch.broadcast_to(" in first.source and ".contiguous()" not in first.source


def _int_power(x, y):
    return (x * y + 1) ** (y + 2)


def test_a_cluster_the_kernel_cannot_compute_is_emitted_and_raises_at_launch():
    """Integer ``power`` has no Triton rendering: the cluster still emits (the
    plan stays the reference's), its oracle runs on the CPU, and its kernel
    module raises instead of computing something else."""
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    y = torch.ones((2, 3), dtype=torch.int32)
    fn = k1_cases.compile_case(_int_power, x, y)
    (k,) = fn.__fused_kernels__
    assert "raise NotImplementedError('integer power in a fused kernel')" in k.source
    assert _triton_kernels(k.source) == []
    assert torch.equal(fn(x, y), k1_cases.compile_case(_int_power, x, y, fuse=False)(x, y))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64])
def test_a_cluster_of_a_wide_dtype_is_emitted_and_raises_at_launch(dtype):
    """The kernels compute in 32 bits at most: a 64-bit cluster gets the raising
    kernel module rather than one that narrows it quietly."""
    x = torch.arange(6, dtype=dtype).reshape(2, 3)
    fn = k1_cases.compile_case(_mul_add_sub, x, x)
    (k,) = fn.__fused_kernels__
    assert "raise NotImplementedError('fused kernels do not take dtype" in k.source
    assert _triton_kernels(k.source) == []
    assert torch.equal(fn(x, x), k1_cases.compile_case(_mul_add_sub, x, x, fuse=False)(x, x))


def _mul_add_sub(x, y):
    return (x * y + x) - y


def test_lm_step_plan_is_the_four_clusters():
    dims = MyiaLMDims(96, 16, 40)
    step_fn, init_fn = make_myia_train_step(dims, 2, 8, 0.1, device="cpu")
    tok = torch.zeros((2, 8), dtype=torch.int32)
    args = (*init_fn()["params"], tok, tok)
    runner = step_fn.vag.specialize(args)
    assert runner.lowered
    plan = runner.fn.__fusion_plan__
    assert [(c.kind, c.body_shape, [n.fn.value.name for n in c.order]) for c in plan.clusters] \
        == [("map", (2, 8, 96), ["unreduce", "eq", "cast"]),
            ("map", (2, 8, 16), ["mul", "sub", "mul"]),
            ("map", (2, 8, 40), ["mul", "sub", "mul"]),
            ("reduce", (2, 8, 96), ["sub", "mul", "reduce_sum"])]
    assert plan.stats()["launches_before"] == 64 and plan.stats()["launches_after"] == 56
    # the cross-entropy sum splits over programs and combines them in a second pass
    assert [k.launches_per_call for k in runner.fn.__fused_kernels__] == [1, 1, 1, 2]


def test_kernel_mode_takes_the_ports_implementations():
    for mode in (None, "ref", "chunked"):
        kernels.set_kernel_mode(mode)
        assert kernels.get_kernel_mode() == mode
    for bad in ("pallas_interpret", "pallas", "nope"):
        with pytest.raises(ValueError):
            kernels.set_kernel_mode(bad)


@pytest.mark.parametrize("field,value,item", [
    ("program_cache", object(), "A5"), ("graph_cache", object(), "A5"),
    ("in_specs", (None,), "A9"), ("profile", True, "A6"),
])
def test_compile_options_of_later_slices_raise(field, value, item):
    """The options of slices still to port raise naming their ROADMAP item;
    those of A5 (the program cache) and A6 (the profiler), ported since, are
    accepted and held."""
    if item == "A9":
        with pytest.raises(NotImplementedError, match=item):
            T.CompileOptions(**{field: value})
    else:
        assert getattr(T.CompileOptions(**{field: value}), field) is value


def test_explain_and_profiled_lowering_raise():
    """``explain`` and ``lower_graph(profile=True)`` (ROADMAP item A6) raised
    until the obs slice; now the first reports and the second instruments
    every launch, computing the same values."""
    def f(x):
        return x * x

    report = T.myia(f).explain(torch.ones(2))
    assert report["program"] == "f" and report["fallback"]["lowers"]
    g = T.parse_function(f)
    fn = T.lower_graph(g, profile=True)
    assert "_prof(" in fn.__lowered_source__
    assert torch.equal(fn(torch.full((2,), 3.0)), torch.full((2,), 9.0))


# -- the kernel primitives through Myia, against the reference -------------------


def _rms_loss(P, ops):
    def loss(x, w):
        return P.reduce_sum(ops.rmsnorm_prim(x, w, 1e-6) * x, (0, 1), False)

    return loss


def _attn_loss(P, ops):
    def loss(q, k, v):
        return P.reduce_sum(ops.flash_attention_prim(q, k, v, True, None, None), None, False)

    return loss


def _ssd_loss(P, ops):
    def loss(x, dt, A, B, C):
        return P.reduce_sum(P.tanh(ops.ssd_scan_prim(x, dt, A, B, C)), None, False)

    return loss


def _rms_user(P, ops):
    def rms(x, w):
        ms = P.reduce_sum(x * x, (1,), True) / 8.0
        return P.reduce_sum(x * P.rsqrt(ms + 1e-6) * w, (0, 1), False)

    return rms


def _attn_user(P, ops):
    def attn(q, k, v):
        s = (q @ P.mT(k)) * 0.35355339059327373
        m = P.reduce_max(s, (3,), True)
        e = P.exp(s - m)
        z = P.reduce_sum(e, (3,), True)
        return P.reduce_sum((e / z) @ v, None, False)

    return attn


_rs = np.random.RandomState(3)
KERNEL_PROGRAMS = {
    "rmsnorm_prim": (_rms_loss, (0, 1), False,
                     (_rs.randn(4, 8).astype(np.float32),
                      np.linspace(0.5, 1.5, 8).astype(np.float32))),
    "flash_attention_prim": (_attn_loss, (0, 1, 2), False,
                             tuple(_rs.randn(1, 2, 16, 8).astype(np.float32) for _ in range(3))),
    "ssd_scan_prim": (_ssd_loss, (0, 1, 3, 4), False,
                      (_rs.randn(1, 12, 2, 4).astype(np.float32),
                       np.abs(_rs.randn(1, 12, 2)).astype(np.float32) * 0.5,
                       -np.abs(_rs.randn(2)).astype(np.float32),
                       _rs.randn(1, 12, 1, 4).astype(np.float32),
                       _rs.randn(1, 12, 1, 4).astype(np.float32))),
    "pattern_rmsnorm": (_rms_user, (0, 1), True,
                        (_rs.randn(4, 8).astype(np.float32),
                         np.linspace(0.5, 1.5, 8).astype(np.float32))),
    "pattern_flash_attention": (_attn_user, (0, 1, 2), True,
                                tuple(_rs.randn(2, 4, 16, 8).astype(np.float32)
                                      for _ in range(3))),
}


@pytest.mark.parametrize("name", sorted(KERNEL_PROGRAMS))
def test_kernel_primitives_through_myia_grad_match_the_reference(name):
    make, wrt, patterns, args = KERNEL_PROGRAMS[name]
    stats_r, stats_t = R.OptStats(), T.OptStats()
    fn_r = make(R.P, R_ops)
    fn_t = make(T.P, T_ops)
    g_r = R.api.compile_pipeline(
        R.build_value_and_grad_graph(R.parse_function(fn_r), wrt),
        tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in args),
        stats=stats_r, patterns=patterns)
    g_t = T.api.compile_pipeline(
        T.build_value_and_grad_graph(T.parse_function(fn_t), wrt),
        tuple(torch.empty(a.shape, device="meta") for a in args),
        stats=stats_t, patterns=patterns)
    assert stats_t.rule_hits == stats_r.rule_hits
    if patterns:
        assert stats_t.rule_hits.get(name) == 1
    assert R.serialize.structural_hash(g_r) == T.serialize.structural_hash(g_t)
    want = _flat(R.lower_graph(g_r)(*(jnp.asarray(a) for a in args)))
    got = _flat(T.lower_graph(g_t)(*(torch.from_numpy(a.copy()) for a in args)))
    assert len(got) == len(want) == 1 + len(wrt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
