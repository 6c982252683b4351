"""The port's OO tape (``repro_torch.core.oo_tape``) against the reference's.

Every case of ``tests/core/test_oo_tape.py``, on the same numpy inputs, held
three ways:

* against the reference's ``oo_grad`` and its ST ``myia.grad``, to rtol 1e-5
  (scalar workloads: the tapes compute in Python float64, the ST pipelines in
  f32; array workloads: torch's and XLA's CPU tanh and sums differ by ulps);
* inside the port, against the port's ST gradient, **bitwise**, unfused and
  fused (on the CPU a fused cluster runs K1's torch oracle): the tape and the
  lowered adjoint run the same eager torch ops in the same dataflow, so there
  is nothing to round apart.  The one exception is the value of a full
  reduction (the loss), which the reference also compares by allclose; here it
  is bitwise too (both call ``torch.sum`` on the same tensor);
* against ``torch.autograd`` as a third oracle, to rtol 1e-6: its tanh and
  relu backward kernels compute the same formulas, but are other kernels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core.primitives as RP
import repro_torch.core.primitives as TP
from repro.core import api as R_api
from repro.core import oo_tape as R_oo
from repro_torch.core import api as T_api
from repro_torch.core import oo_tape as T_oo

RTOL = 1e-5


def scalar_chain(x, y):
    """The paper's footnote-1 pathology: an unrolled scalar recurrence."""
    z = x
    z = z * y + x
    z = z * z + y
    z = z * y + x
    z = z * z + y
    z = z * y + x
    z = z * z + y
    return z


def poly(x):
    return 2.0 * x * x * x + 4.0 * x * x + x + 1.0


def cube(x):
    return x * x * x


def _mlp_pair(oo, P):
    def oo_loss(w1, w2, x):
        h = oo.tanh(x @ w1)
        return oo.reduce_sum(oo.tanh(h @ w2))

    def st_loss(w1, w2, x):
        h = P.tanh(x @ w1)
        return P.reduce_sum(P.tanh(h @ w2), (0, 1), False)

    return oo_loss, st_loss


def _relu_pair(oo, P):
    def oo_loss(w, x):
        return oo.reduce_sum(oo.relu(x @ w))

    def st_loss(w, x):
        return P.reduce_sum(P.relu(x @ w), (0, 1), False)

    return oo_loss, st_loss


def _np_arrays(*shapes, seed=0):
    return tuple(
        np.random.default_rng(seed + i).standard_normal(s).astype(np.float32)
        for i, s in enumerate(shapes)
    )


def _t(arrs):
    return tuple(torch.from_numpy(a.copy()) for a in arrs)


def _j(arrs):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in arrs)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _autograd(fn, wrt, args):
    ins = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
    out = fn(*ins)
    return out.detach(), torch.autograd.grad(out, [ins[i] for i in wrt])


def _torch_mlp(w1, w2, x):
    return torch.sum(torch.tanh(torch.tanh(x @ w1) @ w2))


def _torch_relu(w, x):
    return torch.sum(torch.relu(x @ w))


# -- scalar workloads -------------------------------------------------------------


@pytest.mark.parametrize("args", [(0.3, 0.7), (1.5, -0.2), (-0.9, 0.1)])
def test_scalar_chain_grads(args):
    got = T_oo.oo_grad(scalar_chain, wrt=(0, 1))(*args)
    assert all(isinstance(g, float) for g in got)  # floats stay floats on the tape
    # the same float64 arithmetic in the same order as the reference's tape
    assert got == R_oo.oo_grad(scalar_chain, wrt=(0, 1))(*args)
    for st in (R_api.grad(scalar_chain, wrt=(0, 1))(*args),
               T_api.grad(scalar_chain, wrt=(0, 1))(*args)):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray([float(s) for s in st], np.float64), rtol=RTOL)


@pytest.mark.parametrize("fn,x", [(poly, 1.3), (poly, -0.4), (cube, 2.0)])
def test_polynomials(fn, x):
    got = T_oo.oo_grad(fn)(x)
    assert got == float(R_oo.oo_grad(fn)(x))
    np.testing.assert_allclose(got, float(R_api.grad(fn)(x)), rtol=RTOL)
    np.testing.assert_allclose(got, float(T_api.grad(fn)(x)), rtol=RTOL)


def test_cube_vm_backend_bit_match():
    """On the VM backend nothing ever leaves Python floats, so the
    multiplicative chain matches the tape bit for bit, in both packages."""
    got = T_oo.oo_grad(cube)(1.3)
    assert got == float(T_api.grad(cube, options=T_api.CompileOptions(backend="vm"))(1.3))
    assert got == float(R_api.grad(cube, options=R_api.CompileOptions(backend="vm"))(1.3))


def test_value_and_grad_value_agrees():
    ov, og = T_oo.oo_value_and_grad(scalar_chain, wrt=0)(0.3, 0.7)
    rv, rg = R_oo.oo_value_and_grad(scalar_chain, wrt=0)(0.3, 0.7)
    assert (ov, og) == (float(rv), float(rg))
    sv, sg = T_api.value_and_grad(scalar_chain, wrt=0)(0.3, 0.7)
    np.testing.assert_allclose(ov, float(sv), rtol=1e-6)
    np.testing.assert_allclose(og, float(sg), rtol=RTOL)


# -- array workloads --------------------------------------------------------------

ARRAY_CASES = {
    # name: (pair, shapes, seed, wrt, autograd twin)
    "mlp_grads": (_mlp_pair, ((8, 8), (8, 8), (4, 8)), 0, (0, 1), _torch_mlp),
    "mlp_grad_wrt_input": (_mlp_pair, ((6, 6), (6, 6), (3, 6)), 5, 2, _torch_mlp),
    "relu_grads": (_relu_pair, ((8, 4), (5, 8)), 9, 0, _torch_relu),
    "value_and_grad": (_mlp_pair, ((8, 8), (8, 8), (4, 8)), 3, (0, 1), _torch_mlp),
    "fused_tier": (_mlp_pair, ((8, 8), (8, 8), (4, 8)), 7, (0, 1), _torch_mlp),
}


def _tuple(g):
    return g if isinstance(g, tuple) else (g,)


@pytest.mark.parametrize("name", sorted(ARRAY_CASES))
def test_array_workload_matches_the_reference(name):
    pair, shapes, seed, wrt, _ = ARRAY_CASES[name]
    arrs = _np_arrays(*shapes, seed=seed)
    t_oo, _ = pair(T_oo, TP)
    r_oo, r_st = pair(R_oo, RP)
    tv, tg = T_oo.oo_value_and_grad(t_oo, wrt=wrt)(*_t(arrs))
    rv, rg = R_oo.oo_value_and_grad(r_oo, wrt=wrt)(*_j(arrs))
    r_opts = R_api.CompileOptions(fuse=name == "fused_tier")
    sv, sg = R_api.value_and_grad(r_st, wrt=wrt, options=r_opts)(*_j(arrs))
    for want_v, want_g in ((rv, rg), (sv, sg)):
        np.testing.assert_allclose(_np(tv), np.asarray(want_v), rtol=RTOL)
        for u, v in zip(_tuple(tg), _tuple(want_g), strict=True):
            np.testing.assert_allclose(_np(u), np.asarray(v), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", sorted(ARRAY_CASES))
def test_array_workload_tape_equals_the_st_gradient_bitwise(name, fuse):
    pair, shapes, seed, wrt, _ = ARRAY_CASES[name]
    args = _t(_np_arrays(*shapes, seed=seed))
    oo_loss, st_loss = pair(T_oo, TP)
    ov, og = T_oo.oo_value_and_grad(oo_loss, wrt=wrt)(*args)
    st = T_api.value_and_grad(st_loss, wrt=wrt, options=T_api.CompileOptions(fuse=fuse))
    sv, sg = st(*args)
    if fuse:
        assert st.specialize(args).fn.__fusion_plan__.clusters  # a cluster ran its oracle
    assert torch.equal(ov, sv)
    for u, v in zip(_tuple(og), _tuple(sg), strict=True):
        assert torch.equal(u, v)


@pytest.mark.parametrize("name", sorted(ARRAY_CASES))
def test_array_workload_matches_torch_autograd(name):
    pair, shapes, seed, wrt, twin = ARRAY_CASES[name]
    args = _t(_np_arrays(*shapes, seed=seed))
    oo_loss, _ = pair(T_oo, TP)
    wrt_t = _tuple(wrt)
    ov, og = T_oo.oo_value_and_grad(oo_loss, wrt=wrt_t)(*args)
    av, ag = _autograd(twin, wrt_t, args)
    torch.testing.assert_close(ov, av, rtol=1e-6, atol=0)
    for u, v in zip(og, ag, strict=True):
        torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-7)


def test_the_tape_records_every_call_and_uses_no_autograd():
    """The tape is traced anew at every call (the footnote-1 cost), and the
    arrays it returns carry no autograd graph."""
    oo_loss, _ = _mlp_pair(T_oo, TP)
    vag = T_oo.oo_value_and_grad(oo_loss, wrt=(0, 1))
    args = _t(_np_arrays((8, 8), (8, 8), (4, 8)))
    for _ in range(2):
        _, grads = vag(*args)
        # matmul, tanh, matmul, tanh, reduce_sum
        assert vag.tape_entries == 5
        assert all(g.grad_fn is None and not g.requires_grad for g in grads)
    vag_s = T_oo.oo_value_and_grad(scalar_chain, wrt=(0, 1))
    vag_s(0.3, 0.7)
    assert vag_s.tape_entries == 12  # six multiplies and six adds


def test_an_unused_input_gets_a_zero_gradient():
    def f(x, y):
        return T_oo.reduce_sum(x * x)

    x, y = _t(_np_arrays((3, 4), (2,)))
    gx, gy = T_oo.oo_grad(f, wrt=(0, 1))(x, y)
    assert torch.equal(gx, x + x)  # d(x·x) = d·x + d·x on the tape
    assert torch.equal(gy, torch.zeros(2))
