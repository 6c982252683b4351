"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips.  The shapes are the cases of
``tests/kernels/test_flash_attention.py`` (shared with ``test_torch_kernels.py``),
ragged edges the TPU kernel's tiling could not take, and the rmsnorm shapes of
the gemma3-1b serving path and the internlm2-1.8b training path; for the SSD scan
(K5) the cases of ``tests/kernels/test_ssd_scan.py``, a ragged sequence, the
mamba2-reduced shape and the mamba2-370m serving shape.  Tolerances: 2e-5 in f32
(the same f32 math summed in another order), 2e-2 in bf16 (outputs rounded to bf16
after f32 math); the rmsnorm backward takes 1e-4/1e-5, as
``tests/kernels/test_rmsnorm.py`` does (dw sums thousands of rows in another
order), and attention gradients 2e-4, as ``tests/kernels/test_flash_attention.py``
does.  The SSD scan takes 2e-4 in f32, as ``tests/kernels/test_ssd_scan.py`` holds
the chunked kernel against the stepwise recurrence (the chunk's decays are
differences of a cumsum, not products of per-step factors); its bf16 y takes 2e-2
and its f32 state 2e-4 (both compute in f32 from the same bf16 inputs).

K1, the Triton kernels generated per fusion cluster (``kernels/codegen.py``), is held
against its torch oracles on the programs of ``repro_torch.kernels.k1_cases``: every
elementwise primitive of the fusion tier at ragged body shapes with the second
operand at rank 3, 1 and 0, in f32 and bf16, within an ulp (``power`` two), and
every reduction root over leading, trailing, middle, two and all axes, allclose.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import k1_cases, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.models import model as tmodel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
SSD_TOL = dict(rtol=2e-4, atol=2e-4)


def assert_dw_close(got, want, x, w, dy):
    """dw sums every row in another order than the plain version: the f32 error of a
    sum grows with the sum of the magnitudes of its terms (about log2(rows)·ε·Σ|term|
    for a tree sum), so the bound is 1e-6·Σ_rows|dy·x·r| (about 17 ε) plus 1e-5."""
    mag = f32(tref.rmsnorm_bwd_ref(x.abs(), w, dy.abs())[1])  # Σ|dy|·|x|·r, r unchanged
    err = np.abs(f32(got) - f32(want))
    assert (err <= 1e-5 + 1e-6 * mag).all(), (err.max(), (err / (1e-5 + 1e-6 * mag)).max())

# name: (B, H, KVH, Sq, Skv, D, causal, window, block_q, block_k); the blocks are
# the reference kernel's tiling, used where it runs in interpret mode
FA_CASES = {
    "mha_noncausal": (2, 4, 2, 128, 128, 64, False, None, 64, 64),
    "mha_causal": (2, 4, 2, 128, 128, 64, True, None, 64, 64),
    "sliding_window_64": (1, 2, 2, 256, 256, 32, True, 64, 64, 64),
    "gqa_8_over_2": (1, 8, 2, 64, 64, 32, True, None, 32, 32),
    "window_wider_than_seq": (1, 2, 1, 64, 64, 32, True, 4096, 32, 32),
    "cross_sq_ne_skv": (2, 4, 4, 64, 128, 32, False, None, 32, 64),
    "head_dim_128": (1, 2, 1, 64, 64, 128, True, None, 32, 32),
}


# name: (Bt, S, H, P, G, N): the shapes of tests/kernels/test_ssd_scan.py (chunk
# sweep, single chunk, property-sweep corners), a ragged S with G > 1, and the
# mamba2-reduced serving shape (H = 8 heads of 16, N = 16, a 12-token prompt)
SSD_CASES = {
    "chunk_sweep": (2, 64, 4, 16, 2, 32),
    "single_chunk": (1, 32, 2, 8, 1, 16),
    "groups_4_of_4": (2, 128, 4, 8, 4, 16),
    "groups_2_of_1": (1, 32, 2, 16, 1, 32),
    "ragged_200": (2, 200, 4, 16, 2, 32),
    "mamba2_reduced": (2, 12, 8, 16, 1, 16),
}


def make_ssd(seed, Bt, S, H, P, G, N):
    """x, dt, A, B, C as tests/kernels/test_ssd_scan.py draws them: dt in
    [0.01, 0.2], A = -exp(0.5·normal)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(Bt, S, H, P).astype(np.float32)
    dt = (0.01 + 0.19 * rs.rand(Bt, S, H)).astype(np.float32)
    A = (-np.exp(0.5 * rs.randn(H))).astype(np.float32)
    B = rs.randn(Bt, S, G, N).astype(np.float32)
    C = rs.randn(Bt, S, G, N).astype(np.float32)
    return x, dt, A, B, C


def extreme_decay_ssd():
    """The inputs of test_ssd_scan.py's known chunked-backward fault: dt·A down to -62."""
    Bt, S, H, P, N = 1, 16, 2, 4, 4
    return (
        np.ones((Bt, S, H, P), np.float32),
        np.full((Bt, S, H), 3.9, np.float32),
        np.asarray([-1.0, -16.0], np.float32),
        np.ones((Bt, S, 1, N), np.float32),
        np.ones((Bt, S, 1, N), np.float32),
    )


def make_qkv(seed, B, H, KVH, Sq, Skv, D):
    rs = np.random.RandomState(seed)
    return (
        rs.randn(B, H, Sq, D).astype(np.float32),
        rs.randn(B, KVH, Skv, D).astype(np.float32),
        rs.randn(B, KVH, Skv, D).astype(np.float32),
    )


def f32(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.float32).cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    B, H, KVH, Sq, Skv, D, causal, window, _, _ = FA_CASES[case]
    q, k, v = (
        torch.from_numpy(a).to(cuda, DTYPES[dtype]) for a in make_qkv(3, B, H, KVH, Sq, Skv, D)
    )
    before = kernels.LAUNCHES["flash_attention_fwd"]
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert kernels.LAUNCHES["flash_attention_fwd"] == before + 1
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,D", [(100, 100, 64), (37, 70, 64), (1, 1, 16), (130, 130, 256)])
def test_flash_attention_kernel_ragged_edges(cuda, dtype, Sq, Skv, D):
    q, k, v = (
        torch.from_numpy(a).to(cuda, DTYPES[dtype]) for a in make_qkv(4, 2, 4, 2, Sq, Skv, D)
    )
    for causal, window in [(False, None), (True, None), (True, 16)]:
        got = flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 64), (120, 96), (4, 1024, 1152), (4, 1, 1152)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda, DTYPES[dtype])
    w = torch.from_numpy((1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)).to(cuda)
    before = kernels.LAUNCHES["rmsnorm_fwd"]
    got = rmsnorm_fwd(x, w)
    assert kernels.LAUNCHES["rmsnorm_fwd"] == before + 1
    np.testing.assert_allclose(f32(got), f32(tref.rmsnorm_ref(x, w)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(2, 256, 64), (120, 96), (8, 1024, 2048), (4, 1024, 1152), (3, 5000), (1, 1)]
)
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, shape):
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda, DTYPES[dtype])
    dy = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda, DTYPES[dtype])
    w = torch.from_numpy((1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)).to(cuda)
    before = kernels.LAUNCHES["rmsnorm_bwd"]
    dx, dw = rmsnorm_bwd(x, w, dy)
    assert kernels.LAUNCHES["rmsnorm_bwd"] == before + 1
    assert dx.dtype == x.dtype and dx.shape == x.shape and dw.dtype == torch.float32
    want_dx, want_dw = tref.rmsnorm_bwd_ref(x, w, dy)
    tol = BWD_TOL if dtype == "float32" else TOL["bfloat16"]
    np.testing.assert_allclose(f32(dx), f32(want_dx), **tol)
    assert_dw_close(dw, want_dw, x, w, dy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_kernel_lse_matches_chunked_twin(cuda, case, dtype):
    """K4's logsumexp on every row with a visible column (all rows of these cases;
    a fully masked row would hold -1e30 here and log(columns) in the twin)."""
    B, H, KVH, Sq, Skv, D, causal, window, _, _ = FA_CASES[case]
    q, k, v = (
        torch.from_numpy(a).to(cuda, DTYPES[dtype]) for a in make_qkv(5, B, H, KVH, Sq, Skv, D)
    )
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    want_o, want_lse = tref.flash_attention_fwd_lse_chunked(q, k, v, causal=causal, window=window)
    assert lse.shape == (B, H, Sq, 1) and lse.dtype == torch.float32
    visible = tref.attention_mask(Sq, Skv, causal=causal, window=window, device=cuda).any(-1)
    assert bool(visible.all())
    np.testing.assert_allclose(f32(o), f32(want_o), **TOL[dtype])
    np.testing.assert_allclose(f32(lse[:, :, visible]), f32(want_lse[:, :, visible]),
                               **TOL["float32"])
    # without return_lse the output is the same
    np.testing.assert_array_equal(
        f32(flash_attention_fwd(q, k, v, causal=causal, window=window)), f32(o)
    )


@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_function_gradients(cuda, case):
    """K4 forward + the chunked backward against plain autograd (impl="ref"), f32."""
    B, H, KVH, Sq, Skv, D, causal, window, _, _ = FA_CASES[case]
    arrays = make_qkv(6, B, H, KVH, Sq, Skv, D)
    g = torch.from_numpy(np.random.RandomState(7).randn(B, H, Sq, D).astype(np.float32)).to(cuda)
    grads = {}
    for impl in (None, "chunked", "ref"):
        q, k, v = (torch.from_numpy(a).to(cuda).requires_grad_(True) for a in arrays)
        before = kernels.LAUNCHES["flash_attention_fwd"]
        o = ops.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
        launched = kernels.LAUNCHES["flash_attention_fwd"] - before
        assert launched == (1 if impl is None else 0)
        grads[impl] = torch.autograd.grad(o, (q, k, v), g)
    for impl in (None, "chunked"):
        for a, b in zip(grads[impl], grads["ref"]):
            np.testing.assert_allclose(f32(a), f32(b), **GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 64), (120, 96), (2, 64, 2048)])
def test_rmsnorm_function_gradients(cuda, dtype, shape):
    """K2 forward + K3 backward against plain autograd (impl="ref")."""
    rs = np.random.RandomState(2)
    xs = rs.randn(*shape).astype(np.float32)
    ws = (1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda, DTYPES[dtype])
    grads = {}
    for impl in (None, "ref"):
        x = torch.from_numpy(xs).to(cuda, DTYPES[dtype]).requires_grad_(True)
        w = torch.from_numpy(ws).to(cuda).requires_grad_(True)
        before = dict(kernels.LAUNCHES)
        y = ops.rmsnorm(x, w, impl=impl)
        grads[impl] = torch.autograd.grad(y, (x, w), g)
        n = 1 if impl is None else 0
        assert kernels.LAUNCHES["rmsnorm_fwd"] == before["rmsnorm_fwd"] + n
        assert kernels.LAUNCHES["rmsnorm_bwd"] == before["rmsnorm_bwd"] + n
    tol = BWD_TOL if dtype == "float32" else TOL["bfloat16"]
    np.testing.assert_allclose(f32(grads[None][0]), f32(grads["ref"][0]), **tol)
    # dw is an f32 sum over rows in both, from the same values
    x = torch.from_numpy(xs).to(cuda, DTYPES[dtype])
    w = torch.from_numpy(ws).to(cuda)
    assert_dw_close(grads[None][1], grads["ref"][1], x, w, g)


def test_bf16_logits_product_and_its_gradient(cuda):
    """The f32-output bf16 product of the logits and its backward, against f64 math
    on the same bf16 values.  The cotangent is a cross-entropy's (softmax minus
    one-hot), whose sums cancel; the gradients are rounded once to bf16 from f32
    sums, so each must lie within one bf16 ulp (2^-7 relative) plus 1e-5 of the
    largest entry of the f64 product of the f32 cotangent.  (Rounding the cotangent
    to bf16 first is off by ~5e-2 relative.)  The product: 1e-5 relative plus 1e-4."""
    rs = np.random.RandomState(8)
    N, V = 64, 1000
    a = torch.from_numpy(rs.randn(N, 256).astype(np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rs.randn(256, V).astype(np.float32) / 16).to(cuda, torch.bfloat16)
    a.requires_grad_(True)
    b.requires_grad_(True)
    y = tmodel._matmul_f32(a, b)
    assert y.dtype == torch.float32
    g = torch.softmax(y.detach(), -1)
    g[torch.arange(N, device=cuda), torch.from_numpy(rs.randint(0, V, N)).to(cuda)] -= 1.0
    g /= N
    da, db = torch.autograd.grad(y, (a, b), g)
    y = y.detach()
    assert da.dtype == db.dtype == torch.bfloat16
    ad, bd, gd = a.detach().double(), b.detach().double(), g.double()
    np.testing.assert_allclose(f32(y), f32(ad @ bd), rtol=1e-5, atol=1e-4)
    for got, ex in ((da, gd @ bd.T), (db, ad.T @ gd)):
        got, ex = f32(got), ex.cpu().numpy()
        assert (np.abs(got - ex) <= 2**-7 * np.abs(ex) + 1e-5 * np.abs(ex).max()).all()


def _ssd_on(cuda, arrays, dtype):
    """x, B, C in ``dtype``; dt and A in f32, as the model hands them to the kernel."""
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda) for a in arrays)
    return x.to(DTYPES[dtype]), dt, A, B.to(DTYPES[dtype]), C.to(DTYPES[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_CASES) + ["serve_mamba2_370m"])
def test_ssd_scan_kernel_matches_stepwise(cuda, case, dtype):
    shape = SSD_CASES.get(case, (4, 1024, 32, 64, 1, 128))
    x, dt, A, B, C = _ssd_on(cuda, make_ssd(9, *shape), dtype)
    before = kernels.LAUNCHES["ssd_scan_fwd"]
    y, hT = ssd_scan_fwd(x, dt, A, B, C)
    assert kernels.LAUNCHES["ssd_scan_fwd"] == before + 1
    Bt, S, H, P, G, N = shape
    assert y.dtype == x.dtype and y.shape == x.shape
    assert hT.dtype == torch.float32 and hT.shape == (Bt, H, N, P)
    want_y, want_h = tref.ssd_scan_ref(x, dt, A, B, C)
    np.testing.assert_allclose(f32(y), f32(want_y), **(SSD_TOL if dtype == "float32" else
                                                       TOL["bfloat16"]))
    np.testing.assert_allclose(f32(hT), f32(want_h), **SSD_TOL)


def test_ssd_scan_kernel_extreme_decay_is_finite(cuda):
    x, dt, A, B, C = _ssd_on(cuda, extreme_decay_ssd(), "float32")
    y, hT = ssd_scan_fwd(x, dt, A, B, C)
    want_y, want_h = tref.ssd_scan_ref(x, dt, A, B, C)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hT).all())
    np.testing.assert_allclose(f32(y), f32(want_y), **SSD_TOL)
    np.testing.assert_allclose(f32(hT), f32(want_h), **SSD_TOL)


@pytest.mark.parametrize("case", ["single_chunk", "ragged_200", "extreme_decay"])
def test_ssd_scan_function_gradients(cuda, case):
    """K5 forward + the plain chunked backward against plain autograd through the
    stepwise recurrence (impl="ref"), f32, at 2e-4 as test_ssd_scan.py's TestGrad."""
    arrays = extreme_decay_ssd() if case == "extreme_decay" else make_ssd(10, *SSD_CASES[case])
    g = torch.from_numpy(np.random.RandomState(11).randn(*arrays[0].shape).astype(np.float32))
    grads = {}
    for impl in (None, "chunked", "ref"):
        ins = [torch.from_numpy(a).to(cuda).requires_grad_(True) for a in arrays]
        before = kernels.LAUNCHES["ssd_scan_fwd"]
        y = ops.ssd_scan(*ins, impl=impl)
        assert kernels.LAUNCHES["ssd_scan_fwd"] - before == (1 if impl is None else 0)
        grads[impl] = torch.autograd.grad(y, ins, g.to(cuda))
    for impl in (None, "chunked"):
        for a, b in zip(grads[impl], grads["ref"]):
            assert bool(torch.isfinite(a).all())
            np.testing.assert_allclose(f32(a), f32(b), **SSD_TOL)


# ---------------------------------------------------------------------------
# K1: the Triton kernels generated per fusion cluster, against their oracles
# ---------------------------------------------------------------------------

def _k1_oracle(fn, *args):
    kernels.set_kernel_mode("ref")
    try:
        return fn(*args)
    finally:
        kernels.set_kernel_mode(None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(k1_cases.ELEMENTWISE_CASES))
def test_k1_map_kernel_matches_its_oracle(cuda, name, dtype):
    """Each elementwise primitive in a generated map cluster, at ragged body shapes,
    with the second operand at the body shape, broadcast from rank 1 and rank 0."""
    prog = k1_cases.ELEMENTWISE_CASES[name]
    for shape in k1_cases.ELEMENTWISE_SHAPES:
        for y_rank in (len(shape), 1, 0):
            x, y = k1_cases.case_inputs(name, shape, y_rank, DTYPES[dtype], cuda)
            fn = k1_cases.compile_case(prog, x, y)
            n = len(fn.__fused_kernels__)
            assert n >= 1 and all(k.kind == "map" for k in fn.__fused_kernels__)
            before = kernels.LAUNCHES["fused_map"]
            got = fn(x, y)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["fused_map"] == before + n
            want = _k1_oracle(fn, x, y)
            assert got.dtype == want.dtype and got.shape == want.shape
            if got.dtype.is_floating_point:
                ulps = k1_cases.ulps(got, want)
                assert ulps <= k1_cases.MAP_ULPS.get(name, 1), (name, shape, y_rank, ulps)
            else:
                assert torch.equal(got, want), (name, shape, y_rank)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(k1_cases.REDUCE_CASES))
def test_k1_reduce_kernel_matches_its_oracle(cuda, name, dtype):
    """Each reduction root over leading, trailing, middle, two and all axes, with a
    broadcast operand of rank 3, 1 and 0; the larger shape splits its reductions."""
    prog = k1_cases.REDUCE_CASES[name]
    for shape in k1_cases.REDUCE_SHAPES:
        for y_rank in (3, 1, 0):
            x, y = k1_cases.case_inputs(name, shape, y_rank, DTYPES[dtype], cuda)
            fn = k1_cases.compile_case(prog, x, y)
            kinds = sorted(k.kind for k in fn.__fused_kernels__)
            assert kinds == ["reduce"], (name, kinds)
            before = kernels.LAUNCHES["fused_reduce"]
            got = fn(x, y)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["fused_reduce"] == before + sum(
                k.launches_per_call for k in fn.__fused_kernels__)
            want = _k1_oracle(fn, x, y)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_allclose(f32(got), f32(want), **k1_cases.REDUCE_TOL[dtype])


def test_k1_lm_step_clusters_on_the_card(cuda):
    """The Myia LM step at tiny dims: exactly its 4 clusters (3 map, 1 reduce) run as
    Triton kernels, in 5 launches (the reduce combines its partials in a second
    pass), and the loss and gradients agree with the oracles' run."""
    from repro_torch.launch.myia_step import MyiaLMDims, make_myia_train_step

    dims = MyiaLMDims(96, 16, 40)
    step_fn, init_fn = make_myia_train_step(dims, 2, 8, 0.1, device=cuda)
    params = init_fn()["params"]
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(0, 96, (2, 8)).astype(np.int32)).to(cuda)
    lab = torch.from_numpy(rs.randint(0, 96, (2, 8)).astype(np.int32)).to(cuda)
    kernels.reset_launches()
    loss, grads = step_fn.vag(*params, tok, lab)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_map"] == 3 and kernels.LAUNCHES["fused_reduce"] == 2
    assert len(kernels.FUSED_LAUNCHES) == 4
    loss_o, grads_o = _k1_oracle(step_fn.vag, *params, tok, lab)
    np.testing.assert_allclose(f32(loss), f32(loss_o), rtol=1e-5, atol=1e-6)
    for a, b in zip(grads, grads_o):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-7)
