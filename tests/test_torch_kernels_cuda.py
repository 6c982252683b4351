"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips.  The shapes are the cases of
``tests/kernels/test_flash_attention.py`` (shared with ``test_torch_kernels.py``),
ragged edges the TPU kernel's tiling could not take, and the rmsnorm shapes of
the gemma3-1b serving path and the internlm2-1.8b training path (K2 also at a width
that is no multiple of its 16-byte vector, a single row, a row wider than its
warp-per-row kernel holds, and rows off a 16-byte boundary).  K4's bf16 kernel (the
tensor cores) is also held at the main paths' geometries and ragged edges
(``TC_CASES``: causal, windowed, and the non-causal Sq ≠ Skv calls of whisper-medium
at head_dim 64 and of llama-3.2-vision-11b) against the twin of its rounding points,
``ref.flash_attention_fwd_tc_twin``, which rounds P to bf16 before P·V as the kernel
does, and its gradients through the chunked backward against plain autograd in bf16
at the bf16 tolerance; its f32 cases run the SIMT kernel.  For the SSD scan
(K5) the cases of ``tests/kernels/test_ssd_scan.py``, a ragged sequence, the
mamba2-reduced shape and the serving shapes of mamba2-370m (32 heads) and the Jamba
block (128 heads).  Tolerances: 2e-5 in f32
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

import importlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import build, k1_cases, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.models import model as tmodel

# the module (repro_torch.kernels exports the op ssd_scan under the same name)
tssd = importlib.import_module("repro_torch.kernels.ssd_scan")

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
# K5's bf16 passes zero-pad N and P to the 16 of an MMA tile and the sequence to the
# chunk of 128: N and P off 16 (and off 8, where rows take 8-byte copies) at a ragged S
SSD_RAGGED_TC_CASES = {
    "n20_p12_s77": (2, 77, 4, 12, 2, 20),
    "n36_p24_s300": (1, 300, 6, 24, 3, 36),
    "n4_p4_s129": (2, 129, 2, 4, 1, 4),
}
# the serving paths' SSD shapes: mamba2-370m (32 heads) and the Jamba block (128 heads)
SSD_SERVE_CASES = {
    "serve_mamba2_370m": (4, 1024, 32, 64, 1, 128),
    "serve_jamba_block": (4, 1024, 128, 64, 1, 128),
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
@pytest.mark.parametrize(
    "shape",
    [(2, 256, 64), (120, 96), (4, 1024, 1152), (4, 1, 1152), (8, 1024, 2048), (64, 100),
     (1, 2048), (3, 5000), (1500, 1024), (4, 1, 1024), (2, 1024, 4096), (4, 1, 4096),
     (2, 1024, 8192), (4, 1, 8192)],
)
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    """K2 at the serving (1152) and training (2048) widths, a width that is no multiple
    of the 16-byte vector (100), a single row, a row wider than the warp-per-row
    kernel holds (5000), and the widths of whisper-medium (1024), of
    llama-3.2-vision-11b and the Jamba block (4096, the widest warp-per-row row) and of
    the Jamba gate norm (8192), prefill and decode rows."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda, DTYPES[dtype])
    w = torch.from_numpy((1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)).to(cuda)
    before = kernels.LAUNCHES["rmsnorm_fwd"]
    got = rmsnorm_fwd(x, w)
    assert kernels.LAUNCHES["rmsnorm_fwd"] == before + 1
    np.testing.assert_allclose(f32(got), f32(tref.rmsnorm_ref(x, w)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_takes_unaligned_rows(cuda, dtype):
    """x and y that start off a 16-byte boundary take the scalar loads and stores."""
    rs = np.random.RandomState(3)
    flat = torch.from_numpy(rs.randn(16 * 1152 + 1).astype(np.float32)).to(cuda, DTYPES[dtype])
    x = flat[1:].view(16, 1152)
    assert x.data_ptr() % 16 != 0
    w = torch.from_numpy((1.0 + 0.1 * rs.randn(1152)).astype(np.float32)).to(cuda)
    np.testing.assert_allclose(f32(rmsnorm_fwd(x, w)), f32(tref.rmsnorm_ref(x, w)), **TOL[dtype])


# K4's bf16 path (the tensor-core kernel) at the main paths' geometries and ragged
# edges, name: (B, H, KVH, Sq, Skv, D, causal, window): gemma3-1b's local layers,
# internlm2-1.8b's 16 query heads on 8 kv heads, Sq, Skv off the 128-row query tile
# and the 64-key KV tile at head_dim 128 and 256 (every row sees a column), and the
# calls of whisper-medium (head_dim 64: the encoder's non-causal self-attention at
# 1500 frames, the decoder's causal self-attention over a 416-token prompt and its
# cross-attention, Skv 1500 = 23·64 + 28) and of llama-3.2-vision-11b (32 query heads
# on 8 kv heads: causal self-attention, and cross-attention over 1600 image tokens).
TC_CASES = {
    "whisper_encoder_hd64": (1, 16, 16, 1500, 1500, 64, False, None),
    "whisper_decoder_causal_hd64": (1, 16, 16, 416, 416, 64, True, None),
    "whisper_cross_hd64": (1, 16, 16, 416, 1500, 64, False, None),
    "vision_self_causal_gqa32_8": (1, 32, 8, 1024, 1024, 128, True, None),
    "vision_cross_gqa32_8": (1, 32, 8, 1024, 1600, 128, False, None),
    "gemma3_hd256_window512": (1, 4, 1, 1024, 1024, 256, True, 512),
    "internlm2_hd128_gqa16_8": (1, 16, 8, 1024, 1024, 128, True, None),
    "ragged_hd128": (2, 4, 2, 200, 333, 128, False, None),
    "ragged_hd128_causal_window": (2, 4, 2, 200, 333, 128, True, 48),
    "ragged_hd256_causal": (1, 4, 1, 77, 130, 256, True, None),
}


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_flash_attention_tensor_core_kernel(cuda, case):
    """The output against the plain version and against the twin of the kernel's
    rounding points (ref.flash_attention_fwd_tc_twin), at the bf16 tolerance; lse
    against the chunked twin's and the tensor-core twin's, at the f32 one."""
    B, H, KVH, Sq, Skv, D, causal, window = TC_CASES[case]
    q, k, v = (
        torch.from_numpy(a).to(cuda, torch.bfloat16)
        for a in make_qkv(12, B, H, KVH, Sq, Skv, D)
    )
    before = kernels.LAUNCHES["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    assert kernels.LAUNCHES["flash_attention_fwd"] == before + 1
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    twin_o, twin_lse = tref.flash_attention_fwd_tc_twin(q, k, v, causal=causal, window=window)
    _, chunked_lse = tref.flash_attention_fwd_lse_chunked(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(f32(o), f32(want), **TOL["bfloat16"])
    np.testing.assert_allclose(f32(o), f32(twin_o), **TOL["bfloat16"])
    np.testing.assert_allclose(f32(lse), f32(chunked_lse), **TOL["float32"])
    np.testing.assert_allclose(f32(lse), f32(twin_lse), **TOL["float32"])


@pytest.mark.parametrize("D,window", [(64, None), (128, 48)])
def test_flash_attention_function_gradients_bf16(cuda, D, window):
    """K4 forward (the tensor-core kernel) + the chunked backward against plain
    autograd (impl="ref") in bf16, at the bf16 tolerance."""
    arrays = make_qkv(13, 1, 4, 2, 128, 128, D)
    g = torch.from_numpy(np.random.RandomState(14).randn(1, 4, 128, D).astype(np.float32))
    grads = {}
    for impl in (None, "ref"):
        q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16).requires_grad_(True)
                   for a in arrays)
        o = ops.flash_attention(q, k, v, causal=True, window=window, impl=impl)
        grads[impl] = torch.autograd.grad(o, (q, k, v), g.to(cuda, torch.bfloat16))
    for a, b in zip(grads[None], grads["ref"]):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(f32(a), f32(b), **TOL["bfloat16"])


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
@pytest.mark.parametrize("case", sorted(SSD_CASES) + sorted(SSD_SERVE_CASES))
def test_ssd_scan_kernel_matches_stepwise(cuda, case, dtype):
    shape = {**SSD_CASES, **SSD_SERVE_CASES}[case]
    x, dt, A, B, C = _ssd_on(cuda, make_ssd(9, *shape), dtype)
    before = kernels.LAUNCHES["ssd_scan_fwd"]
    y, hT = ssd_scan_fwd(x, dt, A, B, C)
    assert kernels.LAUNCHES["ssd_scan_fwd"] == before + tssd.LAUNCHES_PER_CALL
    Bt, S, H, P, G, N = shape
    assert y.dtype == x.dtype and y.shape == x.shape
    assert hT.dtype == torch.float32 and hT.shape == (Bt, H, N, P)
    want_y, want_h = tref.ssd_scan_ref(x, dt, A, B, C)
    np.testing.assert_allclose(f32(y), f32(want_y), **(SSD_TOL if dtype == "float32" else
                                                       TOL["bfloat16"]))
    np.testing.assert_allclose(f32(hT), f32(want_h), **SSD_TOL)


@pytest.mark.parametrize("case", sorted(SSD_CASES) + sorted(SSD_SERVE_CASES))
def test_ssd_scan_tensor_core_kernel_matches_its_twin(cuda, case):
    """The bf16 passes against ref.ssd_scan_fwd_tc_twin (their rounding points in
    plain PyTorch): y at the bf16 2e-2, the state at 2e-4."""
    shape = {**SSD_CASES, **SSD_SERVE_CASES}[case]
    x, dt, A, B, C = _ssd_on(cuda, make_ssd(12, *shape), "bfloat16")
    y, hT = ssd_scan_fwd(x, dt, A, B, C)
    want_y, want_h = tref.ssd_scan_fwd_tc_twin(x, dt, A, B, C)
    np.testing.assert_allclose(f32(y), f32(want_y), **TOL["bfloat16"])
    np.testing.assert_allclose(f32(hT), f32(want_h), **SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_RAGGED_TC_CASES))
def test_ssd_scan_kernel_takes_ragged_state_and_head_dims(cuda, case, dtype):
    """N and P off the MMA tile at a ragged S, against the stepwise recurrence and,
    in bf16, the twin."""
    x, dt, A, B, C = _ssd_on(cuda, make_ssd(13, *SSD_RAGGED_TC_CASES[case]), dtype)
    y, hT = ssd_scan_fwd(x, dt, A, B, C)
    wants = [tref.ssd_scan_ref(x, dt, A, B, C)]
    if dtype == "bfloat16":
        wants.append(tref.ssd_scan_fwd_tc_twin(x, dt, A, B, C))
    for want_y, want_h in wants:
        np.testing.assert_allclose(f32(y), f32(want_y), **(SSD_TOL if dtype == "float32" else
                                                           TOL["bfloat16"]))
        np.testing.assert_allclose(f32(hT), f32(want_h), **SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plan_matches_the_kernels(cuda, dtype):
    """plan()'s chunk and shared memory are the C side's at every test shape."""
    lib, code = build.load(), build.DTYPE_CODES[dtype]
    for Bt, S, H, P, G, N in [*SSD_CASES.values(), *SSD_RAGGED_TC_CASES.values(),
                              (4, 1024, 32, 64, 1, 128)]:
        p = tssd.plan(Bt, S, H, G, N, P, DTYPES[dtype])
        assert p.chunk == lib.ssd_scan_fwd_chunk(code)
        assert [ps.smem for ps in p.passes] == [lib.ssd_scan_fwd_smem(N, P, code, i)
                                                for i in range(3)]


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
        assert kernels.LAUNCHES["ssd_scan_fwd"] - before == (
            tssd.LAUNCHES_PER_CALL if impl is None else 0)
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


# ---------------------------------------------------------------------------
# The Myia serving runtime and the program cache on the card
# ---------------------------------------------------------------------------


def test_serve_engine_on_the_card_matches_the_cpu(cuda):
    """The engine at tiny dims, fused: the card's streams equal the CPU's (the
    oracles) and the card's own full-prefix oracle's."""
    from repro_torch.serve import ServeEngine, ServeLMDims, init_serve_params, oracle_generate

    dims = ServeLMDims(48, 8, 16)
    p_cpu = init_serve_params(dims, torch.Generator().manual_seed(0), device="cpu")
    p_card = tuple(p.to(cuda) for p in p_cpu)
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, 48, n).tolist(), m) for n, m in [(5, 6), (9, 4), (3, 8), (20, 6)]]
    streams = []
    for params in (p_cpu, p_card):
        eng = ServeEngine(dims, params, n_slots=2, min_bucket=16, fuse=True)
        rids = [eng.submit(p, m) for p, m in work]
        res = eng.run()
        streams.append([res[r]["tokens"] for r in rids])
    assert streams[1] == streams[0] == [oracle_generate(dims, p_card, p, m) for p, m in work]


_K1_CACHE_SCRIPT = """
import json, sys
import torch
from repro_torch.core import api
from repro_torch.core.torch_backend import ProgramCache
from repro_torch.launch.myia_step import MyiaLMDims, build_lm_loss

cache = ProgramCache(sys.argv[1])
vag = api.value_and_grad(build_lm_loss(MyiaLMDims(96, 16, 40), 2, 8), wrt=(0, 1, 2, 3),
                         options=api.CompileOptions(fuse=True, program_cache=cache))
gen = torch.Generator().manual_seed(0)
args = [(torch.randn(s, generator=gen) * 0.1).cuda()
        for s in ((96, 16), (16, 40), (40, 16), (16, 96))]
args += [torch.randint(0, 96, (2, 8), generator=gen, dtype=torch.int32).cuda() for _ in "ab"]
loss, _grads = vag(*args)
print(json.dumps({"loss": float(loss), "stats": cache.stats.as_dict()}))
"""


def test_program_cache_finds_k1_binaries_again(cuda, tmp_path):
    """A fused program through the program cache: the cold process builds one
    lowering and its clusters' Triton binaries (in ``<cache>/triton``); a warm
    process finds both and builds nothing, with the same loss."""
    import json
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _K1_CACHE_SCRIPT, str(tmp_path)],
                             capture_output=True, text=True, env=env, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["stats"]["misses"] == 1 and cold["stats"]["programs_built"] > 1, cold
    assert warm["stats"]["hits"] == 1 and warm["stats"]["programs_built"] == 0, warm
    assert warm["loss"] == cold["loss"]
    assert any(f.endswith(".cubin") for _d, _s, fs in os.walk(tmp_path / "triton") for f in fs)


def _collective_checks(mesh, x_of, world, dev):
    """The four collectives of the SPMD tier inside a per-shard program on
    ``mesh``, against their definitions: every rank's block ``x_of(r)``."""
    from repro_torch.core import primitives as P
    from repro_torch.parallel import axis_index, shard_program

    blocks = [x_of(r).to(dev) for r in range(world)]
    me = blocks[axis_index(mesh, ("data",))]
    with shard_program(mesh):
        outs = {"psum": P.psum_axes.impl(me, ("data",)), "pmax": P.pmax_axes.impl(me, ("data",))}
        for dim in (0, 1):
            outs[f"gather{dim}"] = P.all_gather_axes.impl(me, ("data",), dim, (world,))
        outs["slice"] = P.shard_slice.impl(torch.cat(blocks, dim=1), ("data",), 1, (world,))
    want_max = blocks[0]
    for b in blocks[1:]:
        want_max = torch.maximum(want_max, b)
    want = {"psum": sum(blocks[1:], blocks[0]), "pmax": want_max, "slice": me,
            **{f"gather{dim}": torch.cat(blocks, dim=dim) for dim in (0, 1)}}
    for k, v in outs.items():
        assert v.device == me.device and torch.equal(v, want[k]), k


def test_collectives_on_an_nccl_world_of_one(cuda, tmp_path):
    """psum/pmax/all_gather/shard_slice over a real NCCL group of one rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    assert not dist.is_initialized()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(1, 1)
        assert dist.get_backend() == "nccl"
        _collective_checks(mesh, lambda r: torch.arange(12.0).reshape(3, 4) * (r + 1), 1, cuda)
    finally:
        dist.destroy_process_group()


_GLOO_RANK = """
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[3])
from repro_torch.launch.mesh import make_local_mesh
from test_torch_kernels_cuda import _collective_checks

rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + sys.argv[2], rank=rank, world_size=2)
mesh = make_local_mesh(2, 1)
_collective_checks(mesh, lambda r: torch.arange(12.0).reshape(3, 4) * (r + 1) - 5 * r, 2,
                   torch.device("cuda"))
dist.destroy_process_group()
print("OK", rank)
"""


def test_collectives_on_two_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """The same on two ranks over gloo, both on the one card (the transport of a
    mesh that shares a card: NCCL refuses two ranks on one device)."""
    import os
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(tests, "..", "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    script = tmp_path / "rank.py"
    script.write_text(_GLOO_RANK)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"),
                               tests], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0 and f"OK {r}" in out, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
