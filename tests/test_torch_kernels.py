"""The port's kernel ops (``repro_torch.kernels``) against the reference package's
Pallas kernels, run in interpret mode as ``tests/kernels`` runs them, and against
its oracles.  The same numpy inputs, made from a seed, go to both packages.

On the CPU the port's ops run their plain PyTorch versions; the CUDA kernels
themselves are held against those plain versions on the card by
``tests/test_torch_kernels_cuda.py``, which imports no JAX and skips without a card.

Tolerances are those of ``tests/kernels``: 2e-5 in f32 (the same f32 math summed
in another order) and 2e-2 in bf16 (outputs rounded to bf16, 8 bits of mantissa,
after f32 math).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_attention_fwd
from repro import kernels as jkernels
from repro.kernels.rmsnorm import rmsnorm_bwd as jax_rmsnorm_bwd
from repro.kernels.rmsnorm import rmsnorm_fwd as jax_rmsnorm_fwd
from repro.kernels.ssd_scan import ssd_scan_fwd as jax_ssd_scan_fwd
from repro_torch import kernels
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import check_args as fa_check_args
from repro_torch.kernels.flash_attention import check_bwd_args as fa_check_bwd_args
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.rmsnorm import check_args as rms_check_args
from repro_torch.kernels.rmsnorm import check_bwd_args as rms_check_bwd_args
from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
from repro_torch.kernels.ssd_scan import check_args as ssd_check_args
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from test_torch_kernels_cuda import (
    FA_CASES, SSD_CASES, SSD_RAGGED_TC_CASES, extreme_decay_ssd, make_qkv, make_ssd,
)

# the modules (repro_torch.kernels exports the ops ssd_scan and rmsnorm under the same
# names)
tssd = importlib.import_module("repro_torch.kernels.ssd_scan")
tkrms = importlib.import_module("repro_torch.kernels.rmsnorm")

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype`` (both round to
    nearest even when narrowing to bf16, so they hold the same values)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(2, 256, 64), (120, 96), (4, 1, 1152), (4, 1, 8192), (2, 16, 6144), (3, 5000)],
)
def test_rmsnorm_matches_reference(dtype, shape):
    """The plain version that the CPU runs, at the warp-per-row widths and at the wide
    routes' (the Jamba gate norm's decode rows, a dry-run arch's width, a ragged one),
    against the reference's Pallas kernel in interpret mode and its plain reference."""
    rs = np.random.RandomState(0)
    x_np = rs.randn(*shape).astype(np.float32)
    w_np = (1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    xj, xt = both(x_np, dtype)
    wj, wt = jnp.asarray(w_np), torch.from_numpy(w_np)
    got = kernels.rmsnorm(xt, wt, eps=1e-6)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    want_kernel = jax_rmsnorm_fwd(xj, wj, eps=1e-6, interpret=True)
    want_ref = jref.rmsnorm_ref(xj, wj, 1e-6)
    np.testing.assert_allclose(f32(got), f32(want_kernel), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(want_ref), **TOL[dtype])


# ---------------------------------------------------------------------------
# flash attention: the cases of tests/kernels/test_flash_attention.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_matches_pallas_interpret(case, dtype):
    B, H, KVH, Sq, Skv, D, causal, window, bq, bk = FA_CASES[case]
    q, k, v = make_qkv(sorted(FA_CASES).index(case), B, H, KVH, Sq, Skv, D)
    (qj, qt), (kj, kt), (vj, vt) = both(q, dtype), both(k, dtype), both(v, dtype)
    got = kernels.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = jax_flash_attention_fwd(
        qj, kj, vj, causal=causal, window=window, block_q=bq, block_k=bk, interpret=True
    )
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


# K4's bf16 path runs on the tensor cores and rounds P to bf16 before P·V, where the
# reference keeps P in f32.  Its plain twin (ref.flash_attention_fwd_tc_twin) shows on
# the CPU that this rounding keeps the reference's bf16 tolerance, on every FA_CASES
# entry and at gemma3-1b's geometry (head_dim 256, 4 query heads on 1 kv head, a
# window), and that lse, whose l sums the unrounded P, keeps the f32 one.
TC_TWIN_CASES = {**FA_CASES, "gemma3_geometry": (1, 4, 1, 128, 128, 256, True, 32, 64, 64)}


@pytest.mark.parametrize("case", sorted(TC_TWIN_CASES))
def test_tensor_core_twin_keeps_the_reference_tolerance(case):
    B, H, KVH, Sq, Skv, D, causal, window, bq, bk = TC_TWIN_CASES[case]
    q, k, v = make_qkv(20 + sorted(TC_TWIN_CASES).index(case), B, H, KVH, Sq, Skv, D)
    (qj, qt), (kj, kt), (vj, vt) = both(q, "bfloat16"), both(k, "bfloat16"), both(v, "bfloat16")
    o, lse = tref.flash_attention_fwd_tc_twin(qt, kt, vt, causal=causal, window=window)
    assert o.dtype == torch.bfloat16 and lse.shape == (B, H, Sq, 1)
    want_kernel = jax_flash_attention_fwd(
        qj, kj, vj, causal=causal, window=window, block_q=bq, block_k=bk, interpret=True
    )
    want_ref = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(f32(o), f32(want_kernel), **TOL["bfloat16"])
    np.testing.assert_allclose(f32(o), f32(want_ref), **TOL["bfloat16"])
    _, want_lse = jref.flash_attention_fwd_lse_chunked(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(f32(lse), f32(want_lse), **TOL["float32"])


@pytest.mark.parametrize(
    "causal,window,q_offset", [(False, None, 0), (True, None, 0), (True, 3, 0), (True, 4, 5)]
)
def test_attention_mask_matches_reference(causal, window, q_offset):
    got = tref.attention_mask(6, 11, causal=causal, window=window, q_offset=q_offset)
    want = jref.attention_mask(6, 11, causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flash_attention_ref_decode_offset_matches_reference():
    """q_offset places a one-row query at the end of a longer sequence (decode)."""
    q, k, v = make_qkv(9, 1, 4, 2, 1, 24, 32)
    got = tref.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=8, q_offset=23,
    )
    want = jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=8, q_offset=23
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


# ---------------------------------------------------------------------------
# dispatch, argument checks and the build, on the CPU
# ---------------------------------------------------------------------------


def test_cpu_dispatch_runs_plain_versions_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 1, 2, 1, 16, 16, 32))
    ssd_in = [torch.from_numpy(a) for a in make_ssd(0, 1, 8, 2, 4, 1, 4)]
    kernels.reset_launches()
    o = kernels.flash_attention(q, k, v, causal=True)
    y = kernels.rmsnorm(q, torch.ones(32))
    s = kernels.ssd_scan(*ssd_in)
    assert kernels.LAUNCHES == {
        "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
        "ssd_scan_fwd": 0, "fused_map": 0, "fused_reduce": 0,
    }
    torch.testing.assert_close(s, tref.ssd_scan_ref(*ssd_in)[0], rtol=0, atol=0)
    torch.testing.assert_close(o, tref.flash_attention_ref(q, k, v, causal=True), rtol=0, atol=0)
    torch.testing.assert_close(y, tref.rmsnorm_ref(q, torch.ones(32)), rtol=0, atol=0)
    # impl="ref" is the plain version on any device
    torch.testing.assert_close(kernels.flash_attention(q, k, v, causal=True, impl="ref"), o)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 16, 32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA kernel"):
        rmsnorm_fwd(q, torch.ones(32))
    with pytest.raises(ValueError, match="CUDA kernel"):
        rmsnorm_bwd(q, torch.ones(32), q)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention_fwd(q, q, q, return_lse=True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ssd_scan_fwd(*(torch.from_numpy(a) for a in make_ssd(0, 1, 8, 2, 4, 1, 4)))
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.ssd_scan(*(torch.from_numpy(a) for a in make_ssd(0, 1, 8, 2, 4, 1, 4)), impl="pallas")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.rmsnorm(q, torch.ones(32), impl="pallas")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.flash_attention(q, q, q, impl="cuda")


def _qkv(Sq=16, D=32, H=2, KVH=1, dtype=torch.float32):
    return (
        torch.zeros(1, H, Sq, D, dtype=dtype),
        torch.zeros(1, KVH, 16, D, dtype=dtype),
        torch.zeros(1, KVH, 16, D, dtype=dtype),
    )


@pytest.mark.parametrize(
    "args,error",
    [
        (lambda: (*_qkv(), None), None),
        (lambda: (*_qkv(D=48), None), "no kernel instantiation"),
        (lambda: (*_qkv(H=3, KVH=2), None), "multiple of kv heads"),
        (lambda: (*_qkv(dtype=torch.float16), None), "float32 or all bfloat16"),
        (lambda: (torch.zeros(1, 2, 32, 16).transpose(2, 3), *_qkv()[1:], None), "contiguous"),
        (lambda: (_qkv()[0], _qkv()[1], _qkv(dtype=torch.bfloat16)[2], None), "float32 or all"),
        (lambda: (*_qkv(), 0), "window must be a positive"),
        (lambda: (_qkv()[0], _qkv()[1][:, :, :0], _qkv()[2][:, :, :0], None), "at least one key"),
    ],
)
def test_flash_attention_argument_checks(args, error):
    q, k, v, window = args()
    if error is None:
        fa_check_args(q, k, v, window)
    else:
        with pytest.raises((ValueError, TypeError), match=error):
            fa_check_args(q, k, v, window)


def _bwd_args(D=64, dtype=torch.bfloat16, **replace):
    """(q, k, v, o, lse, do) of a backward call the kernel takes, with any replaced."""
    q, k, v = _qkv(D=D, dtype=dtype)
    args = dict(q=q, k=k, v=v, o=torch.zeros_like(q), lse=torch.zeros(*q.shape[:3], 1),
                do=torch.zeros_like(q))
    args.update(replace)
    return tuple(args.values())


@pytest.mark.parametrize(
    "args,error",
    [
        (lambda: _bwd_args(), None),
        (lambda: _bwd_args(D=128), None),
        (lambda: _bwd_args(dtype=torch.float32), "takes bfloat16"),
        (lambda: _bwd_args(D=32), "no backward instantiation"),
        (lambda: _bwd_args(D=256), "no backward instantiation"),
        (lambda: _bwd_args(k=torch.zeros(1, 1, 16, 64)), "float32 or all bfloat16"),
        (lambda: _bwd_args(do=torch.zeros(1, 2, 16, 64)), "do must be"),
        (lambda: _bwd_args(o=torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)), "o must be"),
        (lambda: _bwd_args(lse=torch.zeros(1, 2, 16)), "lse must be"),
        (lambda: _bwd_args(lse=torch.zeros(1, 2, 16, 1, dtype=torch.bfloat16)), "lse must be"),
        (lambda: _bwd_args(do=torch.zeros(1, 2, 64, 16, dtype=torch.bfloat16).transpose(2, 3)),
         "contiguous"),
        (lambda: _bwd_args(q=torch.zeros(1, 2, 64, 16, dtype=torch.bfloat16).transpose(2, 3)),
         "contiguous"),
    ],
)
def test_flash_attention_bwd_argument_checks(args, error):
    """What the backward wrapper takes, checked before any launch."""
    if error is None:
        fa_check_bwd_args(*args(), None)
    else:
        with pytest.raises((ValueError, TypeError), match=error):
            fa_check_bwd_args(*args(), None)


def test_flash_attention_bwd_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention_bwd(*_bwd_args(), causal=True)


@pytest.mark.parametrize(
    "dtype,D,kernel,route",
    [
        (torch.bfloat16, 64, True, "kernel"),
        (torch.bfloat16, 128, True, "kernel"),
        (torch.float32, 64, True, "chunked"),
        (torch.float32, 128, True, "chunked"),
        (torch.bfloat16, 16, True, "chunked"),
        (torch.bfloat16, 32, True, "chunked"),
        (torch.bfloat16, 256, True, "chunked"),
        (torch.bfloat16, 64, False, "chunked"),  # impl="chunked": the plain chunked forward
        (torch.bfloat16, 128, False, "chunked"),
    ],
)
def test_attention_backward_route(dtype, D, kernel, route):
    """The backward's route from what the Function sees: the kernel for a K4 forward in
    bf16 at head_dim 64 or 128, the plain chunked backward for everything else."""
    assert ops.attn_bwd_route(torch.zeros(1, 2, 8, D, dtype=dtype), kernel) == route


def test_chunked_attention_backward_is_counted_on_its_route():
    """``impl="chunked"`` runs the Function with the plain chunked forward and backward on
    any device: one backward, counted on the chunked route, with no kernel launch."""
    q, k, v = (t.normal_().requires_grad_(True) for t in _qkv(D=64, dtype=torch.bfloat16))
    build.reset_launches()
    o = ops.flash_attention(q, k, v, causal=True, impl="chunked")
    o.sum().backward()
    assert build.ATTN_BWD_ROUTES == {"kernel": 0, "chunked": 1}
    assert build.LAUNCHES["flash_attention_bwd"] == 0
    build.reset_launches()
    assert build.ATTN_BWD_ROUTES == {"kernel": 0, "chunked": 0}


@pytest.mark.parametrize(
    "x,w,error",
    [
        (torch.zeros(4, 8), torch.ones(8), None),
        (torch.zeros(4, 8, dtype=torch.bfloat16), torch.ones(8), None),
        (torch.zeros(4, 8), torch.ones(8, dtype=torch.bfloat16), "float32 weight"),
        (torch.zeros(4, 8), torch.ones(7), "does not match"),
        (torch.zeros(8, 4).T, torch.ones(8), "contiguous"),
        (torch.zeros(4, 8, dtype=torch.float64), torch.ones(8), "float32 or bfloat16"),
    ],
)
def test_rmsnorm_argument_checks(x, w, error):
    if error is None:
        rms_check_args(x, w)
    else:
        with pytest.raises((ValueError, TypeError), match=error):
            rms_check_args(x, w)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_rmsnorm_route_wrappers_refuse_cpu_tensors_and_unknown_routes():
    """K2's forced-route wrapper launches a CUDA kernel or raises, as ``rmsnorm_fwd``
    does; a route it does not know is refused before any launch."""
    q = torch.zeros(4, 1024)
    assert tkrms.ROUTES == ("warp-per-row", "row-per-block", "row-per-block-streamed")
    for r in tkrms.ROUTES:
        with pytest.raises(ValueError, match="CUDA kernel"):
            tkrms.rmsnorm_fwd_on(q, torch.ones(1024), r)
    with pytest.raises(ValueError):
        tkrms.rmsnorm_fwd_on(q, torch.ones(1024), "block-per-row")


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path()
    src.write_text("// two\n")
    assert build.library_path() != first
    assert build.library_path().parent == build.BUILD_DIR


def test_sources_are_the_kernels_of_this_slice():
    names = {p.name for p in build.sources()}
    assert {"rmsnorm.cu", "flash_attention.cu", "ssd_scan.cu", "common.cuh", "hopper.cuh"} <= names


# ---------------------------------------------------------------------------
# the training path: K3's plain version, the chunked attention, and gradients
# ---------------------------------------------------------------------------

# The rmsnorm backward's tolerance of tests/kernels/test_rmsnorm.py: 1e-4/1e-5 (dw
# sums the rows in another order).  bf16 dx is rounded to bf16 from f32 results
# that may straddle a rounding boundary, so it takes the bf16 tolerance.
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
# attention gradients, as tests/kernels/test_flash_attention.py holds them
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)

# the cases of the kernel tests, plus a ragged causal, windowed case (Sq != Skv)
CHUNKED_CASES = {name: c[:8] for name, c in FA_CASES.items()}
CHUNKED_CASES["ragged_causal_window"] = (2, 4, 2, 37, 70, 64, True, 16)


@pytest.fixture(params=["ref", "pallas_interpret"])
def jax_mode(request):
    """The reference's kernel mode for one test, restored afterwards (xdist workers
    are shared across files)."""
    old = jkernels.get_kernel_mode()
    jkernels.set_kernel_mode(request.param)
    try:
        yield request.param
    finally:
        jkernels.set_kernel_mode(old)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 64), (120, 96)])
def test_rmsnorm_bwd_ref_matches_pallas_interpret(dtype, shape):
    rs = np.random.RandomState(1)
    x_np = rs.randn(*shape).astype(np.float32)
    dy_np = rs.randn(*shape).astype(np.float32)
    w_np = (1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    (xj, xt), (dyj, dyt) = both(x_np, dtype), both(dy_np, dtype)
    wj, wt = jnp.asarray(w_np), torch.from_numpy(w_np)
    dx, dw = tref.rmsnorm_bwd_ref(xt, wt, dyt, 1e-6)
    assert dx.dtype == xt.dtype and dw.dtype == torch.float32
    want_dx, want_dw = jax_rmsnorm_bwd(xj, wj, dyj, eps=1e-6, interpret=True)
    np.testing.assert_allclose(f32(dx), f32(want_dx), **(BWD_TOL if dtype == "float32" else
                                                           TOL["bfloat16"]))
    np.testing.assert_allclose(f32(dw), f32(want_dw), **BWD_TOL)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_rmsnorm_gradient_matches_reference_vjp(jax_mode, impl):
    """autograd through ops.rmsnorm (on the CPU: the Function with K2's and K3's plain
    versions, or plain autograd with impl="ref") against jax.vjp of the reference op."""
    rs = np.random.RandomState(2)
    x_np = rs.randn(3, 40, 96).astype(np.float32)
    w_np = (1.0 + 0.1 * rs.randn(96)).astype(np.float32)
    g_np = rs.randn(3, 40, 96).astype(np.float32)
    y, vjp = jax.vjp(lambda x, w: jkernels.rmsnorm(x, w, eps=1e-6), jnp.asarray(x_np),
                     jnp.asarray(w_np))
    want = vjp(jnp.asarray(g_np))
    x = torch.from_numpy(x_np).requires_grad_(True)
    w = torch.from_numpy(w_np).requires_grad_(True)
    out = ops.rmsnorm(x, w, eps=1e-6, impl=impl)
    got = torch.autograd.grad(out, (x, w), torch.from_numpy(g_np))
    np.testing.assert_allclose(f32(out.detach()), f32(y), **TOL["float32"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), **BWD_TOL)


def _chunked_inputs(case, seed=3):
    B, H, KVH, Sq, Skv, D, causal, window = CHUNKED_CASES[case]
    q, k, v = make_qkv(seed, B, H, KVH, Sq, Skv, D)
    do = np.random.RandomState(seed + 1).randn(B, H, Sq, D).astype(np.float32)
    return (q, k, v, do), causal, window


@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_chunked_forward_and_lse_match_reference(case):
    """o and lse of the chunked twin, f32.  lse is compared on rows with a visible
    column (all rows here): on a fully masked row the twin has log(columns)."""
    (q, k, v, _), causal, window = _chunked_inputs(case)
    o, lse = tref.flash_attention_fwd_lse_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        window=window,
    )
    want_o, want_lse = jref.flash_attention_fwd_lse_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window
    )
    visible = np.asarray(jref.attention_mask(q.shape[2], k.shape[2], causal=causal,
                                             window=window)).any(-1)
    assert visible.all() and lse.shape == want_lse.shape
    np.testing.assert_allclose(f32(o), f32(want_o), **TOL["float32"])
    np.testing.assert_allclose(f32(lse)[:, :, visible], f32(want_lse)[:, :, visible],
                               **TOL["float32"])
    plain = tref.flash_attention_ref_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        window=window,
    )
    np.testing.assert_allclose(f32(plain), f32(want_o), **TOL["float32"])


@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_chunked_backward_matches_reference(case):
    (q, k, v, do), causal, window = _chunked_inputs(case)
    o, lse = jref.flash_attention_fwd_lse_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window
    )
    want = jref.flash_attention_bwd_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(do),
        causal=causal, window=window,
    )
    got = tref.flash_attention_bwd_chunked(
        *(torch.from_numpy(a) for a in (q, k, v, np.array(o), np.array(lse), do)),
        causal=causal, window=window,
    )
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(f32(a), f32(b), **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_backward_rows_that_see_no_key(causal):
    """Rows past Skv whose window lies wholly behind them (here rows 7 to 11 of 12, over
    5 keys, window 3) see no key: the chunked backward gives them a zero dq row and
    takes nothing from them into dk and dv, as K4's backward kernel does.  The other
    rows' gradients are those of plain autograd over those rows alone."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(21, 1, 4, 2, 12, 5, 16))
    do = torch.from_numpy(np.random.RandomState(22).randn(1, 4, 12, 16).astype(np.float32))
    seen = tref.attention_mask(12, 5, causal=causal, window=3).any(-1)
    assert seen.tolist() == [True] * 7 + [False] * 5
    o, lse = tref.flash_attention_fwd_lse_chunked(q, k, v, causal=causal, window=3)
    dq, dk, dv = tref.flash_attention_bwd_chunked(q, k, v, o, lse, do, causal=causal,
                                                  window=3)
    assert torch.all(dq[:, :, 7:] == 0)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q[:, :, :7], k, v))
    os_ = tref.flash_attention_ref(qs, ks, vs, causal=causal, window=3)
    want = torch.autograd.grad(os_, (qs, ks, vs), do[:, :, :7])
    for a, b in zip((dq[:, :, :7], dk, dv), want):
        np.testing.assert_allclose(f32(a), f32(b), **GRAD_TOL)


@functools.lru_cache(maxsize=None)
def _jax_attention_vjp(mode, case):
    """(dq, dk, dv) of the reference op in ``mode`` (set by the caller's fixture), on
    the inputs of ``test_attention_gradient_matches_reference``; cached, since both
    of the port's impls are held against one reference run."""
    assert jkernels.get_kernel_mode() == mode
    B, H, KVH, Sq, Skv, D, causal, window, _, _ = FA_CASES[case]
    q, k, v = make_qkv(11, B, H, KVH, Sq, Skv, D)
    g = np.random.RandomState(12).randn(B, H, Sq, D).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, b, c: jkernels.flash_attention(a, b, c, causal=causal, window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    return tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))


@pytest.mark.parametrize("impl", [None, "chunked"])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_attention_gradient_matches_reference(jax_mode, impl, case):
    """autograd through ops.flash_attention against jax.grad of the reference op in
    its mode: impl="chunked" is the Function (chunked forward with lse, chunked
    backward); impl=None on the CPU is plain autograd through the full softmax."""
    B, H, KVH, Sq, Skv, D, causal, window, _, _ = FA_CASES[case]
    q, k, v = make_qkv(11, B, H, KVH, Sq, Skv, D)
    g = np.random.RandomState(12).randn(B, H, Sq, D).astype(np.float32)
    want = _jax_attention_vjp(jax_mode, case)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, causal=causal, window=window, impl=impl)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), **GRAD_TOL)


def test_ops_without_grad_run_the_forward_alone():
    """No operand requires a gradient (or grad mode is off): the chunked forward
    without lse, and nothing saved."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 1, 2, 1, 16, 16, 32))
    o = ops.flash_attention(q, k, v, causal=True, impl="chunked")
    assert o.grad_fn is None
    torch.testing.assert_close(o, tref.flash_attention_ref_chunked(q, k, v, causal=True),
                               rtol=0, atol=0)
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.flash_attention(qg, k, v, causal=True, impl="chunked").grad_fn is None
        assert ops.rmsnorm(qg, torch.ones(32)).grad_fn is None
    assert type(ops.flash_attention(qg, k, v, causal=True, impl="chunked").grad_fn).__name__ \
        == "_FlashAttentionBackward"
    assert type(ops.rmsnorm(qg, torch.ones(32)).grad_fn).__name__ == "_RMSNormBackward"


@pytest.mark.parametrize(
    "x,w,dy,error",
    [
        (torch.zeros(4, 8), torch.ones(8), torch.zeros(4, 8), None),
        (torch.zeros(4, 8), torch.ones(8), torch.zeros(4, 8, dtype=torch.bfloat16), "match"),
        (torch.zeros(4, 8), torch.ones(8), torch.zeros(8, 4).T, "contiguous"),
        (torch.zeros(4, 8), torch.ones(8), torch.zeros(4, 9), "match"),
        (torch.zeros(4, 8), torch.ones(8, dtype=torch.bfloat16), torch.zeros(4, 8), "weight"),
    ],
)
def test_rmsnorm_bwd_argument_checks(x, w, dy, error):
    if error is None:
        rms_check_bwd_args(x, w, dy)
    else:
        with pytest.raises((ValueError, TypeError), match=error):
            rms_check_bwd_args(x, w, dy)


# ---------------------------------------------------------------------------
# the Mamba-2 SSD scan (K5): the cases of tests/kernels/test_ssd_scan.py
# ---------------------------------------------------------------------------

# 2e-4, as tests/kernels/test_ssd_scan.py holds the chunked kernel against the
# stepwise recurrence; bf16 y at 2e-2 (rounded to bf16 after f32 math).  The f32
# state takes 2e-4 in both dtypes: both packages compute it in f32 from the same
# bf16 values.
SSD_TOL = dict(rtol=2e-4, atol=2e-4)

# name: (Bt, S, H, P, G, N, chunk)
SSD_FWD_CASES = {
    "chunk16": (2, 64, 4, 16, 2, 32, 16),
    "chunk32": (2, 64, 4, 16, 2, 32, 32),
    "chunk64": (2, 64, 4, 16, 2, 32, 64),
    "single_chunk": (1, 32, 2, 8, 1, 16, 32),
    "single_chunk_as_4": (1, 32, 2, 8, 1, 16, 8),
    "sweep_h2_g1": (1, 32, 2, 8, 1, 16, 16),
    "sweep_h4_g2": (2, 64, 4, 16, 2, 32, 32),
    "sweep_h4_g4": (2, 128, 4, 8, 4, 16, 16),
    "sweep_n32_p16": (1, 128, 4, 16, 2, 32, 32),
}


def _ssd_both(arrays, dtype):
    return [both(a, dtype if i in (0, 1, 3, 4) else "float32") for i, a in enumerate(arrays)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_FWD_CASES))
def test_ssd_scan_plain_versions_match_reference(case, dtype):
    """The stepwise and chunked plain versions against the reference's Pallas kernel
    in interpret mode and its stepwise oracle: y and the final state.  x, dt, B, C
    in ``dtype`` as the reference's test draws them (A stays f32)."""
    Bt, S, H, P, G, N, chunk = SSD_FWD_CASES[case]
    (xj, xt), (dtj, dtt), (Aj, At), (Bj, Btt), (Cj, Ct) = _ssd_both(
        make_ssd(sorted(SSD_FWD_CASES).index(case), Bt, S, H, P, G, N), dtype
    )
    want_kernel = jax_ssd_scan_fwd(xj, dtj, Aj, Bj, Cj, chunk=chunk, interpret=True)
    want_ref = jref.ssd_scan_ref(xj, dtj, Aj, Bj, Cj)
    y_tol = SSD_TOL if dtype == "float32" else TOL["bfloat16"]
    for got in (tref.ssd_scan_ref(xt, dtt, At, Btt, Ct),
                tref.ssd_scan_ref_chunked(xt, dtt, At, Btt, Ct, chunk=chunk)):
        assert got[0].dtype == xt.dtype and got[1].dtype == torch.float32
        assert tuple(got[1].shape) == (Bt, H, N, P)
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(f32(got[0]), f32(want[0]), **y_tol)
            np.testing.assert_allclose(f32(got[1]), f32(want[1]), **SSD_TOL)


@pytest.mark.parametrize("S,chunk", [(200, 64), (200, 128), (12, 8), (1, 64), (65, 64)])
def test_ssd_scan_chunked_takes_a_ragged_sequence(S, chunk):
    """S not a multiple of the chunk (the reference's chunked forms assert it is):
    the port's chunked version against the reference's stepwise oracle, G = 2."""
    (xj, xt), (dtj, dtt), (Aj, At), (Bj, Btt), (Cj, Ct) = _ssd_both(
        make_ssd(S, 2, S, 4, 16, 2, 32), "float32"
    )
    want = jref.ssd_scan_ref(xj, dtj, Aj, Bj, Cj)
    for got in (tref.ssd_scan_ref_chunked(xt, dtt, At, Btt, Ct, chunk=chunk),
                tref.ssd_scan_ref(xt, dtt, At, Btt, Ct)):
        np.testing.assert_allclose(f32(got[0]), f32(want[0]), **SSD_TOL)
        np.testing.assert_allclose(f32(got[1]), f32(want[1]), **SSD_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_step_token_by_token_equals_the_scan(G):
    """ssd_step run over the sequence gives the scan's y and final state (the serving
    path), and each step equals the reference's ssd_step."""
    arrays = make_ssd(2, 1, 16, 2, 8, G, 16)
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    xj, dtj, Aj, Bj, Cj = (jnp.asarray(a) for a in arrays)
    h = torch.zeros((1, 2, 16, 8))
    hj = jnp.zeros((1, 2, 16, 8), jnp.float32)
    ys = []
    for t in range(16):
        h, y_t = kernels.ssd_step(h, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        hj, yj = jkernels.ssd_step(hj, xj[:, t], dtj[:, t], Aj, Bj[:, t], Cj[:, t])
        np.testing.assert_allclose(f32(y_t), f32(yj), **SSD_TOL)
        np.testing.assert_allclose(f32(h), f32(hj), **SSD_TOL)
        ys.append(y_t)
    y_scan, h_scan = tref.ssd_scan_ref(x, dt, A, B, C)
    np.testing.assert_allclose(f32(torch.stack(ys, 1)), f32(y_scan), **SSD_TOL)
    np.testing.assert_allclose(f32(h), f32(h_scan), **SSD_TOL)


@functools.lru_cache(maxsize=None)
def _jax_ssd_grads(case):
    """Gradients of sum(y * g) wrt (x, dt, A, B, C) of the reference op in its ``ref``
    mode (plain autograd through the stepwise scan); cached across the port's impls."""
    arrays, g = _ssd_grad_inputs(case)
    old = jkernels.get_kernel_mode()
    jkernels.set_kernel_mode("ref")
    try:
        _, vjp = jax.vjp(lambda *a: jkernels.ssd_scan(*a), *(jnp.asarray(a) for a in arrays))
        return tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))
    finally:
        jkernels.set_kernel_mode(old)


def _ssd_grad_inputs(case):
    arrays = extreme_decay_ssd() if case == "extreme_decay" else make_ssd(
        3, *{"one_chunk": (1, 32, 2, 8, 1, 16), "groups": (2, 48, 4, 8, 2, 16),
             "ragged": (1, 150, 2, 8, 1, 16)}[case])
    g = np.random.RandomState(4).randn(*arrays[0].shape).astype(np.float32)
    return arrays, g


@pytest.mark.parametrize("impl", [None, "chunked", "ref"])
@pytest.mark.parametrize("case", ["one_chunk", "groups", "ragged", "extreme_decay"])
def test_ssd_scan_gradient_matches_reference(impl, case):
    """autograd through ops.ssd_scan against jax.vjp of the reference op in ``ref``
    mode: on the CPU impl=None is the Function (plain forward, chunked backward),
    "chunked" and "ref" plain autograd.  At dt·A down to -62 ("extreme_decay", where
    the reference's chunked backward gives NaN) the port's chunked backward stays
    finite and agrees with the stepwise one."""
    arrays, g = _ssd_grad_inputs(case)
    want = _jax_ssd_grads(case)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = ops.ssd_scan(*ins, impl=impl)
    if impl is None:
        assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    got = torch.autograd.grad(y, ins, torch.from_numpy(g))
    for a, b in zip(got, want, strict=True):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(f32(a), f32(b), **SSD_TOL)


def test_ssd_scan_serving_form_returns_the_state():
    ins = [torch.from_numpy(a) for a in make_ssd(5, 2, 20, 4, 8, 2, 16)]
    for impl in (None, "chunked", "ref"):
        y, h = ops.ssd_scan(*ins, return_final_state=True, impl=impl)
        want_y, want_h = tref.ssd_scan_ref(*ins)
        np.testing.assert_allclose(f32(y), f32(want_y), **SSD_TOL)
        np.testing.assert_allclose(f32(h), f32(want_h), **SSD_TOL)
    with torch.no_grad():
        assert ops.ssd_scan(ins[0].clone().requires_grad_(True), *ins[1:]).grad_fn is None


# K5's bf16 passes multiply the bf16 inputs by f32 operands (the masked, decayed scores,
# w·x, h_in) taken as bf16 hi + lo pairs: two MMAs keep ~16 bits of each mantissa,
# where a single bf16 rounding of the scores or of h_in takes y past 2e-2 at the
# mamba2-370m serving shape.  Their plain twin (ref.ssd_scan_fwd_tc_twin, chunk 128)
# keeps the reference's tolerances on every SSD_FWD_CASES entry and at dt·A down to
# -62: y at the bf16 2e-2, the f32 state at 2e-4.  x, B, C in bf16, dt and A in f32,
# as the model hands them to the kernel.
SSD_TWIN_CASES = {**{k: v[:6] for k, v in SSD_FWD_CASES.items()}, "extreme_decay": None}


@pytest.mark.parametrize("case", sorted(SSD_TWIN_CASES))
def test_ssd_tensor_core_twin_keeps_the_reference_tolerance(case):
    shape = SSD_TWIN_CASES[case]
    arrays = extreme_decay_ssd() if shape is None else make_ssd(
        30 + sorted(SSD_TWIN_CASES).index(case), *shape)
    (xj, xt), (dtj, dtt), (Aj, At), (Bj, Btt), (Cj, Ct) = [
        both(a, "bfloat16" if i in (0, 3, 4) else "float32") for i, a in enumerate(arrays)]
    y, h = tref.ssd_scan_fwd_tc_twin(xt, dtt, At, Btt, Ct)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    chunk = SSD_FWD_CASES[case][6] if shape is not None else xt.shape[1]
    want_kernel = jax_ssd_scan_fwd(xj, dtj, Aj, Bj, Cj, chunk=chunk, interpret=True)
    want_ref = jref.ssd_scan_ref(xj, dtj, Aj, Bj, Cj)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(f32(y), f32(want[0]), **TOL["bfloat16"])
        np.testing.assert_allclose(f32(h), f32(want[1]), **SSD_TOL)


def test_ssd_tensor_core_twin_takes_ragged_shapes():
    """The twin where the kernel zero-pads: S off the chunk, N and P off the MMA tile
    (the card cases of SSD_RAGGED_TC_CASES), against the stepwise plain version."""
    for i, shape in enumerate(SSD_RAGGED_TC_CASES.values()):
        x, dt, A, B, C = (torch.from_numpy(a) for a in make_ssd(40 + i, *shape))
        x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
        y, h = tref.ssd_scan_fwd_tc_twin(x, dt, A, B, C)
        want_y, want_h = tref.ssd_scan_ref(x, dt, A, B, C)
        np.testing.assert_allclose(f32(y), f32(want_y), **TOL["bfloat16"])
        np.testing.assert_allclose(f32(h), f32(want_h), **SSD_TOL)


# the mamba2-370m serving shape, the card-test shapes and the ragged bf16 ones
SSD_PLAN_SHAPES = {"serve_mamba2_370m": (4, 1024, 32, 64, 1, 128), **SSD_CASES,
                   **SSD_RAGGED_TC_CASES}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_PLAN_SHAPES))
def test_ssd_plan_fits_and_covers(case, dtype):
    """Every pass fits the H100's 227 KB of shared memory a block, the chunk state and
    chunk output grids cover every (batch, chunk, head), the state-passing grid every
    state element, and the wrapper counts one launch per pass."""
    Bt, S, H, P, G, N = SSD_PLAN_SHAPES[case]
    p = tssd.plan(Bt, S, H, G, N, P, DTYPES[dtype][1])
    assert p.chunk == tssd.CHUNK[dtype] and p.n_chunks == -(-S // p.chunk)
    assert p.n_chunks * p.chunk >= S > (p.n_chunks - 1) * p.chunk
    assert len(p.passes) == tssd.LAUNCHES_PER_CALL == 3
    assert all(ps.smem <= tssd.SMEM_LIMIT and ps.threads == 256 for ps in p.passes)
    assert (H // G) % p.heads_per_block == 0 and p.heads_per_block <= tssd.MAX_HEADS_PER_BLOCK
    assert (H // G) % p.state_heads_per_block == 0
    assert p.state_heads_per_block <= tssd.MAX_STATE_HEADS_PER_BLOCK
    state, passing, output = p.passes
    assert passing.grid[1:] == (H, Bt) and passing.grid[0] * passing.threads * 4 >= N * P
    assert state.grid == (p.n_chunks, H // p.state_heads_per_block, Bt)
    assert output.grid == (p.n_chunks, H // p.heads_per_block, Bt)
    assert p.scratch["dH"] == ((Bt, p.n_chunks, H, N, P), torch.float32)
    assert p.scratch["cum"] == ((Bt, p.n_chunks, H, p.chunk), torch.float32)
    assert p.scratch["h_in"] == (((Bt, p.n_chunks, H, 2, N, P), torch.bfloat16)
                                 if dtype == "bfloat16" else None)


def test_ssd_plan_at_the_serving_shape():
    """mamba2-370m, x (4,1024,32,64), B/C (4,1024,1,128), bf16: 8 chunks of 128; the
    chunk state pass takes the one group's 32 heads in tiles of 4 (B loaded 8 times a
    chunk instead of 32; 256 blocks, 2 an SM), the chunk output pass in tiles of 8
    (C·Bᵀ computed 4 times a chunk instead of 32; 128 blocks, one wave on 132 SMs);
    33.5 MB of f32 chunk states and as much of h_in (a bf16 hi and lo pair a chunk)."""
    p = tssd.plan(4, 1024, 32, 1, 128, 64, torch.bfloat16)
    assert (p.chunk, p.n_chunks, p.heads_per_block, p.state_heads_per_block) == (128, 8, 8, 4)
    assert [ps.grid for ps in p.passes] == [(8, 8, 4), (8, 32, 4), (8, 4, 4)]
    assert [ps.smem for ps in p.passes] == [92_192, 0, 182_272]
    assert np.prod(p.scratch["dH"][0]) * 4 == np.prod(p.scratch["h_in"][0]) * 2 == 33_554_432


def _ssd_args(Bt=1, S=8, H=4, P=8, G=2, N=8, dtype=torch.float32):
    return [
        torch.zeros(Bt, S, H, P, dtype=dtype), torch.zeros(Bt, S, H), -torch.ones(H),
        torch.zeros(Bt, S, G, N, dtype=dtype), torch.zeros(Bt, S, G, N, dtype=dtype),
    ]


def _with(i, t):
    args = _ssd_args()
    args[i] = t
    return args


@pytest.mark.parametrize(
    "args,error",
    [
        (lambda: _ssd_args(), None),
        (lambda: _ssd_args(dtype=torch.bfloat16), None),
        (lambda: _ssd_args(H=3, G=2), "multiple of groups"),
        (lambda: _ssd_args(P=6), "multiples of 4"),
        (lambda: _ssd_args(N=10), "multiples of 4"),
        (lambda: _ssd_args(dtype=torch.float16), "float32 or all bfloat16"),
        (lambda: _with(3, torch.zeros(1, 8, 2, 8, dtype=torch.bfloat16)), "float32 or all"),
        (lambda: _with(1, torch.zeros(1, 8, 4, dtype=torch.bfloat16)), "float32 dt and A"),
        (lambda: _with(2, -torch.ones(4, dtype=torch.float64)), "float32 dt and A"),
        (lambda: _with(0, torch.zeros(1, 8, 8, 4).transpose(2, 3)), "contiguous"),
        (lambda: _with(4, torch.zeros(1, 8, 8, 2).transpose(2, 3)), "contiguous"),
        (lambda: _with(1, torch.zeros(1, 7, 4)), "do not match"),
        (lambda: _with(2, -torch.ones(3)), "do not match"),
        (lambda: _with(0, torch.zeros(1, 8, 4)), "need x"),
    ],
)
def test_ssd_scan_argument_checks(args, error):
    if error is None:
        ssd_check_args(*args())
    else:
        with pytest.raises((ValueError, TypeError), match=error):
            ssd_check_args(*args())
