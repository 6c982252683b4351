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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_attention_fwd
from repro.kernels.rmsnorm import rmsnorm_fwd as jax_rmsnorm_fwd
from repro_torch import kernels
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import check_args as fa_check_args
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import check_args as rms_check_args
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from test_torch_kernels_cuda import FA_CASES, make_qkv

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
@pytest.mark.parametrize("shape", [(2, 256, 64), (120, 96), (4, 1, 1152)])
def test_rmsnorm_matches_reference(dtype, shape):
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
    kernels.reset_launches()
    o = kernels.flash_attention(q, k, v, causal=True)
    y = kernels.rmsnorm(q, torch.ones(32))
    assert kernels.LAUNCHES == {"rmsnorm_fwd": 0, "flash_attention_fwd": 0}
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
    assert {"rmsnorm.cu", "flash_attention.cu", "common.cuh"} <= names
