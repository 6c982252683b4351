"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips.  The shapes are the cases of
``tests/kernels/test_flash_attention.py`` (shared with ``test_torch_kernels.py``),
ragged edges the TPU kernel's tiling could not take, and the rmsnorm shapes of
the gemma3-1b serving path.  Tolerances: 2e-5 in f32 (the same f32 math summed in
another order), 2e-2 in bf16 (outputs rounded to bf16 after f32 math).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

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
