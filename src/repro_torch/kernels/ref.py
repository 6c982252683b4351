"""Plain PyTorch versions of the port's kernels.

They are the semantic ground truth the CUDA kernels are held against on the
card, and what the public ops run for tensors on the CPU.  Each follows its
counterpart in ``repro.kernels.ref``: same masks, same finite mask value, f32
accumulation, output in the input dtype.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30  # finite mask value: avoids NaN rows when every column is masked


def attention_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool,
    window: int | None,
    q_offset: int = 0,
    device: torch.device | None = None,
) -> torch.Tensor:
    """(q_len, kv_len) boolean visibility mask.

    ``window`` means position ``j`` is visible from ``i`` iff ``i - j < window``
    (and ``j <= i`` if causal)."""
    rows = torch.arange(q_len, device=device)[:, None] + q_offset
    cols = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= rows >= cols
    if window is not None:
        mask &= cols > rows - window
    return mask


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int | None = None,
    sm_scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-softmax GQA attention.

    q: (B, H, Sq, D); k, v: (B, KVH, Skv, D) with H % KVH == 0.
    Returns (B, H, Sq, D) in q.dtype; softmax and matmuls in f32."""
    B, H, Sq, D = q.shape
    KVH = k.shape[1]
    if H % KVH:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {KVH}")
    group = H // KVH
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)

    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    mask = attention_mask(
        Sq, k.shape[2], causal=causal, window=window, q_offset=q_offset, device=q.device
    )
    s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return o.to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; accumulation in f32, output in x.dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    return y.to(x.dtype)
