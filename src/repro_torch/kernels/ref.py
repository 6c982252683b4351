"""Plain PyTorch versions of the port's kernels.

They are the semantic ground truth the CUDA kernels are held against on the
card, and what the public ops run for tensors on the CPU.  Each follows its
counterpart in ``repro.kernels.ref``: same masks, same finite mask value, f32
accumulation, output in the input dtype.  The chunked attention functions keep the
reference's ``block_k = 512`` key blocks; its ``lax.scan`` over blocks is a Python
loop here, as are the SSD scans' ``lax.scan``s over steps and chunks.
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


def _kv_blocks(k: torch.Tensor, v: torch.Tensor, block_k: int):
    """k, v in f32, padded with zeros to whole blocks: (nb, padded k, padded v)."""
    Skv = k.shape[2]
    nb = -(-Skv // block_k)
    pad = nb * block_k - Skv
    kf = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, pad))
    return nb, kf, vf


def _block_mask(Sq: int, Skv: int, bi: int, block_k: int, causal: bool, window: int | None,
                device: torch.device) -> torch.Tensor:
    """(Sq, block_k) visibility of key block ``bi``, padding columns masked."""
    rows = torch.arange(Sq, device=device)[:, None]
    cols = bi * block_k + torch.arange(block_k, device=device)[None, :]
    mask = cols < Skv
    if causal:
        mask = mask & (rows >= cols)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def _chunked_fwd(q, k, v, causal, window, sm_scale, block_k):
    """The online-softmax forward over key blocks: (acc, m, l) in f32."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    group = H // KVH
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    nb, kf, vf = _kv_blocks(k, v, block_k)
    qf = q.to(torch.float32) * scale
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    for bi in range(nb):
        blk = slice(bi * block_k, (bi + 1) * block_k)
        kr = kf[:, :, blk].repeat_interleave(group, dim=1)
        vr = vf[:, :, blk].repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kr)
        mask = _block_mask(Sq, Skv, bi, block_k, causal, window, q.device)
        s = s.masked_fill(~mask[None, None], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vr)
        m = m_new
    return acc, m, l


def flash_attention_ref_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int | None = None,
    sm_scale: float | None = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``block_k``: O(S·D) live memory
    instead of the O(S²) scores of :func:`flash_attention_ref`."""
    acc, _, l = _chunked_fwd(q, k, v, causal, window, sm_scale, block_k)
    return (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)


def flash_attention_fwd_lse_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int | None = None,
    sm_scale: float | None = None,
    block_k: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked forward with the row logsumexp the chunked backward needs:
    (o in q.dtype, lse (B, H, Sq, 1) f32 in scaled-score units)."""
    acc, m, l = _chunked_fwd(q, k, v, causal, window, sm_scale, block_k)
    lsafe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / lsafe).to(q.dtype), m + torch.log(lsafe)


_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def flash_attention_fwd_tc_twin(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int | None = None,
    sm_scale: float | None = None,
    block_k: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rounding points of K4's bf16 tensor-core kernel (``csrc/flash_attention.cu``,
    ``fa_fwd_tc_kernel``), in plain PyTorch, for the tests: (o in q.dtype, lse (B, H,
    Sq, 1) f32 in natural-log, scaled-score units).

    Per key block of ``block_k``: the scores are an f32 product of the inputs with the
    scale applied after it, in log2 units (``s * scale * log2(e)``, the finite mask
    value ``-1e30 * log2(e)``, ``-inf`` past ``Skv``); ``p = exp2(t - m)``; ``l`` sums
    the f32 ``p``, and P·V takes ``p`` rounded to bf16 with an f32 sum.  No main path
    runs it."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    group = H // KVH
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    c = scale * _LOG2E
    qf = q.to(torch.float32)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq, 1), _NEG_INF * _LOG2E, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, block_k):
        blk = slice(start, min(start + block_k, Skv))
        kr = k[:, :, blk].to(torch.float32).repeat_interleave(group, dim=1)
        vr = v[:, :, blk].to(torch.float32).repeat_interleave(group, dim=1)
        t = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * c
        mask = attention_mask(Sq, Skv, causal=causal, window=window, device=q.device)[:, blk]
        t = t.masked_fill(~mask[None, None], _NEG_INF * _LOG2E)
        m_new = torch.maximum(m, t.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).to(torch.float32), vr)
        acc = acc * alpha + pv
        m = m_new
    lsafe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / lsafe).to(q.dtype), m * _LN2 + torch.log(lsafe)


def flash_attention_bwd_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = False,
    window: int | None = None,
    sm_scale: float | None = None,
    block_k: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked flash backward: per key block, recompute p from the saved logsumexp.

        δ_i   = Σ_d do_id·o_id
        p_ij  = exp(s_ij − lse_i)
        dv_j  = Σ_i p_ij·do_i
        ds_ij = p_ij·(do_i·v_j − δ_i)
        dq_i += scale·Σ_j ds_ij·k_j ;  dk_j = scale·Σ_i ds_ij·q_i

    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    group = H // KVH
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    nb, kf, vf = _kv_blocks(k, v, block_k)
    qf = q.to(torch.float32)
    dof = do.to(torch.float32)
    delta = torch.sum(dof * o.to(torch.float32), dim=-1, keepdim=True)
    dq = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for bi in range(nb):
        blk = slice(bi * block_k, (bi + 1) * block_k)
        kr = kf[:, :, blk].repeat_interleave(group, dim=1)
        vr = vf[:, :, blk].repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
        mask = _block_mask(Sq, Skv, bi, block_k, causal, window, q.device)
        s = s.masked_fill(~mask[None, None], _NEG_INF)
        p = torch.exp(s - lse)  # masked → 0
        dv_r = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
        ds = p * (dp - delta)
        dq = dq + scale * torch.einsum("bhqk,bhkd->bhqd", ds, kr)
        dk_r = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        # fold the grouped q heads back onto their kv head
        dks.append(dk_r.reshape(B, KVH, group, block_k, D).sum(dim=2))
        dvs.append(dv_r.reshape(B, KVH, group, block_k, D).sum(dim=2))
    dk = torch.cat(dks, dim=2)[:, :, :Skv]
    dv = torch.cat(dvs, dim=2)[:, :, :Skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`rmsnorm_ref`, by the formula of the reference's kernel
    (``repro/kernels/rmsnorm.py::_bwd_kernel``), with r = rsqrt(mean(x²) + eps):

        dx = r·dy·w − x·r³·mean(dy·w·x)      dw = Σ_rows dy·x·r

    Returns (dx in x.dtype, dw in w.dtype); the math is f32."""
    D = x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, D)
    dyf = dy.to(torch.float32).reshape(-1, D)
    wf = w.to(torch.float32)
    r = torch.rsqrt(torch.mean(torch.square(xf), dim=1, keepdim=True) + eps)
    dyw = dyf * wf
    proj = torch.sum(dyw * xf, dim=1, keepdim=True) / D
    dx = r * dyw - xf * (r * r * r) * proj
    dw = torch.sum(dyf * xf * r, dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; accumulation in f32, output in x.dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    return y.to(x.dtype)


# ===========================================================================
# Mamba-2 SSD
# ===========================================================================


def _groups_to_heads(t: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """f32 copy of ``t`` with its group axis ``dim`` repeated to ``heads``: head h
    reads group ``h // (heads / groups)``."""
    groups = t.shape[dim]
    if groups == 0 or heads % groups:
        raise ValueError(f"heads {heads} are not a multiple of groups {groups}")
    return t.to(torch.float32).repeat_interleave(heads // groups, dim=dim)


def ssd_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD recurrence, stepwise: the oracle K5 is held against.

    x: (Bt, S, H, P); dt: (Bt, S, H) positive steps; A: (H,) negative rates;
    B, C: (Bt, S, G, N) with H % G == 0.

        h_t = exp(A·dt_t)·h_{t-1} + dt_t·(B_t ⊗ x_t)     h: (H, N, P)
        y_t = C_t · h_t                                   y: (H, P)

    Returns (y (Bt, S, H, P) in x.dtype, final state (Bt, H, N, P) f32)."""
    Bt, S, H, P = x.shape
    N = B.shape[3]
    xf, dtf, Af = x.to(torch.float32), dt.to(torch.float32), A.to(torch.float32)
    Bf, Cf = _groups_to_heads(B, H, 2), _groups_to_heads(C, H, 2)  # (Bt, S, H, N)
    h = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a_t = torch.exp(Af * dtf[:, t])  # (Bt, H)
        h = a_t[..., None, None] * h + (
            dtf[:, t, :, None, None] * Bf[:, t, :, :, None] * xf[:, t, :, None, :]
        )
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bt, 0, H, P))
    return y.to(x.dtype), h


def ssd_scan_ref_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: per-chunk matmuls (the dual, attention-like form) plus an
    (S/L)-step recurrence over the chunks' states, as the TPU kernel computes it.

    Unlike the reference's twin, the decay ``exp(cum_i − cum_j)`` is never formed
    above the diagonal, where ``cum_i − cum_j`` is large and positive: the mask
    selects ``−inf`` before the ``exp``.  The forward values are the same, and the
    backward stays finite where the reference's computes 0·inf (strongly negative
    dt·A; ``tests/kernels/test_ssd_scan.py:92``).  Any S works: the last chunk is
    padded with zero rows and dt = 0, which add nothing and leave the decay as it is.

    Returns (y (Bt, S, H, P) in x.dtype, final state (Bt, H, N, P) f32)."""
    Bt, S, H, P = x.shape
    N = B.shape[3]
    L = max(1, min(chunk, S))
    nc = -(-S // L)
    pad = nc * L - S
    F = torch.nn.functional
    xf = F.pad(x.to(torch.float32), (0, 0, 0, 0, 0, pad)).reshape(Bt, nc, L, H, P)
    dtf = F.pad(dt.to(torch.float32), (0, 0, 0, pad)).reshape(Bt, nc, L, H)
    Bf = F.pad(_groups_to_heads(B, H, 2), (0, 0, 0, 0, 0, pad)).reshape(Bt, nc, L, H, N)
    Cf = F.pad(_groups_to_heads(C, H, 2), (0, 0, 0, 0, 0, pad)).reshape(Bt, nc, L, H, N)

    cum = torch.cumsum(A.to(torch.float32) * dtf, dim=2)  # (Bt, nc, L, H)

    # intra-chunk: y_i += Σ_{j≤i} (C_i·B_j)·exp(cum_i − cum_j)·dt_j·x_j
    seg = cum[:, :, :, None] - cum[:, :, None, :]  # (Bt, nc, L, L, H)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(tri, seg, torch.full_like(seg, float("-inf"))))
    s = torch.einsum("bclhn,bcmhn->bclmh", Cf, Bf) * decay * dtf[:, :, None]
    y = torch.einsum("bclmh,bcmhp->bclhp", s, xf)

    # inter-chunk: the state entering each chunk, by a recurrence over the chunks
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtf  # (Bt, nc, L, H)
    chunk_state = torch.einsum("bclhn,bclh,bclhp->bchnp", Bf, w, xf)
    total_decay = torch.exp(cum[:, :, -1])  # (Bt, nc, H)
    h = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = total_decay[:, c, :, None, None] * h + chunk_state[:, c]
    y = y + torch.einsum("bclhn,bclh,bchnp->bclhp", Cf, torch.exp(cum), torch.stack(h_in, 1))
    return y.reshape(Bt, nc * L, H, P)[:, :S].to(x.dtype), h


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and widened back to f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _hi_lo(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` as a bf16 pair, hi = bf16(t) and lo = bf16(t - hi), widened to f32."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def ssd_scan_fwd_tc_twin(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rounding points of K5's bf16 tensor-core passes (``csrc/ssd_scan.cu``), in
    plain PyTorch, for the tests: (y in x.dtype, final state (Bt, H, N, P) f32).

    Per chunk of ``chunk`` rows (the last zero-padded with dt = 0): C·Bᵀ in f32 from
    the bf16 inputs; each f32 operand of the other products (the masked, decayed
    scores before ·x, ``w_j·x_j`` in the state product, h_in before C·h_in) split into
    a bf16 hi and lo pair, both multiplied and summed in f32; the state recurrence in
    f32; C·h_in scaled by exp(cum_i) after the product.  No main path runs it."""
    Bt, S, H, P = x.shape
    N = B.shape[3]
    L = chunk
    nc = -(-S // L)
    pad = nc * L - S
    F = torch.nn.functional
    xf = F.pad(x.to(torch.float32), (0, 0, 0, 0, 0, pad)).reshape(Bt, nc, L, H, P)
    dtf = F.pad(dt.to(torch.float32), (0, 0, 0, pad)).reshape(Bt, nc, L, H)
    Bf = F.pad(_groups_to_heads(B, H, 2), (0, 0, 0, 0, 0, pad)).reshape(Bt, nc, L, H, N)
    Cf = F.pad(_groups_to_heads(C, H, 2), (0, 0, 0, 0, 0, pad)).reshape(Bt, nc, L, H, N)
    cum = torch.cumsum(A.to(torch.float32) * dtf, dim=2)  # (Bt, nc, L, H)

    # chunk output, intra: (hi + lo of the scores) · x
    cb = torch.einsum("bclhn,bcmhn->bclmh", Cf, Bf)
    seg = cum[:, :, :, None] - cum[:, :, None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    s = torch.where(tri, cb * torch.exp(torch.where(tri, seg, torch.zeros_like(seg)))
                    * dtf[:, :, None], torch.zeros_like(seg))
    y_intra = sum(torch.einsum("bclmh,bcmhp->bclhp", part, xf) for part in _hi_lo(s))

    # chunk state: Bᵀ · (hi + lo of w·x)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtf  # (Bt, nc, L, H)
    dH = sum(torch.einsum("bclhn,bclhp->bchnp", Bf, part) for part in _hi_lo(w[..., None] * xf))

    # state passing, f32
    decay = torch.exp(cum[:, :, -1])  # (Bt, nc, H)
    h = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + dH[:, c]

    # chunk output, inter: exp(cum_i) · (C · (hi + lo of h_in))
    inter = sum(torch.einsum("bclhn,bchnp->bclhp", Cf, part)
                for part in _hi_lo(torch.stack(h_in, 1)))
    y = torch.exp(cum)[..., None] * inter + y_intra
    return y.reshape(Bt, nc * L, H, P)[:, :S].to(x.dtype), h


def ssd_step_ref(
    h: torch.Tensor,
    x_t: torch.Tensor,
    dt_t: torch.Tensor,
    A: torch.Tensor,
    B_t: torch.Tensor,
    C_t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the SSD recurrence.

    h: (Bt, H, N, P) f32 carried state; x_t: (Bt, H, P); dt_t: (Bt, H);
    B_t, C_t: (Bt, G, N).  Returns (new state, y_t (Bt, H, P) in x_t.dtype)."""
    H = x_t.shape[1]
    bf, cf = _groups_to_heads(B_t, H, 1), _groups_to_heads(C_t, H, 1)  # (Bt, H, N)
    dtf = dt_t.to(torch.float32)
    a = torch.exp(A.to(torch.float32) * dtf)  # (Bt, H)
    h = a[..., None, None] * h + (
        dtf[..., None, None] * bf[..., :, None] * x_t.to(torch.float32)[..., None, :]
    )
    y = torch.einsum("bhn,bhnp->bhp", cf, h)
    return h, y.to(x_t.dtype)
