"""Layer building blocks: RMSNorm, GQA attention (self / cross, global /
sliding-window), GLU MLP, token-choice top-k MoE, the Mamba-2 mixer (SSD).

The port of ``repro.models.layers``.  Every block is a pair of functions
``*_init(cfg, gen) -> params`` and ``*_apply(cfg, params, …) -> y``, plus a cached
decode variant for the mixers and cross-attention.
Parameters keep the reference's layouts: ``wq``/``wk``/``wv`` are ``(D, heads,
hd)`` and ``wo`` is ``(H, hd, D)``; q/k/v are ``(B, heads, S, hd)``; the Mamba
mixer's ``in_proj`` is ``(D, 2·DI + 2·N + NH)`` (``[z, x, B, C, dt]``) and
``conv_w`` ``(K, DI + 2·N)``.  ``impl`` is passed to the kernel ops (``"ref"``
runs the plain versions on any device).

Activation sharding is expressed through *logical* axis names via
:func:`repro_torch.parallel.constrain`, at the reference's 16 sites; without a
mesh context it is the identity.  Under one, the model runs on DTensors and every
kernel call goes through :mod:`.boundary`, which hands the kernels plain local
shards.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.parallel import constrain, constrain_as, zeros
from . import boundary
from .common import ModelConfig, apply_rope, dense_init

Params = dict[str, Any]

# ===========================================================================
# Norm
# ===========================================================================


def norm_init(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=torch.float32, device=device)


def norm_apply(
    cfg: ModelConfig, w: torch.Tensor, x: torch.Tensor, *, impl: str | None = None
) -> torch.Tensor:
    return boundary.rmsnorm(x, w, eps=cfg.norm_eps, impl=impl)


# ===========================================================================
# Attention (self / cross, global / sliding-window, GQA)
# ===========================================================================


def attn_init(cfg: ModelConfig, gen: torch.Generator) -> Params:
    D, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.pdtype
    return {
        "wq": dense_init(gen, (D, H, hd), dt, fan_in=D),
        "wk": dense_init(gen, (D, KVH, hd), dt, fan_in=D),
        "wv": dense_init(gen, (D, KVH, hd), dt, fan_in=D),
        "wo": dense_init(gen, (H, hd, D), dt, fan_in=H * hd),
    }


def _proj(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    """x (B, S, D) · w (D, heads, hd) → (B, heads, S, hd), contiguous.  Under a mesh
    the product's columns are split over ``axis`` only where the heads divide it,
    so that the split into (heads, hd) keeps whole heads on a rank."""
    B, S, D = x.shape
    _, heads, hd = w.shape
    # (B, S, D) @ (D, heads·hd): matmul folds the rows into one GEMM, and under a
    # mesh the batch dim keeps its shards (a flattened B·S would not)
    y = x @ w.to(cfg.cdtype).reshape(D, heads * hd)
    y = constrain_as(y, ("batch", "seq", axis), (B, S, heads))
    return y.reshape(B, S, heads, hd).transpose(1, 2).contiguous()


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    kv = ("batch", "kv_heads", "seq", "head_dim")
    q = constrain(_proj(cfg, x, p["wq"], "heads"), "batch", "heads", "seq", "head_dim")
    k = constrain(_proj(cfg, x, p["wk"], "kv_heads"), *kv)
    v = constrain(_proj(cfg, x, p["wv"], "kv_heads"), *kv)
    return q, k, v


def _out(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B, H, S, hd) · wo (H, hd, D) → (B, S, D)."""
    B, H, S, hd = o.shape
    wo = p["wo"].to(cfg.cdtype).reshape(H * hd, -1)
    y = o.transpose(1, 2).reshape(B, S, H * hd) @ wo
    return constrain(y, "batch", "seq", "embed")


def attn_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    kind: str = "global",
    causal: bool = True,
    cross_states: torch.Tensor | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill).  x: (B, S, D).

    With ``cross_states`` (B, S_kv, D), K and V come from the states, there is no
    RoPE and the attention is non-causal."""
    if cross_states is not None:
        return cross_attn_apply(cfg, p, x, cross_cache_init(cfg, p, cross_states), impl=impl)
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.local_window if kind == "local" else None
    o = boundary.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    o = constrain(o, "batch", "heads", "seq", "head_dim")
    return _out(cfg, p, o)


def attn_cache_init(
    cfg: ModelConfig, batch: int, max_len: int, device: torch.device, *, kind: str = "global"
) -> Params:
    """A local (sliding-window) cache is a ring of ``min(max_len, window)`` slots.
    Under a mesh the caches are made in place, big ones sharded on the sequence."""
    size = min(max_len, cfg.local_window) if kind == "local" else max_len
    shape = (batch, cfg.n_kv_heads, size, cfg.hd)
    seq_axis = "seq" if kind == "local" else "kv_seq"  # big caches shard on seq
    axes = ("batch", "kv_heads", seq_axis, "head_dim")
    return {
        "k": zeros(shape, cfg.cdtype, device, *axes),
        "v": zeros(shape, cfg.cdtype, device, *axes),
    }


def attn_decode(
    cfg: ModelConfig,
    p: Params,
    x_t: torch.Tensor,
    pos: int,
    cache: Params,
    *,
    kind: str = "global",
) -> tuple[torch.Tensor, Params]:
    """One-token decode.  x_t: (B, 1, D); pos: absolute position of the token.

    Writes the token's K/V into ``cache`` in place (slot ``pos % size`` for a
    local ring) and returns ``(y, cache)``.  The attention itself is plain f32
    math on a grouped-head view, as in the reference: no kernel
    (``boundary.decode_attention``, on local shards under a mesh)."""
    size = cache["k"].shape[2]
    positions = torch.full((1,), pos, device=x_t.device)  # a fill, not a host-to-device copy
    q = apply_rope(_proj(cfg, x_t, p["wq"], "heads"), positions, cfg.rope_theta)
    k_t = apply_rope(_proj(cfg, x_t, p["wk"], "kv_heads"), positions, cfg.rope_theta)
    v_t = _proj(cfg, x_t, p["wv"], "kv_heads")

    slot = pos % size if kind == "local" else pos
    boundary.cache_put(cache["k"], slice(slot, slot + 1), k_t)
    boundary.cache_put(cache["v"], slice(slot, slot + 1), v_t)
    seq_axis = "seq" if kind == "local" else "kv_seq"
    cache["k"] = constrain(cache["k"], "batch", "kv_heads", seq_axis, "head_dim")
    cache["v"] = constrain(cache["v"], "batch", "kv_heads", seq_axis, "head_dim")

    # visibility: slot j holds absolute position p_j; attend iff 0 <= p_j <= pos
    j = torch.arange(size, device=x_t.device)
    p_j = pos - torch.remainder(pos - j, size) if kind == "local" else j
    valid = (p_j >= 0) & (p_j <= pos)

    o = boundary.decode_attention(q, cache["k"], cache["v"], valid, scale=cfg.hd**-0.5,
                                  cap=cfg.attn_logit_softcap)
    return _out(cfg, p, o), cache


def cross_cache_init(cfg: ModelConfig, p: Params, states: torch.Tensor) -> Params:
    """Cross-attention K/V projected once from the encoder states or image embeddings
    (B, S_kv, D): each (B, KVH, S_kv, hd)."""
    kv = ("batch", "kv_heads", "seq", "head_dim")
    k = constrain(_proj(cfg, states, p["wk"], "kv_heads"), *kv)
    v = constrain(_proj(cfg, states, p["wv"], "kv_heads"), *kv)
    return {"k": k, "v": v}


def cross_attn_apply(
    cfg: ModelConfig, p: Params, x: torch.Tensor, kv: Params, *, impl: str | None = None
) -> torch.Tensor:
    """Non-causal attention of x (B, S, D) over projected K/V (``cross_cache_init``)."""
    q = constrain(_proj(cfg, x, p["wq"], "heads"), "batch", "heads", "seq", "head_dim")
    o = boundary.flash_attention(q, kv["k"], kv["v"], causal=False, impl=impl)
    return _out(cfg, p, constrain(o, "batch", "heads", "seq", "head_dim"))


def cross_attn_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor, cache: Params):
    """One token's cross-attention over the projected K/V: plain f32 math on a
    grouped-head view (``boundary.decode_attention``), with no mask and no softcap, as
    in the reference."""
    q = _proj(cfg, x_t, p["wq"], "heads")
    o = boundary.decode_attention(q, cache["k"], cache["v"], None, scale=cfg.hd**-0.5)
    return _out(cfg, p, o)


# ===========================================================================
# Dense GLU MLP
# ===========================================================================


def mlp_init(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None) -> Params:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.pdtype
    return {
        "wi": dense_init(gen, (D, Fd), dt),
        "wg": dense_init(gen, (D, Fd), dt),
        "wo": dense_init(gen, (Fd, D), dt, fan_in=Fd),
    }


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
    return F.silu(x) if cfg.mlp_act == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"].to(cfg.cdtype)
    g = x @ p["wg"].to(cfg.cdtype)
    h = constrain(h * _act(cfg, g), "batch", "seq", "mlp")
    return constrain(h @ p["wo"].to(cfg.cdtype), "batch", "seq", "embed")


# ===========================================================================
# Token-choice top-k MoE (index-based dispatch and combine)
# ===========================================================================


def moe_init(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """The router in f32 whatever ``pdtype`` is; experts ``wi``/``wg`` (E, D, F) and
    ``wo`` (E, F, D); Kimi's always-on ``shared`` GLU MLP."""
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    dt = cfg.pdtype
    p: Params = {
        "router": dense_init(gen, (D, E), torch.float32),
        "wi": dense_init(gen, (E, D, Fd), dt, fan_in=D),
        "wg": dense_init(gen, (E, D, Fd), dt, fan_in=D),
        "wo": dense_init(gen, (E, Fd, D), dt, fan_in=Fd),
    }
    if cfg.shared_experts:
        p["shared"] = mlp_init(cfg, gen, d_ff=(cfg.moe_d_ff or cfg.d_ff) * cfg.shared_experts)
    return p


def moe_capacity(cfg: ModelConfig, B: int, S: int, full_capacity: bool) -> tuple[int, int, int]:
    """(groups G, tokens a group Sg, slots an expert C).  Groups are batch rows; in
    decode (``full_capacity``) one group whose capacity takes a factor of at least 2."""
    E, K = cfg.num_experts, cfg.top_k
    if full_capacity:
        G, Sg = 1, B * S
        C = min(Sg, max(1, int(Sg * K / E * max(cfg.capacity_factor, 2.0))))
    else:
        G, Sg = B, S
        C = min(Sg, max(1, int(Sg * K / E * cfg.capacity_factor)))
    return G, Sg, C


def moe_route(cfg: ModelConfig, p: Params, xg: torch.Tensor):
    """The router in f32: (probs (G, Sg, E), gate values (G, Sg, K) renormalised over
    the K choices, expert indices (G, Sg, K)).  A stable descending sort breaks ties
    by the lower expert index, as ``jax.lax.top_k`` does."""
    logits = xg.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def moe_apply(
    cfg: ModelConfig, p: Params, x: torch.Tensor, *, full_capacity: bool = False,
    routes: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux loss).  Token-choice top-K routing with per-group capacity and
    index-based dispatch, as the reference's:

        route:    top-K(softmax(x·router))                           (G, Sg, K)
        dispatch: each expert's C slots hold token indices; gather  (G, E, C, D)
        expert GLU on the gathered slots
        combine:  scatter-add of the gated expert outputs back to the tokens

    Assignments take slots in token-major, then k, order; those past an expert's C
    slots are dropped (the residual passes the token through).  Where ``routes`` is
    given, the expert indices (G, Sg, K) are appended to it.

    Under a mesh the dispatch and combine run on each rank's groups and experts
    (``boundary.moe``), which takes the place of the reference's two constraints on
    the gathered slots (its expert-parallel all-to-all)."""
    E = cfg.num_experts

    def core(xl, router, wi, wg, wo, e0, tokens):
        return _moe_core(cfg, xl, router, wi, wg, wo, e0, tokens, full_capacity, routes)

    y, me, ce = boundary.moe(core, x, p["router"], p["wi"], p["wg"], p["wo"],
                             full_capacity=full_capacity)
    aux = E * torch.sum(me * ce)  # load-balancing auxiliary loss (Switch/GShard)
    y = y.to(cfg.cdtype)
    if cfg.shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x)
    return constrain(y, "batch", "seq", "embed"), aux


def _moe_core(cfg: ModelConfig, x, router, wi, wg, wo, e0: int, tokens: int,
              full_capacity: bool, routes: list | None):
    """The MoE on one rank's rows x (B, S, D) and experts ``e0 .. e0 + wi.shape[0]``
    (every expert's FFN width, or a block of it): (y (B, S, D) f32, the mean router
    probability and assignment count of each expert over these rows, each weighted
    by the rows' share of ``tokens``).  On one device the shares are 1 and y is the
    whole output."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    G, Sg, C = moe_capacity(cfg, B, S, full_capacity)
    xg = x.reshape(G, Sg, D)
    probs, gate_vals, gate_idx = moe_route(cfg, {"router": router}, xg)
    if routes is not None:
        routes.append(gate_idx)
    share = B * S / tokens
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx, E).to(torch.float32).sum(2).mean(dim=(0, 1))
    if share != 1.0:
        me, ce = me * share, ce * share

    # each assignment's position in its expert's slots; the dropped ones go to an
    # overflow slot E·C, cut off below
    e_flat = gate_idx.reshape(G, Sg * K)
    sel = F.one_hot(e_flat, E)
    pos = (sel * (sel.cumsum(1) - 1)).sum(-1)
    slot = torch.where(pos < C, e_flat * C + pos, E * C)
    dev = x.device
    tok = torch.arange(Sg, device=dev).repeat_interleave(K).expand(G, -1)
    slot_tok = torch.full((G, E * C + 1), Sg, dtype=torch.long, device=dev)
    slot_tok = slot_tok.scatter(1, slot, tok)[:, :E * C]  # Sg: an empty slot
    slot_gate = torch.zeros((G, E * C + 1), dtype=torch.float32, device=dev)
    slot_gate = slot_gate.scatter(1, slot, gate_vals.reshape(G, Sg * K))[:, :E * C]
    El = wi.shape[0]
    if El != E:  # this rank's experts: their slots only
        slot_tok = slot_tok[:, e0 * C:(e0 + El) * C]
        slot_gate = slot_gate[:, e0 * C:(e0 + El) * C]

    xs_pad = torch.cat([xg, xg.new_zeros(G, 1, D)], dim=1)
    xe = torch.gather(xs_pad, 1, slot_tok[..., None].expand(-1, -1, D))  # (G, El·C, D)
    xe = xe.reshape(G, El, C, D).transpose(0, 1).reshape(El, G * C, D)
    h = torch.bmm(xe, wi.to(cfg.cdtype))
    g = torch.bmm(xe, wg.to(cfg.cdtype))
    ye = torch.bmm(h * _act(cfg, g), wo.to(cfg.cdtype))
    ye = ye.reshape(El, G, C, D).transpose(0, 1).reshape(G, El * C, D)

    w = ye.to(torch.float32) * slot_gate[..., None]
    rows = (slot_tok + torch.arange(G, device=dev)[:, None] * (Sg + 1)).reshape(-1)
    y = torch.zeros((G * (Sg + 1), D), dtype=torch.float32, device=dev)
    y = y.index_add(0, rows, w.reshape(-1, D)).reshape(G, Sg + 1, D)[:, :Sg]
    return y.reshape(B, S, D), me, ce


# ===========================================================================
# Mamba-2 mixer (SSD)
# ===========================================================================


def mamba_init(cfg: ModelConfig, gen: torch.Generator) -> Params:
    D, DI, NH, N = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
    G = 1  # n_groups
    dt = cfg.pdtype
    dev = gen.device
    conv_dim = DI + 2 * G * N
    proj_out = 2 * DI + 2 * G * N + NH  # [z, x, B, C, dt]
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (D, proj_out), dt),
        "conv_w": dense_init(gen, (cfg.conv_kernel, conv_dim), dt, fan_in=cfg.conv_kernel),
        "A_log": torch.log(torch.linspace(1.0, 16.0, NH, **f32)),
        "D_skip": torch.ones((NH,), **f32),
        "dt_bias": torch.zeros((NH,), **f32),
        "gate_norm": torch.ones((DI,), **f32),
        "out_proj": dense_init(gen, (DI, D), dt, fan_in=DI),
    }


def _mamba_split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(z, xc = [x, B, C] (conv'd together), dt (…, NH)): views of the projection.
    Under a mesh the projection's columns are gathered first: the split cuts across
    its shards."""
    zxbcdt = constrain(zxbcdt, "batch", "seq", None)
    DI, N = cfg.d_inner, cfg.ssm_state
    return zxbcdt[..., :DI], zxbcdt[..., DI:2 * DI + 2 * N], zxbcdt[..., 2 * DI + 2 * N:]


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1.  x: (B, S, C); w: (K, C).  The same sum of
    K shifted products as the reference, in the same order."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))


def _conv_window(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The causal conv at the last of K rows: window (B, K, C), w (K, C) → (B, 1, C)."""
    return torch.einsum("bkc,kc->bc", window, w)[:, None, :]


def _mamba_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, return_state: bool,
                   impl: str | None):
    """The Mamba-2 block on a full sequence: (y, final SSM state or None, the
    pre-conv [x, B, C] rows that prefill keeps for the conv cache)."""
    B, S, _ = x.shape
    DI, N, NH, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"].to(cfg.cdtype)
    z, xc_raw, dtr = _mamba_split(cfg, zxbcdt)
    xc = F.silu(boundary.rows(_causal_conv, xc_raw, p["conv_w"].to(cfg.cdtype)))
    xs, Bm, Cm = xc[..., :DI], xc[..., DI:DI + N], xc[..., DI + N:]
    xs = constrain(xs, "batch", "seq", "ssm_proj")
    xs = constrain_as(xs, ("batch", "seq", "ssm_heads"), (B, S, NH))  # whole heads a rank

    # F.softplus returns its input above 20, where jax.nn.softplus is exact: a gap
    # under 2e-9 relative
    dt = F.softplus(dtr.to(torch.float32) + p["dt_bias"])  # (B, S, NH)
    A = -torch.exp(p["A_log"])  # (NH,) negative
    xh = xs.reshape(B, S, NH, P)
    # x, B and C are slices of one split: the kernel takes contiguous operands
    out = boundary.ssd_scan(
        xh.contiguous(), dt.contiguous(), A, Bm[:, :, None, :].contiguous(),
        Cm[:, :, None, :].contiguous(), return_final_state=return_state, impl=impl,
    )
    y, state = out if return_state else (out, None)
    y = y + p["D_skip"].to(cfg.cdtype)[None, None, :, None] * xh  # skip
    y = y.to(cfg.cdtype).reshape(B, S, DI)
    y = y * F.silu(z)
    y = boundary.rmsnorm(y, p["gate_norm"], eps=cfg.norm_eps, impl=impl)
    y = constrain(y @ p["out_proj"].to(cfg.cdtype), "batch", "seq", "embed")
    return y, state, xc_raw


def mamba_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    *,
    return_state: bool = False,
    impl: str | None = None,
):
    """Full-sequence Mamba-2 block.  x: (B, S, D).  With ``return_state`` returns
    ``(y, final SSM state (B, NH, N, P) f32)``, the serving form."""
    y, state, _ = _mamba_forward(cfg, p, x, return_state, impl)
    return (y, state) if return_state else y


def mamba_cache_init(cfg: ModelConfig, batch: int, device: torch.device) -> Params:
    """Under a mesh, placed as ``cache_shardings`` places them: the conv window on
    batch and ``ssm_proj``, the SSM state on batch and ``ssm_heads``."""
    G = 1
    conv_dim = cfg.d_inner + 2 * G * cfg.ssm_state
    return {
        "conv": zeros((batch, cfg.conv_kernel - 1, conv_dim), cfg.cdtype, device,
                      "batch", None, "ssm_proj"),
        "ssm": zeros((batch, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                     torch.float32, device, "batch", "ssm_heads", None, None),
    }


def mamba_decode(
    cfg: ModelConfig, p: Params, x_t: torch.Tensor, cache: Params, *, impl: str | None = None
) -> tuple[torch.Tensor, Params]:
    """One-token Mamba-2 step.  x_t: (B, 1, D).  Updates ``cache`` (the last K-1
    pre-conv rows and the SSM state) in place and returns ``(y, cache)``."""
    B = x_t.shape[0]
    DI, N, NH, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    zxbcdt = x_t @ p["in_proj"].to(cfg.cdtype)
    z, xc_t, dtr = _mamba_split(cfg, zxbcdt)  # xc_t: (B, 1, conv_dim)

    window = torch.cat([cache["conv"], xc_t], dim=1)  # (B, K, conv_dim)
    xc = F.silu(boundary.rows(_conv_window, window, p["conv_w"].to(cfg.cdtype)))

    xs, Bm, Cm = xc[..., :DI], xc[..., DI:DI + N], xc[..., DI + N:]
    dt = F.softplus(dtr[:, 0].to(torch.float32) + p["dt_bias"])  # (B, NH)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, NH, P)
    new_ssm, y = boundary.ssd_step(cache["ssm"], xh, dt, A, Bm[:, 0, None, :], Cm[:, 0, None, :])
    y = y + p["D_skip"].to(cfg.cdtype)[None, :, None] * xh
    y = y.to(cfg.cdtype).reshape(B, 1, DI)
    y = y * F.silu(z)
    y = boundary.rmsnorm(y, p["gate_norm"], eps=cfg.norm_eps, impl=impl)
    y = constrain(y @ p["out_proj"].to(cfg.cdtype), "batch", "seq", "embed")
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(new_ssm)
    return y, cache
