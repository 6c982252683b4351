"""Model assembly: embedding → layer stack → head, for every architecture family of
the reference: dense attention, Mamba-2 and hybrid stacks, MoE, the encoder-decoder
(Whisper) and cross-attention (VLM) models.

Four execution paths share one parameter dictionary:

* ``forward``      — full-sequence forward (logits).
* ``loss_fn``      — the training loss on a batch, differentiable by autograd.
* ``prefill``      — full-sequence forward that also fills the caches (KV, conv
                     window and SSM state, cross-attention K/V).
* ``decode_step``  — single-token step against the caches.

The reference scans over stacked segments of layers (``lax.scan``); here the
layers are a plain list in depth order and run in a Python loop.  Where the
reference rematerialises a scanned segment (``jax.checkpoint``), the port
checkpoints the same layers (:func:`remat_layers`).
:func:`repro_torch.models.convert.params_from_jax` unstacks the reference's
segments into that list.  Parameters: ``{"embed": (V, D), "layers": [...],
"final_norm": (D,)}``, plus ``"lm_head": (D, V)`` when embeddings are not tied and
``"encoder": {"layers": [...], "final_norm"}`` for an encoder-decoder model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.parallel import constrain
from . import boundary
from . import layers as L
from .common import LayerSpec, ModelConfig, apply_rope

Params = dict[str, Any]

_AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def check_supported(spec: LayerSpec) -> None:
    """Every layer kind the reference builds: an attention or Mamba mixer, with or
    without the dense or MoE FFN, with or without cross-attention."""
    if spec.mixer not in ("attn", "mamba"):
        raise ValueError(f"layer {spec.tag!r}: unknown mixer {spec.mixer!r}")


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ===========================================================================
# Per-layer init / apply
# ===========================================================================


def layer_init(
    cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator, device: torch.device
) -> Params:
    check_supported(spec)
    p: Params = {"norm1": L.norm_init(cfg, device)}
    p["mixer"] = L.attn_init(cfg, gen) if spec.mixer == "attn" else L.mamba_init(cfg, gen)
    if spec.ffn:
        p["norm2"] = L.norm_init(cfg, device)
        p["ffn"] = L.moe_init(cfg, gen) if spec.moe else L.mlp_init(cfg, gen)
    if spec.cross_attn:
        p["norm_x"] = L.norm_init(cfg, device)
        p["cross"] = L.attn_init(cfg, gen)
    return p


def _ffn(cfg: ModelConfig, spec: LayerSpec, p: Params, x: torch.Tensor, impl, *,
         full_capacity: bool = False, routes: list | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The channel-mixing sublayer with its residual, and the MoE aux loss (zero for
    the dense MLP and a mixer-only layer); an MoE layer appends its expert indices to
    ``routes`` where given."""
    if not spec.ffn:
        return x, _zero(x)
    h2 = L.norm_apply(cfg, p["norm2"], x, impl=impl)
    if spec.moe:
        y2, aux = L.moe_apply(cfg, p["ffn"], h2, full_capacity=full_capacity, routes=routes)
        return x + y2, aux
    return x + L.mlp_apply(cfg, p["ffn"], h2), _zero(x)


def layer_apply(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    cross_states: torch.Tensor | None = None,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer: (x, MoE aux loss)."""
    h = L.norm_apply(cfg, p["norm1"], x, impl=impl)
    if spec.mixer == "attn":
        y = L.attn_apply(cfg, p["mixer"], h, positions, kind=spec.attn_kind, causal=causal,
                         impl=impl)
    else:
        y = L.mamba_apply(cfg, p["mixer"], h, impl=impl)
    x = x + y
    if spec.cross_attn and cross_states is not None:
        hx = L.norm_apply(cfg, p["norm_x"], x, impl=impl)
        x = x + L.attn_apply(cfg, p["cross"], hx, positions, cross_states=cross_states,
                             impl=impl)
    return _ffn(cfg, spec, p, x, impl)


def layer_cache_init(
    cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int, device: torch.device
) -> Params:
    """The mixer's cache, and for a cross-attention layer K/V of ``num_image_tokens``
    zeros, as the reference makes them (prefill replaces them with the projected
    states)."""
    if spec.mixer == "attn":
        c = {"self": L.attn_cache_init(cfg, batch, max_len, device, kind=spec.attn_kind)}
    else:
        c = {"self": L.mamba_cache_init(cfg, batch, device)}
    if spec.cross_attn:
        shape = (batch, cfg.n_kv_heads, cfg.num_image_tokens, cfg.hd)
        c["cross"] = {n: torch.zeros(shape, dtype=cfg.cdtype, device=device) for n in "kv"}
    return c


def layer_decode(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Params,
    x_t: torch.Tensor,
    pos: int,
    cache: Params,
    *,
    impl: str | None = None,
) -> tuple[torch.Tensor, Params]:
    h = L.norm_apply(cfg, p["norm1"], x_t, impl=impl)
    if spec.mixer == "attn":
        y, cache["self"] = L.attn_decode(cfg, p["mixer"], h, pos, cache["self"],
                                         kind=spec.attn_kind)
    else:
        y, cache["self"] = L.mamba_decode(cfg, p["mixer"], h, cache["self"], impl=impl)
    x_t = x_t + y
    if spec.cross_attn:
        hx = L.norm_apply(cfg, p["norm_x"], x_t, impl=impl)
        x_t = x_t + L.cross_attn_decode(cfg, p["cross"], hx, cache["cross"])
    return _ffn(cfg, spec, p, x_t, impl, full_capacity=True)[0], cache


def layer_prefill(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    max_len: int,
    *,
    cross_states: torch.Tensor | None = None,
    impl: str | None = None,
    routes: list | None = None,
) -> tuple[torch.Tensor, Params]:
    """Forward + cache construction: the same math as ``layer_apply``, and the
    last ``size`` K/V positions, or the conv window and final SSM state, stored in
    the layer's cache; the cross-attention K/V, projected once, serve the attention
    and the cache.  An MoE layer appends its expert indices to ``routes``."""
    B, S, _ = x.shape
    h = L.norm_apply(cfg, p["norm1"], x, impl=impl)
    if spec.mixer == "mamba":
        # The reference runs in_proj a second time for the conv window's rows; they
        # are the same values as the forward's own pre-conv rows, taken here.
        y, state, xc_raw = L._mamba_forward(cfg, p["mixer"], h, True, impl)
        K = cfg.conv_kernel

        def window(rows):  # the last K-1 rows, left-padded where S < K-1
            return F.pad(rows, (0, 0, max(K - 1 - S, 0), 0))[:, -(K - 1):]

        conv = boundary.rows(window, xc_raw)
        cache = {"self": {"conv": conv.to(cfg.cdtype).contiguous(), "ssm": state}}
    else:
        q, k, v = L._qkv(cfg, p["mixer"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        window = cfg.local_window if spec.attn_kind == "local" else None
        o = boundary.flash_attention(q, k, v, causal=True, window=window, impl=impl)
        y = L._out(cfg, p["mixer"], constrain(o, "batch", "heads", "seq", "head_dim"))

        cache = {"self": L.attn_cache_init(cfg, B, max_len, x.device, kind=spec.attn_kind)}
        ck, cv = cache["self"]["k"], cache["self"]["v"]
        size = ck.shape[2]
        tail = min(S, size)
        ktail, vtail = k[:, :, S - tail:], v[:, :, S - tail:]
        if spec.attn_kind == "local" and S > size:
            # ring placement: the token at absolute position p lives in slot p % size
            idx = torch.remainder(torch.arange(tail, device=x.device) + (S - tail), size)
        else:
            idx = slice(0, tail)
        boundary.cache_put(ck, idx, ktail)
        boundary.cache_put(cv, idx, vtail)
    x = x + y
    if spec.cross_attn and cross_states is not None:
        hx = L.norm_apply(cfg, p["norm_x"], x, impl=impl)
        cache["cross"] = L.cross_cache_init(cfg, p["cross"], cross_states)
        x = x + L.cross_attn_apply(cfg, p["cross"], hx, cache["cross"], impl=impl)
    return _ffn(cfg, spec, p, x, impl, routes=routes)[0], cache


# ===========================================================================
# Stack
# ===========================================================================


def stack_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device) -> list[Params]:
    return [layer_init(cfg, spec, gen, device) for spec in cfg.layer_specs()]


def _segment_layers(cfg: ModelConfig):
    """(first layer index, pattern, reps) of each scan segment, in depth order."""
    start = 0
    for pattern, reps in cfg.scan_segments():
        yield start, pattern, reps
        start += len(pattern) * reps


def remat_layers(cfg: ModelConfig) -> list[bool]:
    """Which layers the reference rematerialises: every layer of a scan segment with
    ``reps > 1`` when ``cfg.remat`` and ``cfg.scan_layers`` are set (its
    ``jax.checkpoint`` wraps the scan body), and no trailing ``reps == 1`` layer."""
    out = []
    for _, pattern, reps in _segment_layers(cfg):
        out += [cfg.remat and cfg.scan_layers and reps > 1] * (len(pattern) * reps)
    return out


def stacked_layer_groups(cfg: ModelConfig) -> list[list[int]]:
    """The layers whose parameters the reference stacks into one leaf: for each scan
    segment with ``reps > 1`` and each position in its pattern, the indices of that
    position's layer in every repetition.  (An optimizer that takes a statistic over
    a whole leaf, as Adafactor's update clip does, takes it over such a group.)"""
    groups = []
    for start, pattern, reps in _segment_layers(cfg):
        if reps > 1:
            k = len(pattern)
            groups += [[start + r * k + i for r in range(reps)] for i in range(k)]
    return groups


def stack_apply(
    cfg: ModelConfig,
    layers: list[Params],
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    cross_states: torch.Tensor | None = None,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers in depth order: (x, the MoE aux loss summed over the layers).  With
    autograd recording, the layers of :func:`remat_layers` keep only their input and
    rerun their forward in the backward (``torch.utils.checkpoint``), as the
    reference's remat does."""
    remat = remat_layers(cfg) if torch.is_grad_enabled() else [False] * len(layers)
    aux_total = _zero(x)
    for spec, lp, rm in zip(cfg.layer_specs(), layers, remat, strict=True):
        fn = functools.partial(layer_apply, cfg, spec, lp, causal=causal,
                               cross_states=cross_states, impl=impl)
        if rm:
            x, aux = checkpoint(fn, x, positions, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = fn(x, positions)
        aux_total = aux_total + aux
    return x, aux_total


def stack_cache_init(
    cfg: ModelConfig, batch: int, max_len: int, device: torch.device
) -> list[Params]:
    return [layer_cache_init(cfg, spec, batch, max_len, device) for spec in cfg.layer_specs()]


def stack_decode(
    cfg: ModelConfig,
    layers: list[Params],
    caches: list[Params],
    x_t: torch.Tensor,
    pos: int,
    *,
    impl: str | None = None,
) -> tuple[torch.Tensor, list[Params]]:
    new_caches = []
    for spec, lp, lc in zip(cfg.layer_specs(), layers, caches, strict=True):
        x_t, nc = layer_decode(cfg, spec, lp, x_t, pos, lc, impl=impl)
        new_caches.append(nc)
    return x_t, new_caches


def stack_prefill(
    cfg: ModelConfig,
    layers: list[Params],
    x: torch.Tensor,
    positions: torch.Tensor,
    max_len: int,
    *,
    cross_states: torch.Tensor | None = None,
    impl: str | None = None,
    routes: list | None = None,
) -> tuple[torch.Tensor, list[Params]]:
    caches = []
    for spec, lp in zip(cfg.layer_specs(), layers, strict=True):
        x, c = layer_prefill(cfg, spec, lp, x, positions, max_len, cross_states=cross_states,
                             impl=impl, routes=routes)
        caches.append(c)
    return x, caches


# ===========================================================================
# Full model
# ===========================================================================


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made on ``device``."""
    dev = resolve_device(device)
    return _init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)


class _MetaGenerator:
    """Stands in for the generator of :func:`abstract_params`: its tensors are made
    on the ``meta`` device, where nothing is drawn."""

    device = torch.device("meta")


def abstract_params(cfg: ModelConfig) -> Params:
    """Every parameter as a ``meta`` tensor of its shape and dtype, no storage: the
    reference's ``jax.eval_shape(init_params)``."""
    return _init_params(cfg, _MetaGenerator(), torch.device("meta"))


def _init_params(cfg: ModelConfig, gen, dev: torch.device) -> Params:
    p: Params = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype, fan_in=cfg.d_model),
        "layers": stack_init(cfg, gen, dev),
        "final_norm": L.norm_init(cfg, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype)
    if cfg.enc_dec:
        enc = encoder_config(cfg)
        p["encoder"] = {"layers": stack_init(enc, gen, dev), "final_norm": L.norm_init(enc, dev)}
    return p


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """Whisper's encoder: ``n_enc_layers`` plain (attention, dense GLU) layers."""
    return dataclasses.replace(
        cfg, n_layers=cfg.n_enc_layers, layer_period=(LayerSpec(),), cross_attn_period=0,
        enc_dec=False,
    )


def _embed(cfg: ModelConfig, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = boundary.embedding(p["embed"], tokens).to(cfg.cdtype)
    if cfg.tie_embeddings:
        # gemma-style embedding scale, rounded to the compute dtype first as the
        # reference's weakly typed scalar is
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.cdtype)
    return constrain(x, "batch", "seq", "embed")


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices with exact products, f32 accumulation and an f32
    result.  On the card a bf16 GEMM writes f32 directly; elsewhere the operands are
    widened to f32, which gives the same exact products."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


class _MatmulF32(torch.autograd.Function):
    """The product of :func:`_mm_f32` and its gradient.

    The reference's transpose multiplies the f32 cotangent by the bf16 operands and
    casts ``da`` and ``db`` to the operands' dtype.  Here the cotangent is split into
    two bf16 parts, ``g = hi + lo`` up to 2^-17 relative, and each product is the sum
    of two bf16 products with f32 results: the f32 cotangent's precision with the
    tensor cores doing the work.  (Torch's f32-output ``mm`` has no backward.)"""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        hi = g.to(a.dtype)
        lo = (g - hi.to(g.dtype)).to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            bt = b.t()
            da = (_mm_f32(hi, bt) + _mm_f32(lo, bt)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            at = a.t()
            db = (_mm_f32(at, hi) + _mm_f32(at, lo)).to(b.dtype)
        return da, db


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with exact products, f32 accumulation and an f32 result: the reference's
    ``preferred_element_type=float32``."""
    if a.dtype != torch.float32:
        return _MatmulF32.apply(a, b)
    return a @ b.to(torch.float32)


def _logits(cfg: ModelConfig, p: Params, x: torch.Tensor, *, impl: str | None = None):
    x = L.norm_apply(cfg, p["final_norm"], x, impl=impl)
    w = p["embed"].to(cfg.cdtype).T if cfg.tie_embeddings else p["lm_head"].to(cfg.cdtype)
    return constrain(boundary.matmul_f32(x, w, _rows_matmul_f32), "batch", "seq", "vocab")


def _rows_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) · (D, V) → (B, S, V) f32: :func:`_matmul_f32` on the B·S rows."""
    B, S, D = x.shape
    return _matmul_f32(x.reshape(B * S, D), w).reshape(B, S, -1)


def encode(
    cfg: ModelConfig, p: Params, frames: torch.Tensor, *, impl: str | None = None
) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (B, S_enc, D) (the
    frontend is a stub, as in the reference): non-causal self-attention with RoPE at
    positions 0..S_enc-1, then the encoder's own final norm."""
    enc = encoder_config(cfg)
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(cfg.cdtype)
    x, _ = stack_apply(enc, p["encoder"]["layers"], x, pos, causal=False, impl=impl)
    return L.norm_apply(enc, p["encoder"]["final_norm"], x, impl=impl)


def _cross_states(cfg: ModelConfig, p: Params, batch: dict, impl) -> torch.Tensor | None:
    """What cross-attention attends to: the encoded ``enc_frames`` of an
    encoder-decoder model, a VLM's ``image_embeds`` in the compute dtype, else None."""
    if cfg.enc_dec:
        return encode(cfg, p, batch["enc_frames"], impl=impl)
    if cfg.cross_attn_period:
        return batch["image_embeds"].to(cfg.cdtype)
    return None


def _forward(cfg: ModelConfig, p: Params, tokens: torch.Tensor, cross_states, impl):
    """(logits (B, S, V) f32, MoE aux loss): the reference's ``forward``."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = _embed(cfg, p, tokens)
    x, aux = stack_apply(cfg, p["layers"], x, pos, cross_states=cross_states, impl=impl)
    return _logits(cfg, p, x, impl=impl), aux


def forward(
    cfg: ModelConfig,
    p: Params,
    tokens: torch.Tensor,
    *,
    cross_states: torch.Tensor | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Full-sequence forward.  tokens (B, S) int → logits (B, S, V) f32.

    ``cross_states`` is what cross-attention layers attend to (see ``loss_fn``).  The
    reference also returns the MoE auxiliary loss; ``loss_fn`` reports it."""
    return _forward(cfg, p, tokens, cross_states, impl)[0]


def loss_fn(
    cfg: ModelConfig, p: Params, batch: dict, *, impl: str | None = None
) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy on ``batch`` (``tokens``, ``labels``: (B, S) int;
    ``enc_frames`` (B, S_enc, D) for an encoder-decoder model, ``image_embeds``
    (B, num_image_tokens, D) for a VLM) plus ``_AUX_WEIGHT`` times the MoE
    load-balance loss summed over the layers.  Returns ``(loss, {"nll", "aux"})`` as
    the reference does."""
    cross = _cross_states(cfg, p, batch, impl)
    logits, aux = _forward(cfg, p, batch["tokens"], cross, impl)
    nll = boundary.nll(logits, batch["labels"])
    loss = nll + _AUX_WEIGHT * aux
    return loss, {"nll": nll, "aux": aux}


def cache_init(
    cfg: ModelConfig, batch: int, max_len: int, device: str | torch.device = "cuda"
) -> list[Params]:
    return stack_cache_init(cfg, batch, max_len, resolve_device(device))


def prefill(
    cfg: ModelConfig,
    p: Params,
    tokens: torch.Tensor,
    max_len: int,
    *,
    batch_extras: dict | None = None,
    impl: str | None = None,
    routes: list | None = None,
) -> tuple[torch.Tensor, list[Params]]:
    """tokens (B, S) int → (logits of the last position (B, V) f32, caches).
    ``batch_extras`` holds ``enc_frames`` or ``image_embeds`` (see ``loss_fn``).
    Where ``routes`` is given, each MoE layer appends its expert indices (G, Sg, K)
    to it, in depth order."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    cross = _cross_states(cfg, p, batch_extras or {}, impl)
    x = _embed(cfg, p, tokens)
    x, caches = stack_prefill(cfg, p["layers"], x, pos, max_len, cross_states=cross, impl=impl,
                              routes=routes)
    logits = _logits(cfg, p, x[:, -1:].contiguous(), impl=impl)[:, 0]
    return logits, caches


def decode_step(
    cfg: ModelConfig,
    p: Params,
    token_t: torch.Tensor,
    pos: int,
    caches: list[Params],
    *,
    impl: str | None = None,
) -> tuple[torch.Tensor, list[Params]]:
    """token_t: (B,) int; pos: its absolute position.  Returns ((B, V) f32, caches).

    The caches are updated in place (the reference returns new arrays); the
    returned list holds the same tensors."""
    x_t = _embed(cfg, p, token_t[:, None])
    x_t, caches = stack_decode(cfg, p["layers"], caches, x_t, int(pos), impl=impl)
    logits = _logits(cfg, p, x_t, impl=impl)[:, 0]
    return logits, caches
