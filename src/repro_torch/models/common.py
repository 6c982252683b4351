"""Model configuration schema + shared building blocks (RoPE, init).

The port's copy of ``repro.models.common``: the same :class:`LayerSpec` and
:class:`ModelConfig` fields and defaults, with ``pdtype``/``cdtype`` as torch
dtypes.  ``scan_segments`` keeps the reference's grouping of the depth into
(pattern, repeat) segments: the port runs the layers one by one, but the
segments fix the order in which stacked reference parameters unstack
(:mod:`repro_torch.models.convert`).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import torch

Mixer = Literal["attn", "mamba"]
AttnKind = Literal["global", "local"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Structure of one layer: the sequence mixer + the channel mixer."""

    mixer: Mixer = "attn"
    attn_kind: AttnKind = "global"
    moe: bool = False
    ffn: bool = True  # False: mixer-only layer (pure Mamba-2 stacks)
    cross_attn: bool = False  # extra cross-attention sublayer (VLM/enc-dec)

    @property
    def tag(self) -> str:
        return (
            f"{self.mixer}-{self.attn_kind if self.mixer == 'attn' else 'ssm'}"
            f"{'-moe' if self.moe else ''}{'-x' if self.cross_attn else ''}"
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | audio | vlm

    # dimensions
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int | None = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024

    # attention
    rope_theta: float = 10_000.0
    local_window: int = 1024  # for attn_kind == "local"
    attn_logit_softcap: float | None = None
    mlp_act: str = "silu"  # silu (SwiGLU) | gelu

    # layer structure: period repeated through the depth (see layer_specs())
    layer_period: tuple[LayerSpec, ...] | None = None

    # MoE
    num_experts: int = 0
    top_k: int = 2
    moe_d_ff: int | None = None
    shared_experts: int = 0
    capacity_factor: float = 1.25

    # Mamba-2 (SSM mixers)
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0

    # VLM cross-attention injection
    cross_attn_period: int = 0
    num_image_tokens: int = 1024

    # dtypes / numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # distribution hints (kept for parity with the reference's schema)
    fsdp: bool = False
    remat: bool = True
    scan_layers: bool = True

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def layer_specs(self) -> list[LayerSpec]:
        """The full depth-wise layer list, from the period."""
        period = self.layer_period or (LayerSpec(),)
        out = [period[i % len(period)] for i in range(self.n_layers)]
        if self.cross_attn_period:
            out = [
                dataclasses.replace(s, cross_attn=((i + 1) % self.cross_attn_period == 0))
                for i, s in enumerate(out)
            ]
        return out

    def scan_segments(self) -> list[tuple[tuple[LayerSpec, ...], int]]:
        """Group the depth into (pattern, repeat) segments, as the reference does.

        A full period repeated r times is one segment; any remainder layers
        become trailing repeat-1 segments."""
        specs = self.layer_specs()
        period = list(self.layer_period or (LayerSpec(),))
        if self.cross_attn_period:
            cyc = self.cross_attn_period
            period = specs[:cyc]
            if len(specs) >= cyc and all(
                specs[i] == period[i % cyc] for i in range(len(specs) - len(specs) % cyc)
            ):
                reps, rem = divmod(len(specs), cyc)
                segs = [(tuple(period), reps)] if reps else []
                segs += [((s,), 1) for s in specs[reps * cyc:]]
                return segs
            return [((s,), 1) for s in specs]
        k = len(period)
        reps, rem = divmod(self.n_layers, k)
        segs: list[tuple[tuple[LayerSpec, ...], int]] = []
        if reps:
            segs.append((tuple(period), reps))
        segs += [((specs[reps * k + i],), 1) for i in range(rem)]
        return segs


# ---------------------------------------------------------------------------
# Initializers / numerics helpers
# ---------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator,
    shape: Sequence[int],
    dtype: torch.dtype,
    fan_in: int | None = None,
) -> torch.Tensor:
    """Truncated normal on [-2, 2] with 1/sqrt(fan_in) scale (standard LM init).

    Drawn in f32 on the generator's device, then cast.  The numbers differ from
    ``jax.random``'s for the same seed; tests carry weights across instead."""
    fi = fan_in if fan_in is not None else shape[0]
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if t.is_meta:  # a shape only (``model.abstract_params``)
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)
    return (t * fi**-0.5).to(dtype)


def rope_freqs(hd: int, theta: float, device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, D) with D even; positions: (B, S) or (S,).

    Split halves (not interleaved pairs), computed in f32 and cast back to
    ``x.dtype``; the result is contiguous."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].to(torch.float32) * freqs  # (B,1,S,D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
