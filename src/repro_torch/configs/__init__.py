"""Architecture registry: ``--arch <id>`` → ModelConfig, shape cells and their
input and cache specs.

The port carries every architecture of the reference registry: dense attention,
Mamba-2, the hybrid and MoE stacks, and the encoder-decoder and cross-attention
models.  ``input_specs(cfg, cell)`` and ``cache_specs(cfg, cell)`` give ``meta``
tensors for every model input and decode cache of an (architecture × shape) cell
(the reference's ``ShapeDtypeStruct`` stand-ins): shapes and dtypes, no storage.
They are what the dry run (``repro_torch.launch.dryrun``) builds its steps from."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.models import ModelConfig
from .base import SHAPES, ShapeCell

__all__ = [
    "ARCHS", "DEC_CONTEXT", "ENC_FRAMES", "PENDING", "SHAPES", "ShapeCell", "cache_specs",
    "cells_for", "get_config", "input_specs", "is_subquadratic",
]

ARCHS: dict[str, str] = {
    "jamba-v0.1-52b": "jamba_v01_52b",
    "gemma3-1b": "gemma3_1b",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "starcoder2-15b": "starcoder2_15b",
    "whisper-medium": "whisper_medium",
    "grok-1-314b": "grok_1_314b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "mamba2-370m": "mamba2_370m",
    "llama-3.2-vision-11b": "llama32_vision_11b",
}

#: Reference architectures not ported yet: none.
PENDING: dict[str, str] = {}

#: Whisper encoder output length (30 s at 50 Hz post-conv — the published
#: frontend geometry; the conv stub's output length).
ENC_FRAMES = 1500

#: Whisper's decoder context (``max_target_positions``, 448): prompt and generated
#: tokens of one encoder-decoder request together.
DEC_CONTEXT = 448


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    m = _module(arch)
    return m.reduced() if reduced else m.config()


def is_subquadratic(arch: str) -> bool:
    return bool(_module(arch).SUBQUADRATIC)


def cells_for(arch: str) -> list[ShapeCell]:
    """The runnable shape cells of an arch (``long_500k`` only when sub-quadratic)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if is_subquadratic(arch):
        cells.append(SHAPES["long_500k"])
    return cells


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict[str, Any]:
    """Model inputs of a cell as meta tensors.

    train:   {tokens, labels}   (B, S) int32
    prefill: {tokens}           (B, S) int32
    decode:  {token, pos}       (B,) int32 and a scalar
    plus the modality stubs (``enc_frames``, ``image_embeds``) the arch needs, in
    the compute dtype, as the reference's."""
    B, S = cell.global_batch, cell.seq_len
    out: dict[str, Any] = {}
    if cell.kind == "train":
        out["tokens"] = _meta((B, S), torch.int32)
        out["labels"] = _meta((B, S), torch.int32)
    elif cell.kind == "prefill":
        out["tokens"] = _meta((B, S), torch.int32)
    else:
        out["token"] = _meta((B,), torch.int32)
        out["pos"] = _meta((), torch.int32)
    if cfg.enc_dec and cell.kind != "decode":
        out["enc_frames"] = _meta((B, min(S, ENC_FRAMES), cfg.d_model), cfg.cdtype)
    if cfg.cross_attn_period and not cfg.enc_dec and cell.kind != "decode":
        out["image_embeds"] = _meta((B, cfg.num_image_tokens, cfg.d_model), cfg.cdtype)
    return out


def cache_specs(cfg: ModelConfig, cell: ShapeCell) -> Any:
    """The decode caches of a decode cell as meta tensors: ``cache_init`` run on the
    ``meta`` device.  An encoder-decoder model's cross K/V take the encoder's
    length (``min(seq_len, ENC_FRAMES)``), as the reference's."""
    from repro_torch.models.model import stack_cache_init

    if cfg.enc_dec:
        cfg = dataclasses.replace(cfg, num_image_tokens=min(cell.seq_len, ENC_FRAMES))
    return stack_cache_init(cfg, cell.global_batch, cell.seq_len, torch.device("meta"))
