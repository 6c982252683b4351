"""Architecture registry: ``--arch <id>`` → ModelConfig.

The port carries every architecture of the reference registry: dense attention,
Mamba-2, the hybrid and MoE stacks, and the encoder-decoder and cross-attention
models."""

from __future__ import annotations

import importlib

from repro_torch.models import ModelConfig

__all__ = ["ARCHS", "DEC_CONTEXT", "ENC_FRAMES", "PENDING", "get_config"]

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


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    m = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return m.reduced() if reduced else m.config()
