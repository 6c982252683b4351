"""Architecture registry: ``--arch <id>`` → ModelConfig.

The port carries the architectures whose layers it covers: dense attention and
Mamba-2.  The other architectures of the reference registry wait for the layers
they need."""

from __future__ import annotations

import importlib

from repro_torch.models import ModelConfig

__all__ = ["ARCHS", "PENDING", "get_config"]

ARCHS: dict[str, str] = {
    "gemma3-1b": "gemma3_1b",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "starcoder2-15b": "starcoder2_15b",
    "mamba2-370m": "mamba2_370m",
}

#: Reference architectures not ported yet, with the ROADMAP item that ports their layers.
PENDING: dict[str, str] = {
    "jamba-v0.1-52b": "ROADMAP.md §A: MoE layers",
    "whisper-medium": "ROADMAP.md §A: cross-attention and encoder-decoder layers",
    "grok-1-314b": "ROADMAP.md §A: MoE layers",
    "kimi-k2-1t-a32b": "ROADMAP.md §A: MoE layers",
    "llama-3.2-vision-11b": "ROADMAP.md §A: cross-attention and encoder-decoder layers",
}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch in PENDING:
        raise NotImplementedError(f"{arch!r} is not ported yet: {PENDING[arch]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    m = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return m.reduced() if reduced else m.config()
