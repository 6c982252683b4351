"""Model zoo (dense attention models): one config schema, prefill and cached decode."""

from .common import LayerSpec, ModelConfig
from .model import cache_init, decode_step, forward, init_params, prefill

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "cache_init",
]
