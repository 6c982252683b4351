"""Model zoo (dense attention and Mamba-2 models): one config schema, the training loss,
prefill and cached decode."""

from .common import LayerSpec, ModelConfig
from .model import cache_init, decode_step, forward, init_params, loss_fn, prefill

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "cache_init",
]
