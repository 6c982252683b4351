"""Llama-3.2-Vision 11B — dense GQA with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision] 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256; cross-attention injected every 5th layer.  The
vision tower is a STUB per the brief: ``input_specs`` provides projected
patch embeddings (B, num_image_tokens, d_model)."""

from repro_torch.models import ModelConfig

SUBQUADRATIC = False


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=128256,
        cross_attn_period=5,
        num_image_tokens=1600,
        rope_theta=500_000.0,
        fsdp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-reduced",
        family="vlm",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        cross_attn_period=5,
        num_image_tokens=16,
        param_dtype="float32",
        compute_dtype="float32",
    )
