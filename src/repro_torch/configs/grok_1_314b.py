"""Grok-1 314B — MoE transformer, 8 experts top-2 on every layer.

[hf:xai-org/grok-1] 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2."""

from repro_torch.models import LayerSpec, ModelConfig

SUBQUADRATIC = False


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab=131072,
        layer_period=(LayerSpec(moe=True),),
        num_experts=8,
        top_k=2,
        fsdp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="grok-1-reduced",
        family="moe",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        layer_period=(LayerSpec(moe=True),),
        num_experts=4,
        top_k=2,
        capacity_factor=8.0,
        param_dtype="float32",
        compute_dtype="float32",
    )
