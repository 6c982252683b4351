"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 + 1 shared expert.

[arXiv:2501.kimi2 per the brief] 61L d_model=7168 64H (GQA kv=8)
d_ff=2048 (expert width) vocab=163840, MoE 384e top-8.  head_dim pinned to
128 (64×112 ≠ published head size).  Adafactor + bf16 state at this scale
(see repro.optim)."""

from repro_torch.models import LayerSpec, ModelConfig

SUBQUADRATIC = False


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=2048,
        vocab=163840,
        layer_period=(LayerSpec(moe=True),),
        num_experts=384,
        top_k=8,
        moe_d_ff=2048,
        shared_experts=1,
        fsdp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-reduced",
        family="moe",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab=512,
        layer_period=(LayerSpec(moe=True),),
        num_experts=8,
        top_k=4,
        moe_d_ff=32,
        shared_experts=1,
        capacity_factor=8.0,
        param_dtype="float32",
        compute_dtype="float32",
    )
