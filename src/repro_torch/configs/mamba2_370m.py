"""Mamba-2 370M — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060] 48L d_model=1024 (attn-free) d_ff=0 vocab=50280,
ssm_state=128.  Pure mixer layers (no FFN sublayer), tied embeddings."""

from repro_torch.models import LayerSpec, ModelConfig

SUBQUADRATIC = True  # constant-size SSM state → long_500k runs


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        layer_period=(LayerSpec(mixer="mamba", ffn=False),),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-reduced",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=512,
        layer_period=(LayerSpec(mixer="mamba", ffn=False),),
        ssm_state=16,
        ssm_head_dim=16,
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )
