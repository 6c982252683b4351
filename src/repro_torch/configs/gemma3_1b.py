"""Gemma-3 1B — dense, 5:1 local:global attention, MQA (kv=1), 262k vocab.

[hf:google/gemma-3-1b-pt] 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; sliding window 512 on local layers; head_dim 256 (published
config — heads × head_dim ≠ d_model in Gemma); tied embeddings."""

from repro_torch.models import LayerSpec, ModelConfig

SUBQUADRATIC = True  # sliding-window-dominant (4 global layers of 26)

_PERIOD = (LayerSpec(attn_kind="local"),) * 5 + (LayerSpec(attn_kind="global"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab=262144,
        layer_period=_PERIOD,
        local_window=512,
        rope_theta=1_000_000.0,
        mlp_act="gelu",
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-reduced",
        family="dense",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=512,
        layer_period=_PERIOD,
        local_window=8,
        mlp_act="gelu",
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )
