"""Whisper-medium — encoder-decoder audio transformer (backbone only).

[arXiv:2212.04356] 24L(enc)+24L(dec) d_model=1024 16H (kv=16) d_ff=4096
vocab=51865.  The conv frontend is a STUB per the brief: ``input_specs``
provides precomputed frame embeddings (B, S, d_model).  Decoder layers
carry self-attention + cross-attention.  RoPE replaces Whisper's absolute
positions (DESIGN.md §7)."""

from repro_torch.models import ModelConfig

SUBQUADRATIC = False  # full attention enc+dec → long_500k skipped


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=51865,
        enc_dec=True,
        cross_attn_period=1,  # cross-attention on every decoder layer
        mlp_act="gelu",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced",
        family="audio",
        n_layers=3,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        enc_dec=True,
        cross_attn_period=1,
        mlp_act="gelu",
        param_dtype="float32",
        compute_dtype="float32",
    )
